"""Communication topologies and mixing matrices for decentralized gossip
(static part of ``repro.core.topology``; numpy, identical ``W`` and shifts).

The paper (Assumption 3.1) requires a symmetric, doubly-stochastic mixing
matrix W with spectral gap rho = 1 - |lambda_2(W)| in (0, 1].  Circulant
graphs (ring, torus, mesh) also carry their *shift structure*: the mixing
``sum_j w_ij x_j`` is ``sum_k weight_k * roll(x, shift_k)`` along the node
axis.

Time variation (from ``repro.core.topology``): a :class:`TopologySchedule`
is a round-indexed sequence W(t) of period P, host-side numpy for the
analysis (spectral gaps, gamma, bits) and torch f32 for the round's mixing
matrix (:meth:`TopologySchedule.mixing_at`); :class:`BernoulliDropout`
adds per-round node dropout, its mask drawn from a ``torch.Generator``;
:func:`masked_metropolis` reweights a phase on the surviving subgraph.
:class:`PermutePlan` (:func:`compile_permute_plan`,
:func:`compile_schedule_plans`) compiles a phase into its exchange ops, the
wire program ``core/wire.py`` unites across phases.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch

__all__ = [
    "Topology",
    "ring",
    "torus_2d",
    "mesh",
    "star",
    "erdos_renyi",
    "metropolis_weights",
    "spectral_gap",
    "make_topology",
    "masked_metropolis",
    "TopologySchedule",
    "StaticSchedule",
    "RoundRobinSchedule",
    "MatchingSchedule",
    "BernoulliDropout",
    "make_topology_schedule",
    "EdgeStep",
    "PermutePlan",
    "compile_permute_plan",
    "compile_schedule_plans",
]


@dataclasses.dataclass(frozen=True)
class Topology:
    """A gossip communication topology.

    Attributes:
      name: human-readable identifier.
      adjacency: [m, m] 0/1 numpy array (with self-loops on the diagonal).
      mixing: [m, m] symmetric doubly-stochastic numpy array.
      shifts: optional circulant decomposition -- (shift, weight) pairs with
        ``sum_j w_ij x_j == sum_k weight_k * roll(x, shift_k)`` along the
        node axis; ``None`` when the graph is not circulant.
    """

    name: str
    adjacency: np.ndarray
    mixing: np.ndarray
    shifts: tuple[tuple[int, float], ...] | None = None

    @property
    def num_nodes(self) -> int:
        return self.mixing.shape[0]

    @property
    def spectral_gap(self) -> float:
        return spectral_gap(self.mixing)

    @property
    def beta(self) -> float:
        """beta = ||I - W||_2 as in Assumption 3.1."""
        m = self.mixing.shape[0]
        return float(np.linalg.norm(np.eye(m) - self.mixing, ord=2))

    @property
    def max_degree(self) -> int:
        """Max number of neighbors (excluding self) -- the 'busiest node'."""
        return int((self.adjacency - np.eye(self.num_nodes)).sum(axis=1).max())

    @property
    def expected_degree(self) -> float:
        """A static graph with full participation realizes its max degree."""
        return float(self.max_degree)

    def realized_degree(self, t: int, mask) -> float:
        """Busiest node's active links under a participation mask: a dropped
        node sends nothing, and links to dropped neighbours carry nothing."""
        alive = np.asarray(mask, np.float64).reshape(-1)
        off = self.adjacency - np.eye(self.num_nodes)
        return float((alive * (off * alive[None, :]).sum(axis=1)).max())

    def realized_degree_traced(self, t, mask) -> float:
        """:meth:`realized_degree` in f32, as the reference's in-graph meter
        (``mask=None``: the max degree)."""
        if mask is None:
            return float(self.max_degree)
        off = torch.as_tensor(self.adjacency - np.eye(self.num_nodes), dtype=torch.float32)
        alive = _as_alive(mask)
        return float((alive * (off @ alive)).max())

    def consensus_step_size(self, delta: float) -> float:
        """Theorem 4.1/4.3 consensus step size gamma for compression factor delta."""
        return _theorem_gamma(self.spectral_gap, self.beta, delta)


def spectral_gap(w: np.ndarray) -> float:
    """rho = 1 - |lambda_2|: gap between the two largest eigenvalue moduli."""
    eig = np.sort(np.abs(np.linalg.eigvalsh(w)))[::-1]
    return float(1.0 - eig[1]) if eig.shape[0] > 1 else 1.0


def _theorem_gamma(rho: float, beta: float, delta: float) -> float:
    """Theorem 4.1/4.3 gamma from spectral gap rho and beta = ||I - W||."""
    return rho**2 * delta / (
        16 * rho + rho**2 + 4 * beta**2 + 2 * rho * beta**2 - 8 * rho * delta
    )


def _circulant_mixing(m: int, shifts: Sequence[tuple[int, float]]) -> np.ndarray:
    w = np.zeros((m, m))
    for shift, weight in shifts:
        w += weight * np.roll(np.eye(m), shift, axis=1)
    return w


def ring(m: int, self_weight: float | None = None) -> Topology:
    """Ring: each node talks to its two neighbors (paper §5.1)."""
    if m < 2:
        return mesh(1)
    if m == 2:
        return mesh(2)
    w_self = 1.0 / 3.0 if self_weight is None else self_weight
    w_side = (1.0 - w_self) / 2.0
    shifts = ((0, w_self), (1, w_side), (-1, w_side))
    w = _circulant_mixing(m, shifts)
    adj = (w > 0).astype(np.float64)
    return Topology("ring", adj, w, shifts)


def torus_2d(m: int) -> Topology:
    """2D torus: each node has 4 neighbors (Metropolis weights); non-square m
    falls back to a circulant 4-regular graph (offsets ±1, ±floor(sqrt(m)))."""
    side = int(round(math.sqrt(m)))
    stride = side if side * side == m else max(2, side)
    if m <= 4:
        return mesh(m)
    w_each = 1.0 / 5.0
    shifts = ((0, w_each), (1, w_each), (-1, w_each), (stride, w_each), (-stride, w_each))
    w = _circulant_mixing(m, shifts)
    adj = (w > 0).astype(np.float64)
    return Topology("torus", adj, w, shifts)


def mesh(m: int) -> Topology:
    """Fully-connected: W = (1/m) 11^T -- one-shot consensus."""
    w = np.full((m, m), 1.0 / m)
    adj = np.ones((m, m))
    shifts = tuple((k, 1.0 / m) for k in range(m))
    return Topology("mesh", adj, w, shifts)


def star(m: int) -> Topology:
    """Star topology with Metropolis weights (not circulant)."""
    adj = np.eye(m)
    adj[0, :] = 1.0
    adj[:, 0] = 1.0
    w = metropolis_weights(adj)
    return Topology("star", adj, w, None)


def erdos_renyi(m: int, p: float, seed: int = 0) -> Topology:
    """Connected Erdos-Renyi graph with Metropolis weights (resampled until
    connected)."""
    rng = np.random.default_rng(seed)
    for _ in range(1000):
        upper = rng.random((m, m)) < p
        adj = np.triu(upper, 1)
        adj = adj + adj.T + np.eye(m, dtype=bool)
        if _connected(adj):
            w = metropolis_weights(adj.astype(np.float64))
            return Topology("erdos_renyi", adj.astype(np.float64), w, None)
    raise ValueError(f"could not sample a connected G({m}, {p})")


def _connected(adj: np.ndarray) -> bool:
    m = adj.shape[0]
    reach = np.eye(m, dtype=bool)
    frontier = reach
    for _ in range(m):
        frontier = (frontier @ adj) > 0
        new = frontier & ~reach
        if not new.any():
            break
        reach |= new
    return bool(reach[0].all())


def metropolis_weights(adj: np.ndarray) -> np.ndarray:
    """w_ij = 1 / (1 + max(deg_i, deg_j)) for edges, diagonal absorbs the rest."""
    m = adj.shape[0]
    deg = (adj - np.eye(m)).sum(axis=1)
    w = np.zeros((m, m))
    for i in range(m):
        for j in range(m):
            if i != j and adj[i, j] > 0:
                w[i, j] = 1.0 / (1.0 + max(deg[i], deg[j]))
    np.fill_diagonal(w, 1.0 - w.sum(axis=1))
    return w


def _erdos_renyi_factory(m: int, p: float = 0.3, seed: int = 0) -> Topology:
    return erdos_renyi(m, p=p, seed=seed)


_FACTORIES = {
    "ring": ring,
    "torus": torus_2d,
    "mesh": mesh,
    "star": star,
    "erdos_renyi": _erdos_renyi_factory,
}


def make_topology(name: str, m: int, **kwargs) -> Topology:
    if name not in _FACTORIES:
        raise ValueError(f"unknown topology {name!r}; choose from {sorted(_FACTORIES)}")
    return _FACTORIES[name](m, **kwargs)


# =========================================================== time variation
def _as_alive(mask) -> torch.Tensor:
    return torch.as_tensor(np.asarray(mask.cpu() if isinstance(mask, torch.Tensor) else mask),
                           dtype=torch.float32)


def masked_metropolis(adjacency, alive) -> torch.Tensor:
    """Metropolis weights on the subgraph induced by ``alive`` (f32, CPU).

    ``adjacency`` is [m, m] with self-loops, ``alive`` a 0/1 [m] mask.
    Edges touching a dead node go, degrees are recounted on the survivors,
    so the result is symmetric doubly stochastic for every mask; dead nodes
    get the identity row and column (they hold their state)."""
    adjacency = torch.as_tensor(np.asarray(adjacency), dtype=torch.float32)
    alive = _as_alive(alive)
    m = adjacency.shape[0]
    eye = torch.eye(m, dtype=torch.float32)
    off = adjacency * (1.0 - eye) * alive[:, None] * alive[None, :]
    deg = off.sum(dim=1)
    w = off / (1.0 + torch.maximum(deg[:, None], deg[None, :]))
    return w + torch.diag(1.0 - w.sum(dim=1))


class TopologySchedule:
    """A round-indexed sequence of topologies W(t) with period P.

    The host-side analysis uses the numpy phase topologies; a round asks
    :meth:`mixing_at` for its dense [m, m] f32 matrix (and, under dropout,
    :meth:`mask_at` for its participation mask).  ``dropout_rate == 0``
    here; :class:`BernoulliDropout` adds it.  A schedule of period 1
    without dropout is *static*: consumers unwrap it to the plain
    :class:`Topology` paths (circulant shifts, packed / fused gossip).
    """

    dropout_rate: float = 0.0

    def __init__(self, topologies: Sequence[Topology], name: str | None = None):
        topologies = tuple(topologies)
        if not topologies:
            raise ValueError("schedule needs at least one topology")
        m = topologies[0].num_nodes
        if any(t.num_nodes != m for t in topologies):
            raise ValueError("all phases of a schedule must have the same num_nodes")
        self.topologies = topologies
        self.name = name or "+".join(t.name for t in topologies)
        self.mixing_bank = np.stack([t.mixing for t in topologies])
        self.adjacency_bank = np.stack([t.adjacency for t in topologies])

    # ------------------------------------------------------------- host side
    @property
    def period(self) -> int:
        return len(self.topologies)

    @property
    def num_nodes(self) -> int:
        return self.topologies[0].num_nodes

    @property
    def is_static(self) -> bool:
        return self.period == 1 and self.dropout_rate == 0.0

    def topology_at(self, t: int) -> Topology:
        return self.topologies[int(t) % self.period]

    @property
    def spectral_gap(self) -> float:
        """Worst phase -- conservative for step-size theory."""
        return min(t.spectral_gap for t in self.topologies)

    @property
    def beta(self) -> float:
        return max(t.beta for t in self.topologies)

    @property
    def max_degree(self) -> int:
        """Busiest node over all phases (the bits upper bound)."""
        return max(t.max_degree for t in self.topologies)

    @property
    def expected_degree(self) -> float:
        """The busiest node's phase-averaged degree times the probability
        that both ends of a link survive the round, (1 - rate)^2."""
        m = self.num_nodes
        deg = np.stack([(t.adjacency - np.eye(m)).sum(axis=1) for t in self.topologies])
        keep = (1.0 - self.dropout_rate) ** 2
        return float(deg.mean(axis=0).max() * keep)

    def realized_degree(self, t: int, mask) -> float:
        return self.topology_at(t).realized_degree(t, mask)

    def realized_degree_traced(self, t, mask) -> float:
        """Round ``t``'s surviving links of the busiest node, in f32."""
        m = self.num_nodes
        off = self.adjacency_at(t) * (1.0 - torch.eye(m, dtype=torch.float32))
        if mask is None:
            return float(off.sum(dim=1).max())
        alive = _as_alive(mask)
        return float((alive * (off @ alive)).max())

    def consensus_step_size(self, delta: float) -> float:
        """Theorem 4.1 gamma for the worst connected phase; schedules whose
        phases are disconnected (one-peer matchings) use the period-mean
        W-bar, and one whose union never connects raises."""
        worst = min(self.topologies, key=lambda t: t.spectral_gap)
        if worst.spectral_gap > 1e-9:
            return worst.consensus_step_size(delta)
        wbar = self.mixing_bank.mean(axis=0)
        rho = spectral_gap(wbar)
        if rho <= 1e-9:
            raise ValueError(
                f"schedule {self.name!r} never connects (union graph gap 0); "
                "gamma='theory' is undefined -- pass a numeric gamma instead")
        beta = float(np.linalg.norm(np.eye(self.num_nodes) - wbar, ord=2))
        return _theorem_gamma(rho, beta, delta)

    # ------------------------------------------------------------ round side
    def _phase(self, t) -> int:
        return 0 if self.period == 1 else int(t) % self.period

    def mask_at(self, generator: torch.Generator | None, t):
        """Participation mask for round ``t`` (None: everyone alive)."""
        return None

    def adjacency_at(self, t) -> torch.Tensor:
        return torch.as_tensor(self.adjacency_bank[self._phase(t)], dtype=torch.float32)

    def mixing_at(self, t, mask=None) -> torch.Tensor:
        """Dense [m, m] f32 mixing matrix of round ``t`` (CPU).  With a mask
        the phase's adjacency is reweighted on the surviving subgraph;
        without one the phase's own matrix is used."""
        if mask is not None:
            return masked_metropolis(self.adjacency_at(t), mask)
        return torch.as_tensor(self.mixing_bank[self._phase(t)], dtype=torch.float32)


class StaticSchedule(TopologySchedule):
    """The same topology every round."""

    def __init__(self, topology: Topology):
        super().__init__((topology,), name=topology.name)


class RoundRobinSchedule(TopologySchedule):
    """Cycle over a family of graphs (ring -> torus -> ...)."""

    def __init__(self, topologies: Sequence[Topology]):
        super().__init__(topologies)


class MatchingSchedule(TopologySchedule):
    """Random one-peer matchings: ``period`` perfect matchings drawn from
    ``numpy.random.default_rng(seed)`` (the reference's draws), W = I/2 +
    M/2 per phase, the odd node out keeping w_ii = 1."""

    def __init__(self, m: int, period: int = 8, seed: int = 0):
        rng = np.random.default_rng(seed)
        phases = []
        for _ in range(max(1, period)):
            perm = rng.permutation(m)
            w = np.eye(m)
            for a in range(0, m - 1, 2):
                i, j = int(perm[a]), int(perm[a + 1])
                w[i, i] = w[j, j] = 0.5
                w[i, j] = w[j, i] = 0.5
            adj = (w > 0).astype(np.float64)
            phases.append(Topology("matching", adj, w, None))
        super().__init__(phases, name="matching")


class BernoulliDropout(TopologySchedule):
    """I.i.d. per-node dropout on top of any schedule: each round a node
    survives with probability ``1 - rate`` (``torch.rand(m) < 1 - rate`` on
    the caller's generator), and W(t) is the Metropolis reweighting of the
    phase on the survivors -- also when everyone survives."""

    def __init__(self, base: TopologySchedule | Topology, rate: float):
        if isinstance(base, Topology):
            base = StaticSchedule(base)
        if not 0.0 <= rate < 1.0:
            raise ValueError(f"dropout rate must be in [0, 1); got {rate}")
        super().__init__(base.topologies, name=f"{base.name}+drop{rate:g}")
        self.base = base
        self.dropout_rate = float(rate)

    def mask_at(self, generator, t):
        if self.dropout_rate == 0.0:
            return None
        u = torch.rand(self.num_nodes, generator=generator, dtype=torch.float32)
        return (u < 1.0 - self.dropout_rate).to(torch.float32)


def make_topology_schedule(spec: str, m: int, *, dropout: float = 0.0, period: int = 8,
                           seed: int = 0, **topo_kwargs) -> TopologySchedule:
    """Parse a schedule spec: a ``make_topology`` name (static),
    ``"roundrobin:ring,torus"`` or ``"matching[:P]"``; ``dropout > 0`` wraps
    the result in :class:`BernoulliDropout`.  ``topo_kwargs`` go to the
    static factory only; ``seed`` seeds matchings (and erdos_renyi)."""
    spec = spec.strip()
    if spec.startswith("roundrobin:"):
        names = [s for s in spec[len("roundrobin:"):].split(",") if s]
        if not names:
            raise ValueError(f"empty roundrobin schedule spec {spec!r}")
        sched: TopologySchedule = RoundRobinSchedule([make_topology(n.strip(), m) for n in names])
    elif spec == "matching" or spec.startswith("matching:"):
        p = int(spec.split(":", 1)[1]) if ":" in spec else period
        sched = MatchingSchedule(m, period=p, seed=seed)
    else:
        kw = dict(topo_kwargs)
        if spec == "erdos_renyi":
            kw.setdefault("seed", seed)
        sched = StaticSchedule(make_topology(spec, m, **kw))
    if dropout > 0.0:
        sched = BernoulliDropout(sched, dropout)
    return sched


# ======================================================== permute schedules
# Compilation of a mixing matrix into an explicit *neighbor-exchange*
# schedule: the wire program core/exchange.py executes -- one roll or
# gather of the node axis per op in one process, or point-to-point sends
# between torch.distributed ranks -- instead of a dense mix.
#
# Two forms, matching the two graph families:
#
# * circulant graphs (ring / torus / mesh) keep their shift decomposition —
#   every shift is one global roll of the node axis;
# * irregular graphs (erdos_renyi, star, matching phases) are decomposed
#   into :class:`EdgeStep` barriers — partial permutations with distinct
#   senders and receivers.  The greedy scheduler below always sends each
#   receiver's *smallest pending sender*, so every node receives its
#   neighbors in ascending id order (deterministic, and the closest
#   permute-order analogue of the dense oracle's row-major accumulation).


@dataclasses.dataclass(frozen=True)
class EdgeStep:
    """One barrier of pairwise sends: a partial permutation of the nodes.

    ``perm`` is a tuple of (src, dst) node pairs with distinct sources and
    distinct destinations (a partial permutation); ``weights``
    is the length-m receive weight vector — ``weights[dst] = W[dst, src]``
    for every pair, 0.0 for nodes that receive nothing this step.
    """

    perm: tuple[tuple[int, int], ...]
    weights: tuple[float, ...]


@dataclasses.dataclass(frozen=True)
class PermutePlan:
    """Neighbor-exchange schedule realizing one mixing matrix W.

    Exactly one of the two wire forms is populated:

    * ``shifts`` — the circulant decomposition, verbatim from
      :attr:`Topology.shifts` (order preserved);
    * ``steps`` — per-edge :class:`EdgeStep` barriers for irregular graphs.

    ``self_weight`` is the diagonal of W (every node's own weight).
    ``mixing_matrix()`` reconstructs the dense W exactly (element-level
    copies, no arithmetic beyond the circulant accumulation the factories
    themselves used) — the round-trip the tests hold against the reference.
    """

    name: str
    num_nodes: int
    shifts: tuple[tuple[int, float], ...] | None
    steps: tuple[EdgeStep, ...]
    self_weight: tuple[float, ...]

    @property
    def is_circulant(self) -> bool:
        return self.shifts is not None

    @property
    def num_exchanges(self) -> int:
        """Neighbor exchanges per round (the wire's barrier count)."""
        return len(self.exchange_ops())

    def exchange_ops(self) -> tuple[tuple[str, object], ...]:
        """The executable op list, aligned index-for-index with
        :meth:`sender_maps`: ``("shift", s)`` for a circulant roll by ``s``
        (normalized mod m, deduplicated), ``("perm", pairs)`` for an
        irregular edge step's (src, dst) partial permutation."""
        m = self.num_nodes
        ops: list[tuple[str, object]] = []
        if self.shifts is not None:
            seen = set()
            for shift, _ in self.shifts:
                s = shift % m
                if s == 0 or s in seen:
                    continue
                seen.add(s)
                ops.append(("shift", s))
        else:
            for step in self.steps:
                ops.append(("perm", step.perm))
        return tuple(ops)

    def sender_maps(self) -> tuple[np.ndarray, ...]:
        """One int array [m] per exchange, derived from (and therefore always
        aligned index-for-index with) :meth:`exchange_ops`: ``snd[i]`` = the
        node whose value node i receives (−1 when i receives nothing).  Each
        adjacency edge appears exactly once — this is the op list the
        masked-Metropolis weight computation runs over.
        """
        m = self.num_nodes
        maps = []
        for kind, arg in self.exchange_ops():
            if kind == "shift":
                maps.append((np.arange(m) - arg) % m)
            else:
                snd = np.full((m,), -1, np.int64)
                for src, dst in arg:
                    snd[dst] = src
                maps.append(snd)
        return tuple(maps)

    def mixing_matrix(self) -> np.ndarray:
        """Dense W reconstructed from the schedule — exact round-trip."""
        m = self.num_nodes
        if self.shifts is not None:
            return _circulant_mixing(m, self.shifts)
        w = np.zeros((m, m))
        for step in self.steps:
            for src, dst in step.perm:
                w[dst, src] = step.weights[dst]
        w[np.diag_indices(m)] = np.asarray(self.self_weight)
        return w

    def masked_mixing_matrix(self, mask) -> np.ndarray:
        """Masked-Metropolis W on the surviving subgraph, computed the way
        the union round computes it: participation bits travel the
        plan's own exchanges, degrees are per-op sums of alive bits, and the
        self weight is 1 − the op-ordered sum of edge weights.  Mirrors
        :func:`masked_metropolis` (same formula on the same edge set) up to
        f32 summation order — the host-side oracle for the dropout-rescale
        round-trip test.
        """
        m = self.num_nodes
        alive = np.asarray(mask, np.float32).reshape(m)
        senders = self.sender_maps()
        deg = np.zeros((m,), np.float32)
        for snd in senders:
            has = snd >= 0
            deg[has] += alive[has] * alive[snd[has]]
        w = np.zeros((m, m), np.float32)
        off = np.zeros((m,), np.float32)
        for snd in senders:
            has = snd >= 0
            i = np.nonzero(has)[0]
            j = snd[i]
            wij = alive[i] * alive[j] / (1.0 + np.maximum(deg[i], deg[j]))
            w[i, j] = wij
            off[i] += wij
        w[np.diag_indices(m)] = 1.0 - off
        return w


def compile_permute_plan(topology: Topology) -> PermutePlan:
    """Compile a :class:`Topology` into a :class:`PermutePlan`.

    Circulant graphs keep their shift decomposition verbatim.  Irregular
    graphs get a greedy edge decomposition: repeatedly form a partial
    permutation by giving every receiver its smallest not-yet-received
    sender (skipping receivers whose turn would reuse a sender already
    claimed this step).  The step count is within one of the max degree for
    every graph in the repo, and every node receives in ascending sender
    order.
    """
    m = topology.num_nodes
    self_weight = tuple(float(x) for x in np.diag(topology.mixing))
    if topology.shifts is not None:
        return PermutePlan(topology.name, m, tuple(topology.shifts), (), self_weight)
    adj = np.asarray(topology.adjacency) - np.eye(m)
    mixing = np.asarray(topology.mixing)
    pending = {i: [int(j) for j in np.nonzero(adj[i] > 0)[0]] for i in range(m)}
    steps: list[EdgeStep] = []
    while any(pending.values()):
        used_src: set[int] = set()
        perm: list[tuple[int, int]] = []
        weights = [0.0] * m
        for i in range(m):
            if pending[i] and pending[i][0] not in used_src:
                j = pending[i].pop(0)
                used_src.add(j)
                perm.append((j, i))
                weights[i] = float(mixing[i, j])
        steps.append(EdgeStep(tuple(perm), tuple(weights)))
    return PermutePlan(topology.name, m, None, tuple(steps), self_weight)


def compile_schedule_plans(schedule: TopologySchedule) -> tuple[PermutePlan, ...]:
    """One :class:`PermutePlan` per phase of a :class:`TopologySchedule` —
    the per-phase wire programs that ``wire.compile_union_wire`` unites."""
    return tuple(compile_permute_plan(t) for t in schedule.topologies)
