"""Composable decentralized-DRO trainer (paper Algorithms 1-2 as one loop),
PyTorch port of ``repro.core.trainer``.

A round is local update, dual update, communication:

* :class:`LocalUpdate` -- the stochastic oracle and the optimizer step
  (one gradient per node, ``microbatches`` accumulated, or ``local_steps``
  optimizer steps between communication rounds), with the dual's per-node
  gradient weights;
* a dual -- :class:`ProjectedAscent` (AD-GDA), :class:`FrozenPrior`
  (CHOCO-SGD), :class:`KLClosedForm` (DR-DSGD) or :class:`SampledAscent`
  (DRFA);
* a consensus -- :class:`ChocoConsensus` (CHOCO compressed gossip over a
  topology or a :class:`~repro_torch.core.topology.TopologySchedule`),
  :class:`GradientTrackingConsensus` (a second, tracker lane),
  :class:`ExactConsensus` (uncompressed gossip) or :class:`FedAvg`
  (federated server averaging: the state keeps one server model).

All decentralized state is *stacked* (every leaf [m, ...]) in the
reference's parameter tree, so the gossip's chunk plan, per-chunk norms,
gamma and bit counts are the reference's.  The oracle runs node by node
(``torch.autograd`` on views of each node's parameters), holds every node's
gradient (the dual weights may read all losses), then the optimizer updates
the parameters in place leaf by leaf; the consensus updates theta, theta_hat
and s in place chunk by chunk.  So :meth:`DecentralizedTrainer.step`
consumes its input state, as the reference's donating jitted step does.

Time-varying wires: with a schedule the trainer draws the round's
participation mask, builds its W(t), and threads both into the dual and the
consensus.  A node that sits a round out keeps its theta and its optimizer
moments (only the dropped rows are saved before the local update and put
back after it), skips its dual ascent, and freezes its CHOCO trackers.

Wire faults: with a fault spec (``faults=`` on the consensus) every round
runs the cached union-wire round of ``core/exchange.py`` -- mirrors of each
in-neighbour's ``theta_hat``, per-edge drop / corrupt / dup / delay events,
digests, staleness-bounded mixing and dense resyncs -- and the lambda
gossip rides the same faulted messages (the same events as the model
lane).  ``bits_realized`` then reads the exchange's delivered-bits meter.

Randomness: the state holds one ``torch.Generator`` per stream -- the
gossip's quantization noise (every lane, on the trainer's device), the
dual's client sampling, the participation masks and the wire's fault
events (the last three on the CPU) -- each drawn in a fixed order and saved
in checkpoints.  The reference splits one JAX key per round instead, so the
tests inject its draws: ``step(..., noise=, mask=, sampled=, fault_u=)``.

The ``ppermute`` backend (``backend="ppermute"`` with a ``mesh`` on the
consensus and ``DecentralizedTrainer(mesh=)``) puts each rank's block of
nodes in its own process: the trainer keeps the rank's ``[block, ...]`` rows
of theta, the optimizer moments, the consensus state and lambda, draws every
``[m]``-sized random value whole on every rank (the mask, the dual's
sample, the fault events, the gossip noise), and all-gathers the losses;
the network mean and lambda's mean take an all-reduce, the consensus error
an all-gather of each column block.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.core import dro, wire
from repro_torch.core.compression import Compressor, Identity
from repro_torch.core.faults import FaultEvents, WireBits, parse_fault_spec, sample_events
from repro_torch.core.gossip import (
    BLOCK_SCAN_ELEMS,
    CHOCOState,
    LaneRound,
    _scan_plan,
    check_fused,
    choco_init,
    choco_round,
    choco_round_lanes,
    mix_stacked,
    mix_stacked_with,
    payload_bits,
    payload_total_bits,
)
from repro_torch.core.topology import Topology, TopologySchedule
from repro_torch.core.wire import UnionWirePlan
from repro_torch.device import resolve_device
from repro_torch.kernels.ref import f32_full
from repro_torch.optim import Optimizer, OptState, Schedule
from repro_torch.tree import leaves as tree_leaves
from repro_torch.tree import tree_map, unflatten

__all__ = [
    "LossFn",
    "TrainerState",
    "LocalUpdate",
    "DualUpdate",
    "ProjectedAscent",
    "FrozenPrior",
    "KLClosedForm",
    "SampledAscent",
    "Consensus",
    "ChocoConsensus",
    "GTState",
    "GradientTrackingConsensus",
    "ExactConsensus",
    "FedAvg",
    "DecentralizedTrainer",
]

LossFn = Callable[[Any, Any, Any], torch.Tensor]


@dataclasses.dataclass
class TrainerState:
    step: int  # round counter
    theta: Any  # stacked tree [m, ...] (federated: the server tree, no node axis)
    lam: torch.Tensor  # dual variable: [m, m] per-node copies, or [m]
    opt: OptState  # optimizer moments + its own step counter
    consensus: Any  # CHOCOState, GTState or ()
    theta_avg: Any  # running mean over time of the network mean (theta_o), or ()
    generator: torch.Generator  # the gossip's quantization noise (every lane)
    dual_generator: torch.Generator  # the dual's sampling (DRFA's clients), CPU
    mask_generator: torch.Generator  # participation masks (dropout), CPU
    fault_generator: torch.Generator  # the wire's fault events, CPU


def _batch_slice(batch, k: int, n: int, layout: str):
    """Part ``k`` of ``n`` of every [m, ...] batch leaf: ``"flat"`` cuts the
    per-node batch axis into n contiguous parts, ``"stacked"`` indexes a
    dedicated axis 1."""
    if layout == "stacked":
        return tree_map(lambda x: x[:, k], batch)

    def part(x):
        if x.shape[1] % n:
            raise ValueError(f"per-node batch {x.shape[1]} not divisible by {n}")
        b = x.shape[1] // n
        return x[:, k * b:(k + 1) * b]

    return tree_map(part, batch)


# ============================================================== local update
@dataclasses.dataclass(frozen=True)
class LocalUpdate:
    """Stochastic oracle + optimizer step on the stacked model, in one of
    three shapes sharing the dual weighting and the optimizer:

    * one gradient and one optimizer update per round;
    * ``microbatches = k > 1``: gradients accumulated over k microbatches in
      ``grad_accum_dtype``, then one update;
    * ``local_steps = K > 1``: K updates between communication rounds; the
      schedule (and Adam's bias correction) sees the round's step count at
      every inner step, and the count advances once per round.

    ``batch_layout``: ``"flat"`` packs the K (or k) parts along the per-node
    batch axis, ``"stacked"`` gives them axis 1 (DRFA).
    """

    optimizer: Optimizer
    schedule: Schedule
    microbatches: int = 1
    local_steps: int = 1
    grad_accum_dtype: str = "float32"
    batch_layout: str = "flat"

    def __post_init__(self):
        if self.local_steps > 1 and self.microbatches > 1:
            raise ValueError("local_steps and microbatches do not compose")
        if self.batch_layout not in ("flat", "stacked"):
            raise ValueError(f"unknown batch_layout {self.batch_layout!r}")

    def init(self, theta_stacked) -> OptState:
        return self.optimizer.init(tree_leaves(theta_stacked))

    def lr(self, opt_state: OptState) -> float:
        return self.schedule(opt_state.step)

    @staticmethod
    def _oracle(loss_fn: LossFn, theta, batch):
        """Every node's loss and gradient: (losses [m] f32, grads[leaf][node])."""
        flat = tree_leaves(theta)
        m = flat[0].shape[0]
        grads = [[None] * m for _ in flat]
        losses = []
        for i in range(m):
            params_i = [leaf[i].detach().requires_grad_(True) for leaf in flat]
            batch_i = tree_map(lambda b: b[i], batch)
            with tracing.span("oracle.forward"):
                loss = loss_fn(unflatten(theta, params_i), batch_i, None)
            with tracing.span("oracle.backward"):
                for j, g in enumerate(torch.autograd.grad(loss, params_i)):
                    grads[j][i] = g
            losses.append(loss.detach().float())
        return torch.stack(losses), grads

    def _microbatched(self, loss_fn, theta, batch):
        k = self.microbatches
        acc_dt = getattr(torch, self.grad_accum_dtype)
        acc_l, acc_g = None, None
        for j in range(k):
            losses, grads = self._oracle(loss_fn, theta, _batch_slice(batch, j, k, "flat"))
            part = [[g.to(acc_dt) / k for g in row] for row in grads]
            if acc_g is None:
                acc_l = torch.zeros_like(losses) + losses / k
                acc_g = [[torch.zeros_like(g) + g for g in row] for row in part]
            else:
                acc_l = acc_l + losses / k
                acc_g = [[a + g for a, g in zip(ra, rg)] for ra, rg in zip(acc_g, part)]
        return acc_l, acc_g

    def step(self, loss_fn: LossFn, theta, opt_state: OptState, batch,
             weights_fn: Callable[[torch.Tensor], torch.Tensor]):
        """Run the oracle, then the optimizer on ``theta`` in place.

        Returns (opt_state, losses [m] f32; with local steps the mean over
        the K steps).  ``weights_fn(losses) -> [m]`` supplies the dual
        gradient weighting, after every loss evaluation.
        """
        flat = tree_leaves(theta)
        if self.local_steps > 1:
            return self._local_steps(loss_fn, theta, flat, opt_state, batch, weights_fn)
        with tracing.span("forward_backward"):
            if self.microbatches > 1:
                losses, grads = self._microbatched(loss_fn, theta, batch)
            else:
                losses, grads = self._oracle(loss_fn, theta, batch)
        with tracing.span("optimizer"):
            opt_state = self.optimizer.apply_(flat, grads, opt_state, weights_fn(losses))
        return opt_state, losses

    def _local_steps(self, loss_fn, theta, flat, opt_state, batch, weights_fn):
        K, round_step = self.local_steps, opt_state.step
        losses_k = []
        for k in range(K):
            with tracing.span("forward_backward"):
                losses, grads = self._oracle(
                    loss_fn, theta, _batch_slice(batch, k, K, self.batch_layout))
            with tracing.span("optimizer"):
                inner = OptState(round_step, opt_state.mu, opt_state.nu)
                opt_state = self.optimizer.apply_(flat, grads, inner, weights_fn(losses))
            del grads
            losses_k.append(losses)
        return (OptState(round_step + 1, opt_state.mu, opt_state.nu),
                torch.stack(losses_k).mean(0))


# ================================================================ dual update
class DualUpdate:
    """How the mixture weights lambda evolve across rounds.  ``begin`` draws
    the round's randomness (DRFA's client sampling) and shares it with the
    consensus as ``ctx``."""

    def init(self, m: int, device) -> torch.Tensor:
        raise NotImplementedError

    def begin(self, lam: torch.Tensor, generator: torch.Generator | None, inject=None):
        return None

    def grad_weights(self, lam: torch.Tensor, losses: torch.Tensor,
                     rows: slice | None = None) -> torch.Tensor:
        """The per-node gradient weights from every node's ``losses`` [m]:
        all of them, or the nodes ``rows`` (a rank's block; its rows of a
        per-node lambda)."""
        return torch.ones_like(losses if rows is None else losses[rows])

    def update(self, lam: torch.Tensor, losses: torch.Tensor, ctx=None, *, mixing=None,
               mask=None, step=None, events=None, rows: slice | None = None) -> torch.Tensor:
        """Advance lambda from every node's ``losses``; a time-varying round
        passes its dense W(t) and participation mask, a faulted one its
        round index and the model lane's fault events (duals that do not
        gossip ignore them).  ``rows``: a per-node lambda holds those nodes'
        rows only."""
        raise NotImplementedError

    def bits_per_round(self) -> float:
        return 0.0


def _prior_on(prior, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(prior, np.float32), device=device)


@dataclasses.dataclass(frozen=True)
class ProjectedAscent(DualUpdate):
    """AD-GDA's dual: projected gradient ascent + uncompressed lambda gossip.

        lam_i <- sum_j w_ij P_simplex(lam_j + eta_lam (f_j e_j + alpha grad r))

    Every node keeps its own copy of lambda (state [m, m]); a dropped node
    skips its ascent step, and a time-varying round mixes with W(t).
    ``mix_fn`` (the consensus's ``wire_mix`` under faults) carries the
    lambda gossip over the consensus's own faulted messages instead.
    """

    prior: np.ndarray
    alpha: float
    eta_lambda: float
    regularizer: dro.Regularizer
    topology: Topology | TopologySchedule
    mix_fn: Callable | None = None

    def init(self, m, device):
        return _prior_on(self.prior, device)[None].expand(m, m).clone()

    def grad_weights(self, lam, losses, rows=None):
        lo = 0 if rows is None else rows.start
        prior = _prior_on(self.prior, lam.device)
        return (torch.diagonal(lam, offset=lo)
                / (prior if rows is None else prior[rows])).float()

    def update(self, lam, losses, ctx=None, *, mixing=None, mask=None, step=None, events=None,
               rows=None):
        rows = slice(0, lam.shape[0]) if rows is None else rows
        prior = _prior_on(self.prior, lam.device)
        node_ids = torch.arange(rows.start, rows.stop, device=lam.device)
        dual_grads = dro.dual_gradient(losses[rows], node_ids, lam, prior, self.alpha,
                                       self.regularizer)
        lam_half = dro.project_simplex(lam + self.eta_lambda * dual_grads)
        if mask is not None:
            lam_half = torch.where((mask[rows] > 0).reshape(-1, 1), lam_half, lam)
        if mixing is not None:
            return mix_stacked_with(lam_half, mixing)
        if self.mix_fn is not None:
            return self.mix_fn(lam_half, step=step, mask=mask, events=events)
        return mix_stacked(lam_half, self.topology)

    def bits_per_round(self) -> float:
        return 32.0 * int(np.shape(self.prior)[0]) * self.topology.max_degree


@dataclasses.dataclass(frozen=True)
class FrozenPrior(DualUpdate):
    """Non-robust baseline (CHOCO-SGD): lambda frozen at the prior."""

    prior: np.ndarray

    def init(self, m, device):
        return _prior_on(self.prior, device)[None].expand(m, m).clone()

    def update(self, lam, losses, ctx=None, **_):
        return lam


@dataclasses.dataclass(frozen=True)
class KLClosedForm(DualUpdate):
    """DR-DSGD's dual: the KL inner max in closed form, lambda_i proportional
    to pi_i e^{f_i / alpha}, recomputed from every round's losses (state [m],
    kept for logging)."""

    prior: np.ndarray
    alpha: float

    def init(self, m, device):
        return _prior_on(self.prior, device)

    def grad_weights(self, lam, losses, rows=None):
        prior = _prior_on(self.prior, losses.device)
        w = (dro.kl_closed_form_weights(losses, prior, self.alpha) / prior).float()
        return w if rows is None else w[rows]

    def update(self, lam, losses, ctx=None, **_):
        return dro.kl_closed_form_weights(losses, _prior_on(self.prior, losses.device),
                                          self.alpha)


@dataclasses.dataclass(frozen=True)
class SampledAscent(DualUpdate):
    """DRFA's dual: sample |U| clients ~ lambda (Gumbel top-k, no
    replacement), run the round on them, then projected ascent on the
    importance-corrected observed losses.  The sampling mask is the round's
    ``ctx``, shared with :class:`FedAvg`."""

    prior: np.ndarray
    eta_lambda: float
    local_steps: int
    num_sampled: int

    def init(self, m, device):
        return _prior_on(self.prior, device)

    def begin(self, lam, generator, inject=None):
        """The round's [m] 0/1 sampling mask: ``inject`` if given, else
        Gumbel top-k of log(lambda) with the uniforms from ``generator``."""
        m = lam.shape[0]
        if inject is not None:
            return torch.as_tensor(inject, dtype=torch.float32).to(lam.device)
        u = torch.rand(m, generator=generator, dtype=torch.float32).to(lam.device)
        gumbel = -torch.log(-torch.log(u + 1e-20) + 1e-20)
        scores = torch.log(lam + 1e-20) + gumbel
        sampled = torch.topk(scores, self.num_sampled).indices
        return torch.zeros(m, dtype=torch.float32, device=lam.device).index_fill_(0, sampled,
                                                                                   1.0)

    def update(self, lam, losses, ctx=None, **_):
        sampled = ctx
        m = lam.shape[0]
        wsum = sampled.sum()
        loss_vec = losses * sampled * (m / torch.clamp(wsum, min=1.0))
        return dro.project_simplex(lam + self.eta_lambda * self.local_steps * loss_vec)


# ================================================================== consensus
class Consensus:
    """How the half-step models travel the wire.  ``schedule`` is set when
    the wire is time-varying; the trainer then passes the round index, the
    participation ``mask`` and the round's dense ``mixing`` to :meth:`mix`.
    Under a fault spec (``faults``) it passes the round index, the mask and
    the round's fault ``events`` (one per lane) instead of ``mixing``."""

    needs_theta_prev: bool = False  # gradient tracking reads the pre-update theta
    federated: bool = False  # True -> state.theta has no node axis
    schedule: TopologySchedule | None = None
    faults = None  # FaultSpec of the wire, or None
    union: UnionWirePlan | None = None  # the union wire under faults
    fault_lanes: int = 1  # fault draws per round (one per wire lane)

    def init(self, theta_stacked):
        return ()

    def mix(self, theta_half, state, generator, ctx=None, *, step=None, mask=None, mixing=None,
            noise=None, theta_prev=None, events=None):
        raise NotImplementedError

    @property
    def wire_format(self) -> wire.WireFormat:
        return wire.DENSE

    def bits_per_round(self, theta_template, *, mode: str = "max", step=None,
                       mask=None) -> float:
        raise NotImplementedError

    def bits_realized(self, theta_template, step, mask, consensus_state=None) -> float:
        """This round's wire bits (the busiest node's realized links)."""
        return float(np.float32(self.bits_per_round(theta_template, mode="max")))


def _resolve_wire_backend(backend: str, mesh, schedule, topology=None,
                          faults=None) -> UnionWirePlan | None:
    """Check the ``backend`` knob (``ppermute`` needs a mesh; a mesh of
    several ranks needs ``ppermute``) and compile the union wire when the
    round runs the cached union round: a time-varying ppermute wire, or any
    faulted wire (one plan per consensus: it sizes the mirrors and the
    fault state, picks the round's weights and bills the bits)."""
    if backend not in ("rolled", "ppermute"):
        raise ValueError(f"unknown gossip backend {backend!r}; choose rolled or ppermute")
    if backend == "ppermute" and mesh is None:
        raise ValueError("backend='ppermute' requires a mesh (see launch.mesh.make_node_mesh)")
    if backend == "rolled" and mesh is not None and mesh.size > 1:
        raise ValueError(f"a mesh of {mesh.size} ranks holds a block of the nodes per rank: "
                         "it needs backend='ppermute'")
    if not ((backend == "ppermute" and schedule is not None) or faults is not None):
        return None
    from repro_torch.core.exchange import resolve_union

    return resolve_union(None, schedule, topology)


def _union_degree(union: UnionWirePlan, schedule, mode: str, mask) -> float:
    """Billing degree of the union wire: every union edge carries one
    message every round, unless its sender is dead."""
    if mode == "max":
        return float(union.max_out_degree)
    if mode == "expected":
        rate = schedule.dropout_rate if schedule is not None else 0.0
        return union.max_out_degree * (1.0 - rate)
    if mode == "realized":
        if mask is None:
            raise ValueError("mode='realized' needs the round's participation mask")
        return union.realized_out_degree(mask)
    raise ValueError(f"unknown bits mode {mode!r}; choose max/expected/realized")


def _fault_bits_meter(cons_state):
    """The faulted wire's per-node delivered-bits meter in ``cons_state``:
    ``CHOCOState.fault.bits``, a bare :class:`~repro_torch.core.faults.WireBits`
    (the exact wire), or the sum of a :class:`GTState`'s two lanes; None
    when there is none."""
    if isinstance(cons_state, GTState):
        a, b = _fault_bits_meter(cons_state.model), _fault_bits_meter(cons_state.tracker)
        return a + b if a is not None and b is not None else None
    if isinstance(cons_state, WireBits):
        return cons_state.bits
    bits = getattr(getattr(cons_state, "fault", None), "bits", None)
    return bits


def _meter_max(meter, mesh=None) -> float:
    """The busiest node's meter reading (over every rank's block)."""
    top = meter.max().reshape(1).float().cpu()
    if mesh is not None and mesh.size > 1:
        import torch.distributed as dist

        dist.all_reduce(top, op=dist.ReduceOp.MAX, group=mesh.group)
    return float(np.float32(top.item()))


def _split_schedule(topology):
    """(representative topology, schedule or None, gamma source): a static
    schedule unwraps to its topology, so the circulant packed / fused paths
    run as on a plain topology."""
    if isinstance(topology, TopologySchedule):
        sched = None if topology.is_static else topology
        return topology.topology_at(0), sched, (sched or topology.topology_at(0))
    return topology, None, topology


def _realized_bits(total: float, degree: float) -> float:
    return float(np.float32(total) * np.float32(degree))


class ChocoConsensus(Consensus):
    """CHOCO-GOSSIP compressed round with the ``packed`` / ``fused``
    dispatch of ``gossip.choco_round``, on a topology or a schedule.  A
    time-varying schedule runs the masked round; ``fused=True`` with it, or
    with a compressor or topology the fused round cannot take, raises (the
    reference silently falls back).  ``faults`` (a spec or its string) runs
    every round on the cached union wire, with mirrors and fault state in
    the consensus state; ``fused=True`` then encodes on the fused kernel's
    digest variant (static circulant wire only, as without faults).
    ``backend="ppermute"`` runs the round on ``mesh``'s ranks (the state
    holds the rank's rows); a time-varying ppermute wire runs the cached
    union round against the NeighborCache."""

    def __init__(self, topology: Topology | TopologySchedule, compressor: Compressor,
                 gamma: float | str | None = None, *, packed: bool = True,
                 fused: bool = False, backend: str = "rolled", mesh=None, node_axes="data",
                 faults=None):
        self.topology, self.schedule, self._gamma_topology = _split_schedule(topology)
        self.faults = parse_fault_spec(faults)
        self.backend, self.mesh, self.node_axes = backend, mesh, node_axes
        if fused and self.schedule is not None:
            path = ("the faulted round, whose fused encode has no participation mask"
                    if self.faults is not None else "the masked path, which has no fused form")
            raise ValueError(
                f"fused gossip runs a static circulant round; the time-varying wire "
                f"{self.schedule.name!r} (a schedule or dropout) runs {path}: drop "
                f"--fused-gossip")
        if fused:
            check_fused(self.topology, compressor)
        self.compressor = compressor
        self.gamma_spec = gamma
        self.packed = packed
        self.fused = fused
        self.union = _resolve_wire_backend(backend, mesh, self.schedule, self.topology,
                                           self.faults)
        # provisional gamma until init()/mix() see the real leaf sizes
        self.gamma = self._resolve_gamma(4096)

    @staticmethod
    def _encode_dim(theta) -> int:
        """Largest per-node encode size the gossip layer will actually run on
        a *stacked* tree (mirrors ``gossip._scan_plan``'s chunking)."""
        best = 1
        for leaf in tree_leaves(theta):
            inner = int(np.prod(leaf.shape[1:])) if len(leaf.shape) > 1 else 1
            plan = _scan_plan(tuple(leaf.shape), inner, BLOCK_SCAN_ELEMS)
            best = max(best, inner if plan is None else inner // plan[1])
        return best

    def _resolve_gamma(self, d: int) -> float:
        """Consensus step size for the largest single encode of size d:
        ``"theory"`` -> Theorem 4.1 (the worst phase of a schedule), a
        number -> verbatim, None -> 0.5 delta(d)."""
        delta = getattr(self.compressor, "delta", 1.0)
        if hasattr(self.compressor, "delta_for"):
            delta = self.compressor.delta_for(max(int(d), 1))
        if self.gamma_spec == "theory":
            return self._gamma_topology.consensus_step_size(max(delta, 1e-3))
        if self.gamma_spec is not None:
            return float(self.gamma_spec)
        return 0.5 * max(delta, 1e-3)

    def _choco_init(self, theta_stacked) -> CHOCOState:
        n = self.union.n_ops if self.union is not None else 0
        return choco_init(theta_stacked, cache_ops=n,
                          fault_ops=n if self.faults is not None else None)

    def init(self, theta_stacked) -> CHOCOState:
        self.gamma = self._resolve_gamma(self._encode_dim(theta_stacked))
        return self._choco_init(theta_stacked)

    @property
    def native(self) -> bool:
        """The round takes step / mask / the union wire, never a dense W(t):
        the ppermute backend, or a faulted wire."""
        return self.backend == "ppermute" or self.faults is not None

    def _round_mixing(self, step, mask, mixing):
        if self.native:
            return None  # the union wire's banks give the round's weights
        if self.schedule is not None and mixing is None:
            return self.schedule.mixing_at(0 if step is None else step, mask)
        return mixing

    def _wire_kw(self, step, events) -> dict:
        """The wire arguments of a ppermute or faulted round (none for the
        rolled fault-free round)."""
        kw = {}
        if self.backend == "ppermute":
            kw = dict(backend="ppermute", mesh=self.mesh, node_axes=self.node_axes)
        if self.native:
            kw.update(schedule=self.schedule, step=0 if step is None else step,
                      union=self.union, faults=self.faults, events=events)
        return kw

    def mix(self, theta_half, state, generator, ctx=None, *, step=None, mask=None, mixing=None,
            noise=None, theta_prev=None, events=None):
        gamma = self._resolve_gamma(self._encode_dim(theta_half))
        return choco_round(theta_half, state, self.topology, gamma, self.compressor,
                           generator=generator, noise=noise, packed=self.packed,
                           fused=self.fused, mixing=self._round_mixing(step, mask, mixing),
                           mask=mask, **self._wire_kw(step, events))

    def wire_mix(self, tree, *, step=None, mask=None, events=None):
        """Uncompressed gossip of a stacked tree over this consensus's wire:
        on the ppermute backend the lambda gossip rides the model's sends
        (the union wire's weights on a time-varying wire); under faults it
        rides the model lane's messages (the same events) on the memoryless
        faulted mix; its bits stay billed at the dual's constant."""
        if self.backend == "ppermute":
            from repro_torch.core.exchange import mix_stacked_ppermute

            out = mix_stacked_ppermute(tree, self.topology, mesh=self.mesh,
                                       node_axes=self.node_axes, schedule=self.schedule,
                                       step=step, mask=mask, union=self.union,
                                       faults=self.faults, events=events)
            return out[0] if self.faults is not None else out
        if self.faults is None:
            return mix_stacked(tree, self.topology)
        from repro_torch.core.exchange import mix_stacked_faulted_local

        mixed, _ = mix_stacked_faulted_local(tree, union=self.union, step=step or 0, mask=mask,
                                             faults=self.faults, events=events)
        return mixed

    @property
    def wire_format(self) -> wire.WireFormat:
        if isinstance(self.compressor, Identity) or not self.packed:
            return wire.DENSE
        return wire.HAT_DELTA if self.union is not None else wire.PAYLOAD

    def bits_per_round(self, theta_template, *, mode: str = "max", step=None, mask=None,
                       compressor=None) -> float:
        comp = compressor if compressor is not None else self.compressor
        if self.union is not None:
            # every union edge carries one hat-delta every round: the union degree
            return payload_bits(comp, theta_template, self.schedule,
                                degree=_union_degree(self.union, self.schedule, mode, mask))
        return payload_bits(comp, theta_template, self.schedule or self.topology, mode=mode,
                            step=step, mask=mask)

    def bits_per_lane(self, theta_template, *, mode: str = "max", step=None,
                      mask=None) -> dict:
        """Busiest-node bits per :attr:`wire_format` lane, keyed by name."""
        one = ChocoConsensus.bits_per_round(self, theta_template, mode=mode, step=step,
                                            mask=mask)
        return {lane.name: one for lane in self.wire_format}

    def bits_realized(self, theta_template, step, mask, consensus_state=None):
        if self.faults is not None:
            meter = _fault_bits_meter(consensus_state)
            if meter is not None:  # the exchange's delivered bits
                return _meter_max(meter, self.mesh)
        total = payload_total_bits(self.compressor, theta_template)
        if self.union is not None:
            return _realized_bits(total, self.union.realized_out_degree_traced(mask))
        topo = self.schedule or self.topology
        return _realized_bits(total, topo.realized_degree_traced(step, mask))


@dataclasses.dataclass
class GTState:
    """Gradient-tracking consensus state: one :class:`CHOCOState` per lane,
    the tracker ``y`` (each node's gossiped estimate of the network-average
    local displacement) and ``d_prev``, the node's own last displacement."""

    model: CHOCOState
    tracker: CHOCOState
    y: Any  # stacked tree [m, ...], theta-shaped
    d_prev: Any  # stacked tree [m, ...], theta-shaped


# f32 temporaries of the tracker update are made over column blocks of this
# many elements per node, never over a whole leaf
_GT_CHUNK = 1 << 22


def _gt_update_(theta_half, theta_prev, y, d_prev, alive) -> None:
    """The tracker update, leaf by leaf and block by block, in place:
    ``theta_half`` <- x_half, ``y`` <- y_half, ``d_prev`` <- d (see
    :class:`GradientTrackingConsensus`); ``alive`` is the [m] mask or None."""
    for h, p, yl, dl in zip(*(tree_leaves(t) for t in (theta_half, theta_prev, y, d_prev))):
        m = h.shape[0]
        hv, pv, yv, dv = (x.view(m, -1) for x in (h, p, yl, dl))
        a = None if alive is None else alive.reshape(m, 1)
        for lo in range(0, hv.shape[1], _GT_CHUNK):
            hh, pp, yy, dd = (x[:, lo:lo + _GT_CHUNK] for x in (hv, pv, yv, dv))
            d = hh.float() - pp.float()
            if a is not None:
                y_half = yy.float() + a * (d - dd.float())
                d_new = a * d + (1.0 - a) * dd.float()
                x_half = hh.float() + a * (y_half - d)
            else:
                y_half = yy.float() + d - dd.float()
                d_new = d
                x_half = pp.float() + y_half
            hh.copy_(x_half)
            yy.copy_(y_half)
            dd.copy_(d_new)


class GradientTrackingConsensus(ChocoConsensus):
    """CHOCO-compressed gossip with gradient tracking for K local steps
    (arXiv 2405.00965, in CHOCO displacement form).  With ``d_i =
    theta_half_i - theta_prev_i`` the node's K-step displacement::

        y_half_i = y_i + d_i - d_prev_i            # tracker update
        x_half_i = theta_prev_i + y_half_i         # drift-corrected iterate
        theta    <- CHOCO-round(x_half, model lane)
        y        <- CHOCO-round(y_half, tracker lane)
        d_prev_i <- d_i

    The lanes ride one round (:func:`~repro_torch.core.gossip.choco_round_lanes`),
    each with its own trackers; the tracker lane may use its own compressor
    and gamma.  A dropped node keeps ``y`` and ``d_prev``.  ``tracker=False``
    is :class:`ChocoConsensus` exactly.  The update runs in place over
    column blocks, so only the pre-update theta (``theta_prev``, one copy
    the trainer keeps) adds a theta-sized tree.  ``noise`` is a pair, the
    model lane's and the tracker lane's, and so are the fault ``events``:
    each lane keeps its own mirrors and fault state.
    """

    def __init__(self, topology, compressor, gamma=None, *, tracker: bool = True,
                 tracker_gamma: float | None = None,
                 tracker_compressor: Compressor | str | None = None, **kw):
        super().__init__(topology, compressor, gamma, **kw)
        self.tracker = tracker
        self.tracker_gamma_spec = tracker_gamma
        if isinstance(tracker_compressor, str):
            from repro_torch.core.compression import make_compressor

            tracker_compressor = make_compressor(tracker_compressor)
        if (self.fused and tracker_compressor is not None
                and not getattr(tracker_compressor, "supports_fused_round", False)):
            check_fused(self.topology, tracker_compressor)
        self.tracker_compressor = tracker_compressor

    @property
    def needs_theta_prev(self) -> bool:
        return self.tracker

    @property
    def fault_lanes(self) -> int:
        return 2 if self.tracker else 1

    @property
    def _tracker_comp(self) -> Compressor:
        return (self.tracker_compressor if self.tracker_compressor is not None
                else self.compressor)

    def _resolve_tracker_gamma(self, gamma: float, d: int) -> float:
        """An explicit ``tracker_gamma``; else the model's gamma when the
        lanes share a compressor; else 0.5 delta of the tracker's."""
        if self.tracker_gamma_spec is not None:
            return float(self.tracker_gamma_spec)
        if self.tracker_compressor is None:
            return gamma
        comp = self.tracker_compressor
        delta = getattr(comp, "delta", 1.0)
        if hasattr(comp, "delta_for"):
            delta = comp.delta_for(max(int(d), 1))
        return 0.5 * max(delta, 1e-3)

    def init(self, theta_stacked):
        base = super().init(theta_stacked)
        if not self.tracker:
            return base
        zeros = lambda: tree_map(torch.zeros_like, theta_stacked)
        return GTState(model=base, tracker=self._choco_init(theta_stacked), y=zeros(),
                       d_prev=zeros())

    def mix(self, theta_half, state, generator, ctx=None, *, step=None, mask=None, mixing=None,
            noise=None, theta_prev=None, events=None):
        if not self.tracker:
            return super().mix(theta_half, state, generator, ctx, step=step, mask=mask,
                               mixing=mixing, noise=noise, events=events)
        if theta_prev is None:
            raise ValueError("GradientTrackingConsensus.mix needs theta_prev (the round's "
                             "pre-local-update theta)")
        d = self._encode_dim(theta_half)
        gamma = self._resolve_gamma(d)
        tgamma = self._resolve_tracker_gamma(gamma, d)
        alive = mask
        if mask is not None and self.mesh is not None:
            alive = mask[self.mesh.rows(self.mesh.size * tree_leaves(theta_half)[0].shape[0])]
        _gt_update_(theta_half, theta_prev, state.y, state.d_prev, alive)
        (x_new, y_new), (model_new, tracker_new) = choco_round_lanes(
            (LaneRound(theta_half, state.model, gamma, self.compressor),
             LaneRound(state.y, state.tracker, tgamma, self._tracker_comp)),
            self.topology, generator, noises=noise, packed=self.packed, fused=self.fused,
            mixing=self._round_mixing(step, mask, mixing), mask=mask,
            **self._wire_kw(step, events))
        return x_new, GTState(model=model_new, tracker=tracker_new, y=y_new,
                              d_prev=state.d_prev)

    @property
    def wire_format(self) -> wire.WireFormat:
        base = super().wire_format
        if not self.tracker:
            return base
        kind = tkind = base.lanes[0].kind
        if self.tracker_compressor is not None:
            tkind = (wire.DENSE.lanes[0].kind
                     if isinstance(self.tracker_compressor, Identity) or not self.packed
                     else kind)
        return wire.WireFormat((wire.Lane(kind, "model"), wire.Lane(tkind, "tracker")))

    def bits_per_round(self, theta_template, *, mode: str = "max", step=None, mask=None,
                       compressor=None) -> float:
        if compressor is not None:
            return super().bits_per_round(theta_template, mode=mode, step=step, mask=mask,
                                          compressor=compressor)
        return sum(self.bits_per_lane(theta_template, mode=mode, step=step,
                                      mask=mask).values())

    def bits_per_lane(self, theta_template, *, mode: str = "max", step=None,
                      mask=None) -> dict:
        """Each lane priced at its own compressor."""
        if not self.tracker:
            return super().bits_per_lane(theta_template, mode=mode, step=step, mask=mask)
        comps = {"model": self.compressor, "tracker": self._tracker_comp}
        return {lane.name: ChocoConsensus.bits_per_round(self, theta_template, mode=mode,
                                                         step=step, mask=mask,
                                                         compressor=comps[lane.name])
                for lane in self.wire_format}

    def bits_realized(self, theta_template, step, mask, consensus_state=None):
        if not self.tracker:
            return super().bits_realized(theta_template, step, mask, consensus_state)
        if self.faults is not None:
            meter = _fault_bits_meter(consensus_state)
            if meter is not None:  # both lanes' delivered bits
                return _meter_max(meter, self.mesh)
        one = super().bits_realized(theta_template, step, mask)
        scale = 2.0
        if self.tracker_compressor is not None:
            model_total = payload_total_bits(self.compressor, theta_template)
            scale = 1.0 + (payload_total_bits(self.tracker_compressor, theta_template)
                           / model_total if model_total else 1.0)
        return float(np.float32(scale) * np.float32(one))


class ExactConsensus(Consensus):
    """Uncompressed gossip: theta_i <- sum_j w_ij theta_j (DR-DSGD's wire),
    on a topology or a schedule (W(t), dropped nodes hold their model).
    Under ``faults`` the wire is memoryless: a faulted message leaves the
    round's mix, and the state is the delivered-bits meter (WireBits).
    ``backend="ppermute"`` sends the dense models between graph neighbours
    on ``mesh``'s ranks (a schedule's weights from the union wire, only its
    phase's active edges when fault-free)."""

    def __init__(self, topology: Topology | TopologySchedule, *, backend: str = "rolled",
                 mesh=None, node_axes="data", faults=None):
        self.topology, self.schedule, _ = _split_schedule(topology)
        self.faults = parse_fault_spec(faults)
        self.backend, self.mesh, self.node_axes = backend, mesh, node_axes
        self.union = _resolve_wire_backend(backend, mesh, self.schedule, self.topology,
                                           self.faults)

    def init(self, theta_stacked):
        if self.faults is None:
            return ()
        first = tree_leaves(theta_stacked)[0]
        return WireBits(bits=torch.zeros(first.shape[0], dtype=torch.float32,
                                         device=first.device))

    def mix(self, theta_half, state, generator, ctx=None, *, step=None, mask=None, mixing=None,
            noise=None, theta_prev=None, events=None):
        if self.backend == "ppermute":
            from repro_torch.core.exchange import mix_stacked_ppermute

            if mixing is not None:
                raise ValueError("backend='ppermute' takes step/mask, not a dense mixing matrix "
                                 "-- the wire program is compiled from the schedule")
            out = mix_stacked_ppermute(theta_half, self.topology, mesh=self.mesh,
                                       node_axes=self.node_axes, schedule=self.schedule,
                                       step=step, mask=mask, union=self.union,
                                       faults=self.faults, events=events)
            if self.faults is not None:
                return out[0], WireBits(bits=out[1].to(state.bits.device))
            return out, state
        if self.faults is not None:
            from repro_torch.core.exchange import mix_stacked_faulted_local

            mixed, bits = mix_stacked_faulted_local(theta_half, union=self.union,
                                                    step=step or 0, mask=mask,
                                                    faults=self.faults, events=events)
            return mixed, WireBits(bits=bits.to(state.bits.device))
        if self.schedule is not None and mixing is None:
            mixing = self.schedule.mixing_at(0 if step is None else step, mask)
        if mixing is not None:
            return mix_stacked_with(theta_half, mixing), state
        return mix_stacked(theta_half, self.topology), state

    def bits_per_round(self, theta_template, *, mode: str = "max", step=None,
                       mask=None) -> float:
        if self.union is not None:  # the faulted wire moves a message on every union op
            return payload_bits(Identity(), theta_template, self.schedule,
                                degree=_union_degree(self.union, self.schedule, mode, mask))
        return payload_bits(Identity(), theta_template, self.schedule or self.topology,
                            mode=mode, step=step, mask=mask)

    def bits_realized(self, theta_template, step, mask, consensus_state=None):
        if self.faults is not None:
            meter = _fault_bits_meter(consensus_state)
            if meter is not None:
                return _meter_max(meter, self.mesh)
        total = payload_total_bits(Identity(), theta_template)
        if self.union is not None:
            return _realized_bits(total, self.union.realized_out_degree_traced(mask))
        topo = self.schedule or self.topology
        return _realized_bits(total, topo.realized_degree_traced(step, mask))


class FedAvg(Consensus):
    """Federated server averaging over the sampled clients (DRFA's wire):
    stacked local models in, the single server model out (the trainer
    broadcasts it next round).  With no sampling ``ctx`` every client is
    averaged.  ``backend="ppermute"``: each rank sums its block's sampled
    models and one all-reduce aggregates them (the reference's ``psum``)."""

    federated = True

    def __init__(self, num_sampled: int, *, backend: str = "rolled", mesh=None,
                 node_axes="data"):
        _resolve_wire_backend(backend, mesh, None)
        self.num_sampled = num_sampled
        self.backend, self.mesh, self.node_axes = backend, mesh, node_axes

    def mix(self, theta_locals, state, generator, ctx=None, *, step=None, mask=None,
            mixing=None, noise=None, theta_prev=None, events=None):
        m = tree_leaves(theta_locals)[0].shape[0]
        sampled = ctx
        if self.backend == "ppermute":
            from repro_torch.core.exchange import server_average_ppermute

            if sampled is None:
                sampled = torch.ones(m * self.mesh.size, dtype=torch.float32)
            return server_average_ppermute(theta_locals, sampled, mesh=self.mesh,
                                           node_axes=self.node_axes), state
        if sampled is None:
            sampled = torch.ones(m, dtype=torch.float32,
                                 device=tree_leaves(theta_locals)[0].device)
        wsum = sampled.sum()
        theta_new = tree_map(
            lambda x: ((x.float() * sampled.reshape((m,) + (1,) * (x.ndim - 1))).sum(0)
                       / wsum).to(x.dtype), theta_locals)
        return theta_new, state

    def bits_per_round(self, theta_template, *, mode: str = "max", step=None,
                       mask=None) -> float:
        """The server: |U| models down and |U| up, f32; the template is the
        server model (no node axis)."""
        d = sum(int(np.prod(x.shape)) for x in tree_leaves(theta_template))
        return 2.0 * self.num_sampled * d * 32.0


# ==================================================================== trainer
def _rows(mask) -> list[int]:
    return [i for i, a in enumerate(mask.tolist()) if a <= 0]


class DecentralizedTrainer:
    """oracle x optimizer x dual x consensus, one round per ``step``::

        trainer = DecentralizedTrainer(loss_fn, num_nodes=m, local=..., dual=...,
                                       consensus=..., device="cuda")
        state = trainer.init(params, seed)
        state, aux = trainer.step(state, batch)   # updates state in place

    ``batch`` leaves are stacked [m, per-node-batch, ...] on the trainer's
    device; ``loss_fn(params, batch, rng)`` is one node's loss (``rng`` is
    None: the losses here draw no randomness).

    With ``mesh`` (a :class:`~repro_torch.launch.mesh.NodeMesh` of R ranks,
    the consensus on ``backend="ppermute"``) each rank runs this trainer on
    its block of ``num_nodes / R`` nodes: ``batch`` holds the rank's rows,
    the state its rows of theta, the moments, the consensus state and a
    per-node lambda, on the rank's device; the aux metrics are the whole
    network's, equal on every rank.
    """

    def __init__(self, loss_fn: LossFn, *, num_nodes: int, local: LocalUpdate,
                 dual: DualUpdate, consensus: Consensus, prior=None,
                 track_average: bool = True, config: Any = None, device="cuda", mesh=None):
        self.device = resolve_device(device) if mesh is None else mesh.device
        self.mesh = mesh
        self.rows = slice(0, num_nodes) if mesh is None else mesh.rows(num_nodes)
        if mesh is not None and mesh.size > 1 and getattr(consensus, "backend", None) != "ppermute":
            raise ValueError("a mesh of several ranks needs a consensus on backend='ppermute' "
                             "(each rank holds a block of the nodes)")
        self.loss_fn = loss_fn
        self.num_nodes = num_nodes
        self.local = local
        self.dual = dual
        self.consensus = consensus
        self.prior = (np.full((num_nodes,), 1.0 / num_nodes, np.float32) if prior is None
                      else np.asarray(prior, np.float32))
        self.track_average = track_average
        self.config = config
        self.federated = consensus.federated

    def _init_as(self, composed: "DecentralizedTrainer") -> None:
        """Deprecated-shim helper: adopt a factory-built trainer's composition
        wholesale, so the shims cannot drift from the factories field by field."""
        DecentralizedTrainer.__init__(
            self, composed.loss_fn, num_nodes=composed.num_nodes, local=composed.local,
            dual=composed.dual, consensus=composed.consensus, prior=composed.prior,
            track_average=composed.track_average, config=composed.config,
            device=composed.device, mesh=composed.mesh)

    @property
    def topology(self) -> Topology | None:
        return getattr(self.consensus, "topology", None)

    @property
    def schedule(self) -> TopologySchedule | None:
        """The time-varying schedule, or None when the wire is static."""
        return getattr(self.consensus, "schedule", None)

    @property
    def compressor(self) -> Compressor | None:
        return getattr(self.consensus, "compressor", None)

    @property
    def gamma(self) -> float | None:
        return getattr(self.consensus, "gamma", None)

    @property
    def sharded(self) -> bool:
        """Whether the nodes are spread over several ranks."""
        return self.mesh is not None and self.mesh.size > 1

    def _stacked(self, params):
        m = self.rows.stop - self.rows.start  # this rank's block
        return tree_map(
            lambda p: p.to(self.device)[None].expand((m,) + tuple(p.shape)).clone(), params)

    def _gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's rows of a per-node [block] value, as [m]."""
        if not self.sharded:
            return x
        from repro_torch.core.exchange import all_gather_rows

        return all_gather_rows(x, self.mesh)

    def _node_mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean over all nodes of an f32 [block, ...] tensor."""
        if not self.sharded:
            return x.mean(0)
        from repro_torch.core.exchange import all_reduce_sum

        return all_reduce_sum(x.sum(0), self.mesh) / self.num_nodes

    # ------------------------------------------------------------------ init
    def init(self, params: Any, seed: int = 0) -> TrainerState:
        """Stack ``params`` (one model, any device) to every node on the
        trainer's device (federated: keep one server copy).  The generators
        are seeded from ``seed``: gossip ``seed``, dual ``seed + 2**32``,
        mask ``seed + 2**33``, fault ``seed + 3 * 2**32`` (on every rank the
        same: each draws the whole network's values and keeps its rows)."""
        stacked = self._stacked(params)
        theta0 = (tree_map(lambda p: p.to(self.device, copy=True), params) if self.federated
                  else stacked)
        lam = self.dual.init(self.num_nodes, self.device)
        if lam.ndim == 2 and self.sharded:  # a per-node lambda: this rank's rows
            lam = lam[self.rows].clone()
        return TrainerState(
            step=0,
            theta=theta0,
            lam=lam,
            opt=self.local.init(stacked),
            consensus=self.consensus.init(stacked),
            theta_avg=(tree_map(lambda p: p.to(self.device, torch.float32, copy=True), params)
                       if self.track_average else ()),
            generator=torch.Generator(device=self.device).manual_seed(seed),
            dual_generator=torch.Generator().manual_seed(seed + (1 << 32)),
            mask_generator=torch.Generator().manual_seed(seed + (2 << 32)),
            fault_generator=torch.Generator().manual_seed(seed + (3 << 32)),
        )

    # ------------------------------------------------------------------ step
    def _fault_events(self, state: TrainerState, fault_u):
        """The round's fault events, one per wire lane: drawn from the fault
        generator lane after lane ([n_ops, m] uniforms each), or from the
        injected ``fault_u`` (one draw, or a sequence with one per lane)."""
        cons = self.consensus
        lanes = cons.fault_lanes
        if fault_u is None:
            us = [torch.rand((cons.union.n_ops, self.num_nodes), generator=state.fault_generator,
                             dtype=torch.float32) for _ in range(lanes)]
        else:
            us = [fault_u] if lanes == 1 else list(fault_u)
        events = [sample_events(cons.faults, u if isinstance(u, torch.Tensor)
                                else torch.from_numpy(np.array(u, np.float32)))
                  for u in us]
        return events[0] if lanes == 1 else tuple(events)

    def step(self, state: TrainerState, batch: Any, *, noise=None, mask=None,
             sampled=None, fault_u=None) -> tuple[TrainerState, dict]:
        """One round; ``state``'s tensors are updated in place and returned in
        a new :class:`TrainerState` with the aux metrics (device tensors).
        ``noise`` / ``mask`` / ``sampled`` / ``fault_u`` inject the gossip
        noise, the participation mask, the dual's client sample and the
        wire's fault draw ([n_ops, m] uniforms; a pair for gradient
        tracking's two lanes) in place of draws."""
        with tracing.span("round", device=self.device):
            return self._step(state, batch, noise, mask, sampled, fault_u)

    def _step(self, state: TrainerState, batch: Any, noise, mask, sampled, fault_u):
        schedule = self.schedule
        needs_mask = schedule is not None and schedule.dropout_rate > 0
        faulted = getattr(self.consensus, "faults", None) is not None
        if mask is not None and not needs_mask:
            raise ValueError("mask= needs a wire with dropout")
        if fault_u is not None and not faulted:
            raise ValueError("fault_u= needs a wire with a fault spec")
        if needs_mask:
            mask = (schedule.mask_at(state.mask_generator, state.step) if mask is None
                    else torch.tensor(np.asarray(mask, np.float32)))
        # the lambda gossip rides the model lane's faulted messages
        events = self._fault_events(state, fault_u) if faulted else None
        dual_events = events if isinstance(events, FaultEvents) or events is None else events[0]
        # a faulted or ppermute round mixes over the union wire's banks, never a dense W(t)
        native = faulted or getattr(self.consensus, "backend", "rolled") == "ppermute"
        mixing = (schedule.mixing_at(state.step, mask).to(self.device)
                  if schedule is not None and not native else None)
        mask_dev = None if mask is None else mask.to(self.device)
        ctx = self.dual.begin(state.lam, state.dual_generator, inject=sampled)

        theta = self._stacked(state.theta) if self.federated else state.theta
        flat = tree_leaves(theta)
        theta_prev = (tree_map(lambda x: x.clone(), theta)
                      if self.consensus.needs_theta_prev else None)
        node_rows = self.rows if self.sharded else None
        dropped = _rows(mask[self.rows]) if mask is not None else []
        if dropped:  # the dropped rows only: theta and the per-node moments
            rows = torch.tensor(dropped, device=self.device)
            moments = [x for part in (state.opt.mu, state.opt.nu) for x in part]
            saved = [x.index_select(0, rows) for x in flat + moments]

        eta = self.local.lr(state.opt)
        weights_fn = lambda losses: self.dual.grad_weights(state.lam, self._gather(losses),
                                                            node_rows)
        opt_new, losses = self.local.step(self.loss_fn, theta, state.opt, batch, weights_fn)
        losses = self._gather(losses)
        if dropped:  # a node that sat the round out resumes where it left off
            moments = [x for part in (opt_new.mu, opt_new.nu) for x in part]
            for x, old in zip(flat + moments, saved):
                x.index_copy_(0, rows, old)
            del saved
        with tracing.span("dual"):
            lam_new = self.dual.update(state.lam, losses, ctx, mixing=mixing, mask=mask_dev,
                                       step=state.step, events=dual_events, rows=node_rows)
        with tracing.span("consensus"):
            theta_new, cons_new = self.consensus.mix(
                theta, state.consensus, state.generator, ctx, step=state.step, mask=mask_dev,
                mixing=mixing, noise=noise, theta_prev=theta_prev, events=events)
        del theta_prev

        theta_avg = state.theta_avg
        if self.track_average:
            mean = ((lambda th: th.float()) if self.federated
                    else (lambda th: self._node_mean(th.float())))

            def running(avg, th):
                tt = float(state.step)
                return (avg * tt + mean(th)) / f32_full(avg, tt + 1.0)

            theta_avg = tree_map(running, state.theta_avg, theta_new)

        aux = {
            "losses": losses,
            "worst_loss": losses.max(),
            "mean_loss": losses.mean(),
            "lambda_mean": self._node_mean(lam_new) if lam_new.ndim == 2 else lam_new,
            "eta_theta": eta,
        }
        if not self.federated:
            with tracing.span("consensus_err"):
                aux["consensus_err"] = _consensus_error(theta_new, self.mesh)
        if mask is not None:
            aux["participation"] = mask
        aux["bits_realized"] = float(
            np.float32(self.consensus.bits_realized(theta_new, state.step, mask,
                                                    consensus_state=cons_new))
            + np.float32(self.dual.bits_per_round()))
        new_state = dataclasses.replace(state, step=state.step + 1, theta=theta_new,
                                        lam=lam_new, opt=opt_new, consensus=cons_new,
                                        theta_avg=theta_avg)
        return new_state, aux

    # ------------------------------------------------------------- utilities
    def network_mean(self, state: TrainerState):
        if self.federated:
            return tree_map(lambda x: x.float(), state.theta)
        return tree_map(lambda x: self._node_mean(x.float()), state.theta)

    def bits_per_round(self, state: TrainerState, per_iteration: bool = False, *,
                       mode: str = "max", step=None, mask=None) -> float:
        """Bits sent per round by the busiest node (model payload + the
        dual's traffic); ``per_iteration=True`` divides by ``local_steps``.
        ``mode`` bills the payload at the max, expected or realized degree
        (the dual's m floats stay at their upper bound); under faults
        ``"realized"`` reads the delivered-bits meter of the last round."""
        meter = (_fault_bits_meter(state.consensus)
                 if mode == "realized" and getattr(self.consensus, "faults", None) is not None
                 else None)
        if meter is not None:
            bits = _meter_max(meter, self.mesh) + self.dual.bits_per_round()
        else:
            bits = (self.consensus.bits_per_round(state.theta, mode=mode, step=step, mask=mask)
                    + self.dual.bits_per_round())
        if per_iteration:
            bits /= self.local.local_steps
        return bits


def _consensus_error(theta_stacked, mesh=None, chunk_elems: int = 1 << 22,
                     batch: int = 8) -> torch.Tensor:
    """Xi_theta = sum_i ||theta_i - theta_bar||^2 over all leaves (f32), taken
    over column blocks of ``chunk_elems`` per node so no f32 copy of a whole
    leaf is made.

    On a mesh of several ranks column block k belongs to rank k mod R: the
    other ranks send it their rows (``batch`` blocks an exchange), its owner
    computes the block's term over all m rows, and one all-reduce of the
    per-block terms lets every rank add them in the one-process order -- the
    one-process value, bit for bit, for a (R - 1) / R share of each rank's
    rows on the wire."""
    blocks = []
    for leaf in tree_leaves(theta_stacked):
        flat = leaf.reshape(leaf.shape[0], -1)
        blocks += [flat[:, lo:lo + chunk_elems] for lo in range(0, flat.shape[1], chunk_elems)]

    def term(x):
        x = x.float()
        return torch.sum((x - x.mean(0, keepdim=True)) ** 2)

    if mesh is None or mesh.size == 1:
        parts = [term(x) for x in blocks]
    else:
        from repro_torch.core.exchange import Recv, all_reduce_sum, exchange

        R, r = mesh.size, mesh.rank
        terms = torch.zeros(len(blocks), dtype=torch.float32, device=blocks[0].device)
        for lo in range(0, len(blocks), batch):
            ks = range(lo, min(lo + batch, len(blocks)))
            entries = []  # per block and rank offset d: my rows to its owner
            for k in ks:
                x = blocks[k]
                for d in range(1, R):
                    entries.append((x.contiguous() if (r + d) % R == k % R else None,
                                    (r + d) % R,
                                    Recv(tuple(x.shape), x.dtype, x.device)
                                    if k % R == r else None, (r - d) % R))
            got = exchange(entries, mesh, meter=False)
            for j, k in enumerate(ks):
                if k % R == r:  # the owner: every rank's rows, in rank order
                    rows = {r: blocks[k]}
                    rows.update({(r - d) % R: got[j * (R - 1) + d - 1] for d in range(1, R)})
                    terms[k] = term(torch.cat([rows[q] for q in range(R)]))
        parts = list(all_reduce_sum(terms, mesh))
    err = None
    for part in parts:
        err = part if err is None else err + part
    return err
