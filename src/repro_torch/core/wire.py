"""The wire layer (port of ``repro.core.wire``): what a consensus round puts
on an edge, and the union wire plan whose NeighborCache lets a receiver keep
an exact mirror of each in-neighbour's ``theta_hat``.

* :class:`Lane` / :class:`WireFormat` -- the per-edge message, one lane per
  variable on the wire (``payload``, ``dense``, ``hat-delta``, ``digest``,
  ``hat-resync``); they label a consensus's message and key its per-lane bit
  accounting, the bits themselves come from ``gossip.payload_bits``.
* :class:`UnionWirePlan` -- one wire program for every phase of a schedule:
  the deduplicated union of the phases' exchange ops, with per-phase weight
  banks indexed by ``t % period``.  Every union edge carries the sender's
  compressed hat-delta every round, so each receiver's mirror (one per op,
  :func:`init_neighbor_cache`) stays bit-identical to the sender's
  ``theta_hat``; ``core/exchange.py`` runs the round.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.core.topology import PermutePlan
from repro_torch.tree import tree_map

__all__ = [
    "Lane",
    "WireFormat",
    "PAYLOAD",
    "DENSE",
    "HAT_DELTA",
    "DIGEST",
    "HAT_RESYNC",
    "GT_LANES",
    "GT_PAYLOAD",
    "UnionWirePlan",
    "compile_union_wire",
    "init_neighbor_cache",
]


@dataclasses.dataclass(frozen=True)
class Lane:
    """One state variable's slot in a per-edge message: ``kind`` is
    ``"payload"`` (the compressor's encoding), ``"dense"`` (the raw f32
    tensor), ``"hat-delta"`` (a compressed increment to the receiver's
    mirror), ``"digest"`` (the 32-bit checksum of the sender's post-round
    ``theta_hat``, one per leaf chunk, on a faulted wire) or
    ``"hat-resync"`` (the whole ``theta_hat`` at its dtype, on an edge
    whose mirror went stale); ``name`` says which variable rides it
    (``"model"``, ``"tracker"``, ...)."""

    kind: str
    name: str = "model"

    def __str__(self) -> str:
        return self.kind if self.name == "model" else f"{self.name}:{self.kind}"


def _as_lanes(lanes) -> tuple:
    if isinstance(lanes, str):
        return (Lane(lanes),)
    if isinstance(lanes, Lane):
        return (lanes,)
    return tuple(Lane(x) if isinstance(x, str) else x for x in lanes)


@dataclasses.dataclass(frozen=True)
class WireFormat:
    """An ordered tuple of :class:`Lane` descriptors, one per variable on
    the wire; a single-lane format answers ``kind``."""

    lanes: tuple[Lane, ...]

    def __post_init__(self):
        object.__setattr__(self, "lanes", _as_lanes(self.lanes))
        if not self.lanes:
            raise ValueError("WireFormat needs at least one lane")

    @property
    def kind(self) -> str:
        if len(self.lanes) != 1:
            raise ValueError(f"multi-lane format {self} has no single kind; iterate lanes")
        return self.lanes[0].kind

    def __len__(self) -> int:
        return len(self.lanes)

    def __iter__(self):
        return iter(self.lanes)

    def __getitem__(self, i) -> Lane:
        return self.lanes[i]

    def __str__(self) -> str:
        return "+".join(str(lane) for lane in self.lanes)


PAYLOAD = WireFormat("payload")
DENSE = WireFormat("dense")
HAT_DELTA = WireFormat("hat-delta")
DIGEST = WireFormat("digest")
HAT_RESYNC = WireFormat("hat-resync")

#: gradient tracking's wire: model and tracker hat-deltas on every union
#: edge, each lane with its own mirrors, digests and resync state
GT_LANES = WireFormat((Lane("hat-delta", "model"), Lane("hat-delta", "tracker")))
#: its static twin: two packed payloads per edge, no mirrors
GT_PAYLOAD = WireFormat((Lane("payload", "model"), Lane("payload", "tracker")))


# ============================================================= UnionWirePlan
@dataclasses.dataclass(frozen=True, eq=False)
class UnionWirePlan:
    """One wire program for all phases of a topology schedule.

    ``ops`` is the deduplicated union of every phase's
    :meth:`~repro_torch.core.topology.PermutePlan.exchange_ops`; ``senders``
    the matching sender maps (``senders[k][i]`` = the node whose value node
    ``i`` receives on op ``k``, -1 when none).  Per-phase banks, indexed by
    ``t % period``:

    * ``w_bank[p, k, i]`` -- phase ``p``'s receive weight ``W_p[i,
      senders[k][i]]`` (0 when op ``k`` is not in phase ``p``);
    * ``self_bank[p, i]`` -- ``W_p[i, i]``;
    * ``active[p, k, i]`` -- 1.0 iff node ``i`` receives on op ``k`` in
      phase ``p`` (the edge set the masked-Metropolis reweighting runs on).
    """

    name: str
    num_nodes: int
    period: int
    ops: tuple[tuple[str, object], ...]
    senders: tuple[np.ndarray, ...]
    w_bank: np.ndarray  # [P, n_ops, m] f32
    self_bank: np.ndarray  # [P, m] f32
    active: np.ndarray  # [P, n_ops, m] f32

    @property
    def n_ops(self) -> int:
        return len(self.ops)

    @property
    def out_degree(self) -> np.ndarray:
        """[m] hat-delta payloads each node sends per round: one per (op,
        receiver) slot it feeds -- every union edge carries a delta every
        round, which is what keeps the mirrors exact."""
        out = np.zeros((self.num_nodes,), np.int64)
        for snd in self.senders:
            np.add.at(out, snd[snd >= 0], 1)
        return out

    @property
    def max_out_degree(self) -> int:
        """The busiest sender's per-round payload count."""
        return int(self.out_degree.max()) if self.n_ops else 0

    def realized_out_degree(self, mask) -> float:
        """The busiest *alive* sender's payload count under a participation
        mask (dead nodes send nothing)."""
        alive = np.asarray(mask, np.float64).reshape(-1)
        return float((alive * self.out_degree).max())

    def realized_out_degree_traced(self, mask) -> float:
        """:meth:`realized_out_degree` in f32, as the reference's in-graph
        meter (``mask=None``: the max out-degree)."""
        out = torch.as_tensor(self.out_degree, dtype=torch.float32)
        if mask is None:
            return float(out.max())
        alive = torch.as_tensor(np.asarray(mask.cpu() if isinstance(mask, torch.Tensor)
                                           else mask), dtype=torch.float32)
        return float((alive * out).max())


def compile_union_wire(plans: Sequence[PermutePlan], name: str | None = None) -> UnionWirePlan:
    """Unite per-phase :class:`~repro_torch.core.topology.PermutePlan` wire
    programs (``compile_schedule_plans``) into one :class:`UnionWirePlan`.
    Ops are deduplicated by their exchange key (normalized shift, or the
    exact (src, dst) pair set) in first-seen order, so a single-phase
    schedule keeps its own plan's ops."""
    plans = tuple(plans)
    if not plans:
        raise ValueError("compile_union_wire needs at least one phase plan")
    m = plans[0].num_nodes
    if any(p.num_nodes != m for p in plans):
        raise ValueError("all phase plans must share num_nodes")

    ops: list[tuple[str, object]] = []
    senders: list[np.ndarray] = []
    index: dict = {}
    phase_ops: list[list[int]] = []
    for plan in plans:
        idxs = []
        for op, snd in zip(plan.exchange_ops(), plan.sender_maps()):
            key = (op[0], op[1] if op[0] == "shift" else tuple(op[1]))
            if key not in index:
                index[key] = len(ops)
                ops.append(op)
                senders.append(np.asarray(snd, np.int64))
            idxs.append(index[key])
        phase_ops.append(idxs)

    period, n = len(plans), len(ops)
    w_bank = np.zeros((period, n, m), np.float32)
    self_bank = np.zeros((period, m), np.float32)
    active = np.zeros((period, n, m), np.float32)
    for p, plan in enumerate(plans):
        w_full = plan.mixing_matrix()
        self_bank[p] = np.diag(w_full).astype(np.float32)
        for k in phase_ops[p]:
            snd = senders[k]
            i = np.nonzero(snd >= 0)[0]
            active[p, k, i] = 1.0
            w_bank[p, k, i] = w_full[i, snd[i]].astype(np.float32)
    return UnionWirePlan(name or "+".join(p.name for p in plans), m, period, tuple(ops),
                         tuple(senders), w_bank, self_bank, active)


def init_neighbor_cache(theta_hat: Any, n_ops: int) -> tuple:
    """A fresh NeighborCache: one zero mirror of ``theta_hat`` per union op
    -- exact at init, since ``theta_hat`` starts at zero, and kept exact by
    applying each received hat-delta with the sender's own arithmetic.  A
    multi-lane round gives every lane its own cache (and fault state)."""
    return tuple(tree_map(torch.zeros_like, theta_hat) for _ in range(n_ops))
