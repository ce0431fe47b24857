"""CHOCO-GOSSIP compressed consensus (Koloskova et al. 2019) on stacked node
axes: the static rolled path of ``repro.core.gossip`` in PyTorch.

All state is stored *stacked*: every tree leaf has a leading node axis of
size m, and circulant topologies mix with ``sum_k w_k * roll(x, shift_k)``
along it.  The memory-efficient CHOCO scheme (paper Algorithm 1) keeps two
extra variables per node, the public copy ``theta_hat_i`` and the neighbour
tracker ``s_i``.  One round:

    theta_i   <- theta_half_i + gamma * (s_i - theta_hat_i)      # averaging
    q_i       <- Q(theta_i - theta_hat_i)                        # compress
    theta_hat <- theta_hat + q_i
    s_i       <- s_i + sum_j w_ij q_j                            # the wire

``packed=True`` mixes the *encoded payload* (rolled packed ints, top-k
values and indices, or block top-k's masked residual, decoded per
neighbour); ``packed=False`` decodes first; ``fused=True`` runs the two
single-pass CUDA kernels (``kernels/choco_fused.py``).

Unlike the reference, whose arrays are immutable, :func:`choco_round`
updates ``theta_half``, ``state.theta_hat`` and ``state.s`` **in place**,
chunk by chunk: at full width a second copy of the three trees does not fit
on the card.  Large leaves are gossiped in the reference's ``_scan_plan``
chunks, which also set the quantization norms (one per node and chunk).

Randomness: the uniform noise of each encode is drawn per leaf and chunk, in
leaf order, from the caller's ``torch.Generator``; or ``noise(leaf_index,
chunk_index, shape)`` supplies it (``chunk_index`` is None for an unchunked
leaf), which is how the tests feed the reference's key stream.  The packed
and fused paths draw the same shapes at the same points, so from one seed
their payloads are equal.

Time-varying rounds (``mixing=`` a dense [m, m] W(t), ``mask=`` a 0/1
participation vector) run the reference's memory-full form
(:func:`_round_leaf_masked`): the averaging step reads W(t) theta_hat
afresh, dropped nodes skip it, send q = 0 and keep their theta_hat, and
only alive nodes' s moves.  Such a round bypasses the packed / fused
dispatch (its wire changes every round); ``fused=True`` with it raises.
:func:`choco_round_lanes` runs several variables over one round (gradient
tracking's model and tracker lanes), lane after lane on one generator.

Faults and the ``ppermute`` backend are not yet ported (see ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core.compression import Compressor, Identity
from repro_torch.core.topology import Topology, masked_metropolis
from repro_torch.kernels.choco_fused import dtype_scalar
from repro_torch.tree import leaves as tree_leaves
from repro_torch.tree import tree_map

__all__ = [
    "BLOCK_SCAN_ELEMS",
    "CHOCOState",
    "LaneRound",
    "choco_init",
    "choco_round",
    "choco_round_lanes",
    "mix_stacked",
    "mix_stacked_with",
    "payload_bits",
    "payload_total_bits",
]

# leaves with more inner elements than this are gossiped in chunks (see
# _scan_plan): per-chunk transients, and per-(node, chunk) quantization norms
BLOCK_SCAN_ELEMS = 1 << 24

Noise = Callable[[int, "int | None", tuple], torch.Tensor]


@dataclasses.dataclass
class CHOCOState:
    theta_hat: Any  # tree, leaves [m, ...]
    s: Any  # tree, leaves [m, ...]


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not yet ported to repro_torch; see ROADMAP.md")


def choco_init(theta_stacked) -> CHOCOState:
    """Fresh CHOCO trackers (zeros shaped like the stacked model)."""
    return CHOCOState(theta_hat=tree_map(torch.zeros_like, theta_stacked),
                      s=tree_map(torch.zeros_like, theta_stacked))


def _mix_leaf(x: torch.Tensor, topology: Topology) -> torch.Tensor:
    """sum_j w_ij x_j along the leading node axis."""
    if topology.shifts is not None:
        out = torch.zeros_like(x)
        for shift, weight in topology.shifts:
            term = x if shift == 0 else torch.roll(x, shift, 0)
            out = out + weight * term
        return out
    wdt = x.dtype if x.is_floating_point() else torch.float32
    w = torch.as_tensor(topology.mixing, dtype=wdt, device=x.device)
    flat = x.reshape(x.shape[0], -1).to(wdt)
    return (w @ flat).reshape(x.shape).to(x.dtype)


def mix_stacked(tree, topology: Topology):
    """Gossip-average a stacked tree: leaf[i] <- sum_j w_ij leaf[j]."""
    return tree_map(lambda x: _mix_leaf(x, topology), tree)


def _mix_leaf_dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """sum_j w_ij x_j with an explicit [m, m] matrix, in f32."""
    flat = x.reshape(x.shape[0], -1).float()
    w = w.to(device=x.device, dtype=torch.float32)
    return (w @ flat).reshape(x.shape).to(x.dtype)


def mix_stacked_with(tree, w: torch.Tensor):
    """Gossip-average a stacked tree with an explicit dense [m, m] matrix
    (a round's W(t))."""
    return tree_map(lambda x: _mix_leaf_dense(x, w), tree)


def _roll_payload(payload, shift: int):
    """Roll every tensor of a payload (a dict of tensors, or one tensor such
    as block top-k's dense masked residual) along the node axis."""
    if shift == 0:
        return payload
    return tree_map(lambda v: torch.roll(v, shift, 0), payload)


def _mix_payload(compressor, payload, shape, dtype, topology: Topology):
    """sum_j w_ij decode(q_j) -- rolling the *packed* payload."""
    out = None
    for shift, weight in topology.shifts:
        deq = compressor.decode(_roll_payload(payload, shift), shape, dtype)
        out = weight * deq if out is None else out + weight * deq
    return out


def _scan_plan(shape, inner_elems: int, block_scan_elems: int):
    """How to gossip a large stacked leaf [m, ...] in chunks.

    Returns (axis, chunks, rows) or None (whole-leaf):
      * layer-stack leaves (axis-1 size <= 128, e.g. [m, nb_layers, ...]):
        chunk axis 1;
      * otherwise (e.g. embeddings [m, V, d]): split the LAST axis.
    """
    if len(shape) <= 1 or inner_elems <= block_scan_elems:
        return None
    nb = shape[1] if len(shape) > 2 else 1
    if 1 < nb <= 128:
        per_row = inner_elems // nb
        target_rows = max(1, block_scan_elems // max(per_row, 1))
        rows = 1
        for r in range(min(target_rows, nb), 0, -1):
            if nb % r == 0:
                rows = r
                break
        chunks = nb // rows
        if 1 < chunks <= 512:
            return (1, chunks, rows)
        return None
    last = shape[-1]
    want = max(2, -(-inner_elems // block_scan_elems))  # ceil
    for c in range(min(want, last), min(513, last + 1)):
        if last % c == 0:
            return (len(shape) - 1, c, last // c)
    return None


def _chunk_views(x: torch.Tensor, plan):
    """The plan's chunks of ``x`` as views (each [m, ...] without the chunk
    axis), in the reference's scan order."""
    axis, chunks, rows = plan
    if axis == 1:
        return [x.narrow(1, c * rows, rows) for c in range(chunks)]
    split = x.reshape(x.shape[:-1] + (chunks, rows))
    return [split.select(-2, c) for c in range(chunks)]


def _round_leaf_masked(leaf, hat, s, xi, mixing, gamma, compressor, alive):
    """One time-varying CHOCO round for a stacked leaf [m, ...] (the
    memory-full form): W(t) theta_hat is mixed afresh, so s, which only a
    static W keeps equal to it, is maintained for alive nodes but not read.
    ``alive`` is the [m] f32 participation mask on the leaf's device."""
    m = leaf.shape[0]
    inner_shape, dtype = tuple(leaf.shape[1:]), leaf.dtype
    ab = alive.reshape((m,) + (1,) * (leaf.ndim - 1))
    hat32 = hat.float()
    s_cur = _mix_leaf_dense(hat32, mixing)  # sum_j w_ij(t) hat_j
    theta_new = leaf + (ab * gamma).to(dtype) * (s_cur - hat32).to(dtype)
    resid = (theta_new - hat).float() * ab
    if isinstance(compressor, Identity):
        q_self = resid
    else:
        payload = compressor.encode(resid, xi)
        # a zero residual codes to exactly zero; the product makes "dropped
        # nodes send nothing" hold for any compressor
        q_self = compressor.decode(payload, inner_shape, torch.float32) * ab
    hat_new = (hat32 + q_self).to(hat.dtype)
    s_post = s_cur + _mix_leaf_dense(q_self, mixing)  # sum_j w_ij(t) hat_j(t)
    s_new = (ab * s_post + (1.0 - ab) * s.float()).to(s.dtype)
    return theta_new, hat_new, s_new


def _round_leaf(leaf, hat, s, xi, topology, gamma, compressor, use_packed, use_fused=False):
    """One CHOCO round for a single stacked leaf [m, ...]; returns new
    (theta, hat, s) tensors."""
    if use_fused:
        return compressor.fused_round(leaf, hat, s, xi, topology, gamma)
    inner_shape, dtype = tuple(leaf.shape[1:]), leaf.dtype
    # averaging step (uses the *old* public variables), in the leaf dtype
    theta_new = leaf + (s - hat) * dtype_scalar(gamma, dtype)
    resid = (theta_new - hat).float()
    if isinstance(compressor, Identity):
        q_self = resid
        mixed = _mix_leaf(q_self, topology)
    else:
        payload = compressor.encode(resid, xi)
        q_self = compressor.decode(payload, inner_shape, torch.float32)
        if use_packed:
            mixed = _mix_payload(compressor, payload, inner_shape, torch.float32, topology)
        else:
            mixed = _mix_leaf(q_self, topology)
    hat_new = (hat.float() + q_self).to(hat.dtype)
    s_new = (s.float() + mixed).to(s.dtype)
    return theta_new, hat_new, s_new


def _round_leaves(leaves, hat_leaves, s_leaves, draw, round_one, block_scan_elems: int):
    """Apply ``round_one(leaf, hat, s, xi)`` to every stacked leaf, in place,
    chunking large leaves per ``_scan_plan``.  ``draw(leaf_index,
    chunk_index, inner_shape)`` gives each encode's noise."""
    for li, (leaf, hat, s) in enumerate(zip(leaves, hat_leaves, s_leaves)):
        inner_elems = int(np.prod(leaf.shape[1:])) if leaf.ndim > 1 else 1
        plan = _scan_plan(tuple(leaf.shape), inner_elems, block_scan_elems)
        if plan is None:
            parts = [(None, leaf, hat, s)]
        else:
            parts = zip(range(plan[1]), *(_chunk_views(x, plan) for x in (leaf, hat, s)))
        for ci, lc, hc, sc in parts:
            xi = draw(li, ci, tuple(lc.shape[1:]))
            out = round_one(lc.contiguous(), hc.contiguous(), sc.contiguous(), xi)
            for dst, src in zip((lc, hc, sc), out):
                dst.copy_(src)


def check_fused(topology: Topology, compressor: Compressor) -> None:
    """The fused round needs a kernel compressor and a circulant topology;
    the reference falls back silently elsewhere, the port raises."""
    if topology.shifts is None or not getattr(compressor, "supports_fused_round", False):
        raise ValueError(
            f"fused gossip needs a kernel compressor (kq1b/kq2b/kq4b/kq8b) and a "
            f"circulant topology; got {type(compressor).__name__} on {topology.name!r}"
        )


def choco_round(theta_half, state: CHOCOState, topology: Topology, gamma: float,
                compressor: Compressor, *, generator: torch.Generator | None = None,
                noise: Noise | None = None, packed: bool = True, fused: bool = False,
                block_scan_elems: int = BLOCK_SCAN_ELEMS, mixing=None, mask=None,
                backend: str = "rolled"):
    """One compressed-consensus round over all leaves of a stacked tree.

    Returns (theta_new, state_new): the input trees, updated in place.
    ``generator`` draws the quantization noise (on the leaves' device)
    unless ``noise`` supplies it.
    """
    if backend != "rolled":
        raise _not_ported(f"gossip backend {backend!r}")
    time_varying = mixing is not None or mask is not None
    if fused and time_varying:
        raise ValueError("fused gossip runs a static circulant round; a time-varying or "
                         "masked round (mixing= / mask=) takes the masked path: "
                         "pass fused=False")
    if fused:
        check_fused(topology, compressor)
    leaves = tree_leaves(theta_half)
    hat_leaves = tree_leaves(state.theta_hat)
    s_leaves = tree_leaves(state.s)
    if not all(x.is_contiguous() for x in leaves + hat_leaves + s_leaves):
        raise ValueError("choco_round updates its trees in place: pass contiguous leaves")
    use_packed = packed and topology.shifts is not None and not isinstance(compressor, Identity)
    m = leaves[0].shape[0]
    if time_varying:
        if mixing is None:  # a mask alone: Metropolis on the static graph's survivors
            mixing = masked_metropolis(topology.adjacency, mask)
        dev = leaves[0].device
        mixing = torch.as_tensor(mixing, dtype=torch.float32).to(dev)
        alive = (torch.ones(m, dtype=torch.float32, device=dev) if mask is None
                 else torch.as_tensor(mask, dtype=torch.float32).to(dev))

    def draw(li, ci, inner_shape):
        shape = compressor.noise_shape(m, inner_shape)
        if shape is None:
            return None
        if noise is not None:
            xi = noise(li, ci, shape)
            if tuple(xi.shape) != tuple(shape):
                raise ValueError(f"noise for leaf {li} chunk {ci}: want {shape}, "
                                 f"got {tuple(xi.shape)}")
            return xi.to(device=leaves[li].device, dtype=torch.float32)
        if generator is None:
            raise ValueError(f"{type(compressor).__name__} needs a generator or noise=")
        return torch.rand(shape, generator=generator, device=leaves[li].device,
                          dtype=torch.float32)

    def round_one(leaf, hat, s, xi):
        if time_varying:
            return _round_leaf_masked(leaf, hat, s, xi, mixing, gamma, compressor, alive)
        return _round_leaf(leaf, hat, s, xi, topology, gamma, compressor, use_packed, fused)

    _round_leaves(leaves, hat_leaves, s_leaves, draw, round_one, block_scan_elems)
    return theta_half, state


class LaneRound(NamedTuple):
    """One lane of a multi-lane round: the variable to gossip, its CHOCO
    trackers, and the lane's step size and compressor.  Lane 0 is the
    model lane."""

    theta: Any  # tree, leaves [m, ...]
    state: CHOCOState
    gamma: float
    compressor: Compressor


def choco_round_lanes(lanes, topology: Topology, generator: torch.Generator | None = None, *,
                      noises=None, packed: bool = True, fused: bool = False,
                      block_scan_elems: int = BLOCK_SCAN_ELEMS, mixing=None, mask=None,
                      backend: str = "rolled"):
    """One multi-lane round on the rolled wire: each :class:`LaneRound`
    runs :func:`choco_round` over the same topology / W(t) / mask.  The
    reference folds lane k > 0's key out of the round key; here every lane
    draws from ``generator``, lane after lane (lane 0 first, so one lane is
    the single-lane wire), and ``noises[k]`` injects lane k's noise instead.
    Returns ``(thetas, states)``, one entry per lane (updated in place, as
    :func:`choco_round`)."""
    lanes = tuple(LaneRound(*lane) for lane in lanes)
    if not lanes:
        raise ValueError("choco_round_lanes needs at least one lane")
    outs = [choco_round(lane.theta, lane.state, topology, lane.gamma, lane.compressor,
                        generator=generator,
                        noise=None if noises is None else noises[k], packed=packed,
                        fused=fused, block_scan_elems=block_scan_elems, mixing=mixing,
                        mask=mask, backend=backend)
            for k, lane in enumerate(lanes)]
    return tuple(o[0] for o in outs), tuple(o[1] for o in outs)


def payload_total_bits(compressor: Compressor, theta_template) -> float:
    """Per-neighbor payload bits of one full model message; template leaves
    are stacked [m, ...] (anything with a ``.shape``, meta tensors too)."""
    total = 0.0
    for leaf in tree_leaves(theta_template):
        d = int(np.prod(leaf.shape[1:]))
        total += compressor.bits_per_element(d) * d
    return total


def payload_bits(compressor: Compressor, theta_template, topology, *, mode: str = "max",
                 step: int | None = None, mask=None, degree: float | None = None) -> float:
    """Bits sent per round by the busiest node: degree x payload.

    ``topology`` is a :class:`Topology` or a ``TopologySchedule``;
    ``degree`` overrides its degree.  ``mode``: ``"max"`` (the busiest
    phase, everyone alive), ``"expected"`` (phase-averaged, times the
    probability that both ends of a link survive) or ``"realized"`` (round
    ``step``'s links under ``mask``)."""
    if mode not in ("max", "expected", "realized"):
        raise ValueError(f"unknown bits mode {mode!r}; choose max/expected/realized")
    total = payload_total_bits(compressor, theta_template)
    if degree is not None:
        return total * degree
    if mode == "max":
        degree = topology.max_degree
    elif mode == "expected":
        degree = topology.expected_degree
    else:
        if mask is None:
            raise ValueError("mode='realized' needs the round's participation mask")
        degree = topology.realized_degree(0 if step is None else step, mask)
    return total * degree
