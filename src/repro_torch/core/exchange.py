"""The cached union-wire round and the faulted wire in one process (the
one-process half of ``repro.core.exchange``).

A round runs against the NeighborCache (``core/wire.py``): each receiver
keeps one mirror of each in-neighbour's ``theta_hat`` per union op, so the
memory-full averaging ``sum_j w_ij(t) theta_hat_j`` reads the mirrors and
the only model-sized traffic is the compressed hat-delta, which every
receiver mixes into ``s`` and applies to its mirror with the sender's own
arithmetic -- every mirror stays bit-identical to the sender's
``theta_hat``.

With a :class:`~repro_torch.core.faults.FaultSpec` the wire is faulted: a
round's events drop, garble, duplicate or delay each (op, receiver)
message; the sender's per-chunk digest of its post-round ``theta_hat``
rides every message and the receiver verifies ``digest(mirror + delta)``
before it commits; a mirror stale past S leaves the mix (its weight goes to
the surviving edges) and asks for a dense resync, which rides the same
faulty wire with exponential backoff (``core/faults.py``).

The whole node axis is one block here: an op's exchange is a roll
(``("shift", s)``) or a gather by its sender map (``("perm", pairs)``,
zeros where a node receives nothing).  Decoding commutes with that
exchange bit for bit, so a payload is decoded once by its sender and the
decoded delta is gathered per op.  The multi-process ``torch.distributed``
form of this wire is not yet ported (see ROADMAP.md).

Like :func:`~repro_torch.core.gossip.choco_round`, the round updates
theta, ``theta_hat``, ``s`` and the mirrors in place, chunk by chunk in the
reference's ``_scan_plan`` chunks; every read of a chunk comes before its
writes.  The fault state is small: its bookkeeping runs on the CPU once per
round, and only the per-chunk verdicts stay on the leaves' device.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.compression import Compressor, Identity
from repro_torch.core.faults import (
    FaultEvents,
    FaultState,
    digest,
    garble,
    receiver_maps,
    sample_events,
    update_fault_state,
)
from repro_torch.core.gossip import (
    BLOCK_SCAN_ELEMS,
    CHOCOState,
    LaneRound,
    _chunk_views,
    _scan_plan,
    noise_draw,
    payload_total_bits,
)
from repro_torch.core.topology import compile_permute_plan, compile_schedule_plans
from repro_torch.core.wire import UnionWirePlan, compile_union_wire
from repro_torch.tree import leaves as tree_leaves
from repro_torch.tree import tree_map

__all__ = [
    "choco_round_cached_local",
    "choco_round_cached_local_lanes",
    "mix_stacked_faulted_local",
    "resolve_union",
    "wire_msg_bits",
]


def resolve_union(union=None, schedule=None, topology=None) -> UnionWirePlan:
    """``union`` if given, else the union wire of ``schedule``'s phases or of
    ``topology`` alone."""
    if union is not None:
        return union
    if schedule is not None:
        return compile_union_wire(compile_schedule_plans(schedule), name=schedule.name)
    if topology is None:
        raise ValueError("the union wire needs a topology or a schedule")
    return compile_union_wire((compile_permute_plan(topology),))


# ------------------------------------------------------------- the exchange
def _sender_map(op, m: int) -> np.ndarray:
    kind, arg = op
    if kind == "shift":
        return (np.arange(m) - arg) % m
    snd = np.full((m,), -1, np.int64)
    for src, dst in arg:
        snd[dst] = src
    return snd


def _recv(x: torch.Tensor, op) -> torch.Tensor:
    """The value each node receives on one op: ``out[i] = x[senders[i]]``
    (zeros where node ``i`` receives nothing)."""
    kind, arg = op
    if kind == "shift":
        return torch.roll(x, int(arg), 0)
    snd = _sender_map(op, x.shape[0])
    out = x.index_select(0, torch.as_tensor(np.clip(snd, 0, None), device=x.device))
    none = np.nonzero(snd < 0)[0]
    if none.size:
        out.index_fill_(0, torch.as_tensor(none, device=x.device), 0)
    return out


def _inv_op(op):
    """The reverse exchange of a union op: moves a receiver's value to its
    sender (the resync request travels it)."""
    kind, arg = op
    if kind == "shift":
        return (kind, -arg)
    return (kind, tuple((d, s) for (s, d) in arg))


def _bcast(w: torch.Tensor, ndim: int) -> torch.Tensor:
    """[m] per-node values broadcast against an [m, ...] tensor."""
    return w.reshape((w.shape[0],) + (1,) * (ndim - 1))


def _union_round_weights(union: UnionWirePlan, phase: int, alive: torch.Tensor, masked: bool,
                         usable: torch.Tensor | None = None):
    """The round's wire weights, resolved once per round (f32, on
    ``alive``'s device): ``(self_w [m], ws [n_ops] of [m], alive_nb or
    None)``.  Unmasked, unfaulted rounds read the phase banks; otherwise
    the masked-Metropolis weights are recomputed from the participation
    bits the ops carry, on the phase's active edges (times ``usable``, the
    edges whose mirrors are fresh enough to mix).  Under asymmetric faults
    W(t) is row- and not column-stochastic, as in the reference."""
    dev = alive.device
    bank = lambda a: torch.as_tensor(a[phase], dtype=torch.float32, device=dev)
    if not masked and usable is None:
        wb = bank(union.w_bank)
        return bank(union.self_bank), [wb[k] for k in range(union.n_ops)], None
    act = bank(union.active)
    if usable is not None:
        act = act * usable
    alive_nb = [_recv(alive, op) for op in union.ops]
    deg = torch.zeros_like(alive)
    for k, nb in enumerate(alive_nb):
        deg = deg + act[k] * alive * nb
    deg_nb = [_recv(deg, op) for op in union.ops]
    ws = [act[k] * alive * nb / (1.0 + torch.maximum(deg, dnb))
          for k, (nb, dnb) in enumerate(zip(alive_nb, deg_nb))]
    self_w = torch.ones_like(alive)
    for w in ws:
        self_w = self_w - w
    return self_w, ws, alive_nb


def _weighted_mix(x: torch.Tensor, self_w, ws, ops) -> torch.Tensor:
    """``sum_j w_ij(t) x_j`` in f32 with the round's per-op weights."""
    xf = x.float()
    out = _bcast(self_w, x.ndim) * xf
    for op, w in zip(ops, ws):
        out = out + _bcast(w, x.ndim) * _recv(xf, op)
    return out


# ----------------------------------------------------------- faulted wire
def wire_msg_bits(compressor: Compressor, theta_template,
                  block_scan_elems: int = BLOCK_SCAN_ELEMS) -> tuple[float, float, float]:
    """Per-message bit sizes on a faulted wire, ``(payload, digest,
    dense)``: one compressed hat-delta of the whole tree, 32 bits per leaf
    chunk (``_scan_plan``'s chunks, as the digests are computed), and the
    whole hat at its dtype (a resync)."""
    payload = payload_total_bits(compressor, theta_template)
    dense = dig = 0.0
    for leaf in tree_leaves(theta_template):
        shape = tuple(leaf.shape)
        d = int(np.prod(shape[1:])) if len(shape) > 1 else 1
        dense += float(d) * leaf.element_size() * 8.0
        plan = _scan_plan(shape, d, block_scan_elems)
        dig += 32.0 * (plan[1] if plan is not None else 1)
    return payload, dig, dense


class _FaultCtx(NamedTuple):
    """One round's resolved fault picture, [n_ops, m] receiver-side gates
    (CPU) and the [m] sender-side bits meter."""

    arrived: torch.Tensor  # bool: the message landed this round
    corrupt: torch.Tensor  # bool: it landed garbled
    want: torch.Tensor  # bool: the receiver requests a dense resync
    bits: torch.Tensor  # f32: wire bits each node's sends realize


def _fault_context(faults, ev: FaultEvents, union: UnionWirePlan, fs: FaultState,
                   alive: torch.Tensor, alive_nb, msg_bits) -> _FaultCtx:
    """Resolve the round's events (CPU) into receiver gates and sender
    billing.  A slot with no sender, or a dead one, carries no message: it
    counts as arrived, so its edge never ages.  Delivered bits go to the
    sender: drops bill 0, dups 2x, corrupt and late messages 1x; the resync
    request travels the reverse op and adds the dense hat to the message."""
    exist = torch.as_tensor(np.stack([np.asarray(s) >= 0 for s in union.senders]))
    live = exist
    if alive_nb is not None:
        live = live & (torch.stack(alive_nb) > 0.0)
    arrived = torch.where(live, ~(ev.drop | ev.delay), torch.ones_like(live))
    corrupt = ev.corrupt & live
    want = live & (fs.stale.T > faults.stale) & (fs.wait.T <= 0)
    payload_b, digest_b, dense_b = msg_bits
    mult = torch.where(ev.drop, 0.0, torch.where(ev.dup, 2.0, 1.0)).to(torch.float32)
    bits = torch.zeros(alive.shape, dtype=torch.float32)
    for k, (op, rcv) in enumerate(zip(union.ops, receiver_maps(union))):
        rcv_t = torch.as_tensor(rcv)
        mult_k = torch.where(rcv_t >= 0, mult[k][torch.clamp(rcv_t, min=0)], 0.0)
        want_sent = _recv(want[k].to(torch.float32), _inv_op(op))
        bits = bits + mult_k * ((payload_b + digest_b) + want_sent * dense_b)
    return _FaultCtx(arrived, corrupt, want, bits * alive)


def _as_events(faults, ev, n_ops: int, m: int) -> FaultEvents:
    if ev is None:
        raise ValueError("faulted rounds need the round's events (or its uniform draw "
                         "[n_ops, m]): the trainer draws them from its fault generator")
    if isinstance(ev, FaultEvents):
        return FaultEvents(*(torch.as_tensor(x).cpu() for x in ev))
    ev = sample_events(faults, ev.cpu() if isinstance(ev, torch.Tensor)
                       else torch.from_numpy(np.array(ev, np.float32)))
    if tuple(ev.drop.shape) != (n_ops, m):
        raise ValueError(f"fault draw must be [{n_ops}, {m}], got {tuple(ev.drop.shape)}")
    return ev


# ------------------------------------------------------------- leaf round
def _round_leaf_cached(leaf, hat, s, xi, caches, union, weights, gamma, compressor, alive,
                       masked: bool, use_fused: bool, gates=None):
    """One cached round of a stacked chunk [m, ...] (the reference's
    ``_round_leaf_cached``).  ``caches`` are the chunk's mirrors, one per
    op; ``gates`` (faulted wire) the round's device-side ``(arrived,
    corrupt, want)`` and the host's per-op ``(any corrupt, any want)``.
    Returns new (theta, hat, s, mirrors), plus the [2, n_ops, m] (delta ok,
    resync ok) verdict of the chunk under faults."""
    self_w, ws, alive_nb = weights
    inner_shape, dtype, nd = tuple(leaf.shape[1:]), leaf.dtype, leaf.ndim
    hat32 = hat.float()
    ab = _bcast(alive, nd)
    # averaging from the cached neighbour hats: nothing on the wire
    s_cur = _bcast(self_w, nd) * hat32
    for w, c in zip(ws, caches):
        s_cur = s_cur + _bcast(w, nd) * c.float()
    theta_new = leaf + (ab * gamma).to(dtype) * (s_cur - hat32).to(dtype)
    hat_new = dig_self = None
    if isinstance(compressor, Identity):
        q_self = (theta_new - hat).float() * ab
    elif use_fused:
        # one pass: levels, signs, theta_hat and its digest (no mask here)
        payload, hat_new, dig_self = compressor.fused_encode(theta_new, hat, xi)
        q_self = compressor.decode(payload, inner_shape, torch.float32)
    else:
        payload = compressor.encode((theta_new - hat).float() * ab, xi)
        q_self = compressor.decode(payload, inner_shape, torch.float32) * ab
    if hat_new is None:
        hat_new = (hat32 + q_self).to(hat.dtype)
    if gates is not None and dig_self is None:
        dig_self = digest(hat_new)
    mix_q = _bcast(self_w, nd) * q_self
    new_caches, d_oks, r_oks = [], [], []
    for k, op in enumerate(union.ops):
        q_r = _recv(q_self, op)
        if masked:
            q_r = q_r * _bcast(alive_nb[k], nd)
        if gates is None:
            new_caches.append((caches[k].float() + q_r).to(caches[k].dtype))
            mix_q = mix_q + _bcast(ws[k], nd) * q_r
            continue
        (arrived, corrupt, want), (any_corrupt, any_want) = gates
        cb = _bcast(corrupt[k], nd)
        if any_corrupt[k]:
            q_r = torch.where(cb, garble(q_r), q_r)
        cand = (caches[k].float() + q_r).to(caches[k].dtype)
        dig_nb = _recv(dig_self, op)
        ok_d = arrived[k] & (digest(cand) == dig_nb)
        okd_b = _bcast(ok_d, nd)
        if any_want[k]:  # the dense resync rides only requested edges
            hat_recv = _recv(hat_new, op)
            if any_corrupt[k]:
                hat_recv = torch.where(cb, garble(hat_recv), hat_recv)
            ok_r = want[k] & arrived[k] & (digest(hat_recv) == dig_nb)
            new_caches.append(torch.where(_bcast(ok_r, nd), hat_recv,
                                          torch.where(okd_b, cand, caches[k])))
        else:
            ok_r = torch.zeros_like(ok_d)
            new_caches.append(torch.where(okd_b, cand, caches[k]))
        # only committed deltas enter s (a where: a garbled delta may hold NaNs)
        mix_q = mix_q + _bcast(ws[k], nd) * torch.where(okd_b, q_r, 0.0)
        d_oks.append(ok_d)
        r_oks.append(ok_r)
    s_post = s_cur + mix_q
    s_new = (ab * s_post + (1.0 - ab) * s.float()).to(s.dtype)
    if gates is None:
        return theta_new, hat_new, s_new, new_caches, None
    return theta_new, hat_new, s_new, new_caches, (torch.stack(d_oks), torch.stack(r_oks))


# ------------------------------------------------------------------ rounds
def _cached_round_body(theta, st: CHOCOState, draw, alive, step: int, events, *, union,
                       gamma, compressor, use_fused, masked, faults, msg_bits,
                       block_scan_elems):
    """One cached union-wire round of one lane, in place (the reference's
    ``_cached_round_body`` with the whole node axis as one block)."""
    lv, hv, sv = (tree_leaves(t) for t in (theta, st.theta_hat, st.s))
    cache_lv = [tree_leaves(c) for c in st.cache]
    m, dev = lv[0].shape[0], lv[0].device
    if not all(x.is_contiguous() for x in lv + hv + sv + [c for cl in cache_lv for c in cl]):
        raise ValueError("the cached round updates its trees in place: pass contiguous leaves")
    alive_host = (torch.ones(m, dtype=torch.float32) if alive is None
                  else torch.as_tensor(alive, dtype=torch.float32).cpu())
    phase = 0 if union.period == 1 else int(step) % union.period
    fs_host, usable = None, None
    if faults is not None:
        fs_host = FaultState(*(x.cpu() for x in st.fault))
        # an edge stale past S leaves the mix until a resync lands
        usable = (fs_host.stale.T <= faults.stale).to(torch.float32)
    w_host = _union_round_weights(union, phase, alive_host, masked, usable)
    fctx, gates = None, None
    if faults is not None:
        fctx = _fault_context(faults, events, union, fs_host, alive_host, w_host[2], msg_bits)
        gates = (tuple(x.to(dev) for x in (fctx.arrived, fctx.corrupt, fctx.want)),
                 (fctx.corrupt.any(1).tolist(), fctx.want.any(1).tolist()))
    self_w, ws, alive_nb = w_host
    weights = (self_w.to(dev), [w.to(dev) for w in ws],
               None if alive_nb is None else [a.to(dev) for a in alive_nb])
    alive_dev = alive_host.to(dev)
    ok = [torch.ones((union.n_ops, m), dtype=torch.bool, device=dev) for _ in range(2)]

    for li, (leaf, hat, s) in enumerate(zip(lv, hv, sv)):
        mirrors = [cl[li] for cl in cache_lv]
        inner_elems = int(np.prod(leaf.shape[1:])) if leaf.ndim > 1 else 1
        plan = _scan_plan(tuple(leaf.shape), inner_elems, block_scan_elems)
        if plan is None:
            parts = [(None, [leaf, hat, s] + mirrors)]
        else:
            views = [_chunk_views(x, plan) for x in [leaf, hat, s] + mirrors]
            parts = [(ci, [v[ci] for v in views]) for ci in range(plan[1])]
        for ci, chunk in parts:
            xi = draw(li, ci, tuple(chunk[0].shape[1:]))
            lc, hc, sc, *mc = (x.contiguous() for x in chunk)
            t_new, h_new, s_new, m_new, verdict = _round_leaf_cached(
                lc, hc, sc, xi, mc, union, weights, gamma, compressor, alive_dev, masked,
                use_fused, gates)
            # every read of the chunk is done: write theta, hat, s, mirrors
            for dst, src in zip(chunk, [t_new, h_new, s_new] + m_new):
                dst.copy_(src)
            if verdict is not None:
                ok[0] &= verdict[0]
                ok[1] &= verdict[1]
    fault_new = st.fault
    if faults is not None:
        fs_new = update_fault_state(fs_host, ok[0].cpu(), ok[1].cpu(), fctx.want, faults,
                                    fctx.bits)
        fault_new = FaultState(*(x.to(dev) for x in fs_new))
    return theta, CHOCOState(theta_hat=st.theta_hat, s=st.s, cache=st.cache, fault=fault_new)


def _check_state(state: CHOCOState, union: UnionWirePlan, faults, lane: int) -> None:
    if len(state.cache) != union.n_ops:
        raise ValueError(
            f"cached union-wire rounds keep a NeighborCache (one theta_hat mirror per union "
            f"op; lane {lane} needs {union.n_ops}, has {len(state.cache)}): initialize the "
            f"state with gossip.choco_init(theta, cache_ops=n) or the consensus's init")
    if faults is not None and (not isinstance(state.fault, FaultState)
                               or state.fault.stale.shape[-1] != union.n_ops):
        raise ValueError(
            f"faulted rounds keep a per-edge FaultState in CHOCOState.fault (one for "
            f"{union.n_ops} union ops): initialize the state with gossip.choco_init(theta, "
            f"cache_ops=n, fault_ops=n) or the consensus's init")


def choco_round_cached_local_lanes(lanes, *, generator: torch.Generator | None = None,
                                   noises=None, union=None, fused: bool = False,
                                   block_scan_elems: int = BLOCK_SCAN_ELEMS, schedule=None,
                                   topology=None, step: int = 0, mask=None, faults=None,
                                   events=None):
    """The multi-lane cached union-wire round in one process.  Each lane
    keeps its own mirrors and (under faults) its own fault state and events:
    ``events[k]`` is lane k's :class:`~repro_torch.core.faults.FaultEvents`
    or its uniform draw [n_ops, m] (the reference folds the round's fault
    key per lane).  The lanes draw their quantization noise from
    ``generator`` lane after lane, or ``noises[k]`` supplies it.  ``fused``
    runs the encode on the fused kernel with its digest (a kernel
    compressor, no mask).  Returns ``(thetas, states)``, the trees updated
    in place."""
    lanes = tuple(LaneRound(*lane) for lane in lanes)
    if not lanes:
        raise ValueError("choco_round_cached_local_lanes needs at least one lane")
    union = resolve_union(union, schedule, topology)
    masked = mask is not None
    if fused and masked:
        raise ValueError("the fused encode has no participation mask (a dead node's residual "
                         "must be zero): a masked faulted round takes the packed path")
    m = tree_leaves(lanes[0].theta)[0].shape[0]
    outs_t, outs_s = [], []
    for k, lane in enumerate(lanes):
        _check_state(lane.state, union, faults, k)
        use_fused = fused and not isinstance(lane.compressor, Identity)
        if use_fused and not getattr(lane.compressor, "supports_fused_round", False):
            raise ValueError(f"fused gossip needs a kernel compressor (kq1b/kq2b/kq4b/kq8b); "
                             f"got {type(lane.compressor).__name__}")
        ev = None
        if faults is not None:
            if events is None or len(events) != len(lanes):
                raise ValueError("faulted rounds take one events entry per lane")
            ev = _as_events(faults, events[k], union.n_ops, m)
        leaves = tree_leaves(lane.theta)
        draw = noise_draw(lane.compressor, leaves, generator,
                          None if noises is None else noises[k])
        msg_bits = (wire_msg_bits(lane.compressor, lane.theta, block_scan_elems)
                    if faults is not None else None)
        t_new, s_new = _cached_round_body(
            lane.theta, lane.state, draw, mask, step, ev, union=union, gamma=lane.gamma,
            compressor=lane.compressor, use_fused=use_fused, masked=masked, faults=faults,
            msg_bits=msg_bits, block_scan_elems=block_scan_elems)
        outs_t.append(t_new)
        outs_s.append(s_new)
    return tuple(outs_t), tuple(outs_s)


def choco_round_cached_local(theta_half, state: CHOCOState, gamma: float,
                             compressor: Compressor, *, generator=None, noise=None,
                             union=None, fused: bool = False,
                             block_scan_elems: int = BLOCK_SCAN_ELEMS, schedule=None,
                             topology=None, step: int = 0, mask=None, faults=None,
                             events=None):
    """One cached union-wire round in one process (single lane): how
    ``gossip.choco_round`` runs a faulted round.  ``events`` is the round's
    :class:`~repro_torch.core.faults.FaultEvents` or uniform draw."""
    thetas, states = choco_round_cached_local_lanes(
        (LaneRound(theta_half, state, gamma, compressor),), generator=generator,
        noises=None if noise is None else (noise,), union=union, fused=fused,
        block_scan_elems=block_scan_elems, schedule=schedule, topology=topology, step=step,
        mask=mask, faults=faults, events=None if events is None else (events,))
    return thetas[0], states[0]


# ------------------------------------------------------- memoryless faults
def _dense_msg_bits(tree) -> float:
    """Bits of one dense message (the tree at leaf dtype) plus its 32-bit
    per-leaf digest lane."""
    total = 0.0
    for leaf in tree_leaves(tree):
        d = int(np.prod(leaf.shape[1:])) if leaf.ndim > 1 else 1
        total += float(d) * leaf.element_size() * 8.0 + 32.0
    return total


def _memoryless_fault(ev: FaultEvents, union: UnionWirePlan, dense_msg: float):
    """A memoryless wire (exact consensus, the lambda gossip) has no mirror
    to heal: a dropped, garbled or late message leaves the round's mix.
    Returns ``(usable [n_ops, m] f32, bits [m] f32)`` (CPU)."""
    usable = (~(ev.drop | ev.corrupt | ev.delay)).to(torch.float32)
    mult = torch.where(ev.drop, 0.0, torch.where(ev.dup, 2.0, 1.0)).to(torch.float32)
    bits = torch.zeros(ev.drop.shape[1], dtype=torch.float32)
    for k, rcv in enumerate(receiver_maps(union)):
        rcv_t = torch.as_tensor(rcv)
        bits = bits + torch.where(rcv_t >= 0, mult[k][torch.clamp(rcv_t, min=0)], 0.0)
    return usable, bits * dense_msg


def mix_stacked_faulted_local(tree, *, union=None, topology=None, schedule=None,
                              step: int = 0, mask=None, faults, events):
    """The memoryless faulted mix of a stacked tree in one process (the
    exact wire and the lambda gossip): returns ``(mixed, bits)``, ``bits``
    the [m] per-sender delivered-bits meter (CPU)."""
    union = resolve_union(union, schedule, topology)
    leaves = tree_leaves(tree)
    m, dev = leaves[0].shape[0], leaves[0].device
    ev = _as_events(faults, events, union.n_ops, m)
    alive = (torch.ones(m, dtype=torch.float32) if mask is None
             else torch.as_tensor(mask, dtype=torch.float32).cpu())
    phase = 0 if union.period == 1 else int(step) % union.period
    usable, bits = _memoryless_fault(ev, union, _dense_msg_bits(tree))
    bits = bits * alive
    self_w, ws, _ = _union_round_weights(union, phase, alive, mask is not None, usable)
    self_w, ws = self_w.to(dev), [w.to(dev) for w in ws]
    mixed = tree_map(lambda x: _weighted_mix(x, self_w, ws, union.ops).to(x.dtype), tree)
    return mixed, bits
