"""Neighbour-exchange gossip: the cached union-wire round, the faulted wire,
and the ``ppermute`` backend on ``torch.distributed`` ranks (port of
``repro.core.exchange``).

``core/gossip.py`` simulates the network on one stacked array.  Here the
wire is explicit.  Each process (rank) of a
:class:`~repro_torch.launch.mesh.NodeMesh` holds one contiguous block of
``m / R`` nodes, and *only compressed payloads travel between graph
neighbours*, as point-to-point messages (:func:`exchange`, one
``batch_isend_irecv`` per batch):

* circulant graphs (ring / torus) run each shift as a global roll of the
  node axis, decomposed as the reference's ``_shard_roll``: a whole-block
  permute plus one boundary slab, so a ring shift of +-1 moves one node row
  per rank whatever the block;
* irregular graphs (erdos_renyi, star, matching phases) run the plan's
  edge steps as per-edge sends, with one node per rank (:func:`_check_block`);
* time-varying and faulted rounds run the cached union wire against the
  NeighborCache (``core/wire.py``): each receiver keeps one mirror of each
  in-neighbour's ``theta_hat`` per union op, the averaging
  ``sum_j w_ij(t) theta_hat_j`` reads the mirrors, and the only model-sized
  traffic is the compressed hat-delta, which every receiver mixes into
  ``s`` and applies to its mirror with the sender's own arithmetic.  Alive
  bits, then degrees, travel the union's ops (masked-Metropolis weights are
  computed locally).

With a :class:`~repro_torch.core.faults.FaultSpec` the wire is faulted: a
round's events drop, garble, duplicate or delay each (op, receiver)
message; the sender's per-chunk digest of its post-round ``theta_hat``
rides every message and the receiver verifies ``digest(mirror + delta)``
before it commits; a mirror stale past S leaves the mix and asks for a
dense resync (the request travels the reverse op, the hat the op itself),
with exponential backoff (``core/faults.py``).  The events are drawn whole,
``[n_ops, m]``, and each rank keeps its receivers' columns.

On a one-rank mesh (and on the rolled backend's faulted rounds) the whole
node axis is one block: an op is a roll or a gather by its sender map, and
a payload is decoded once by its sender (decoding commutes with the
exchange bit for bit).  Across ranks the packed payload travels and each
receiver decodes it.

Like :func:`~repro_torch.core.gossip.choco_round`, the rounds update theta,
``theta_hat``, ``s`` and the mirrors in place, chunk by chunk in the
reference's ``_scan_plan`` chunks.  Several lanes (gradient tracking's
model and tracker) run in lockstep across ranks: one batch carries every
lane's messages of a chunk.  The fault state's bookkeeping runs on the CPU
once per round.  Every rank draws the gossip noise of the whole node axis
and keeps its rows, so its payloads equal the rolled run's.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, NamedTuple

import numpy as np
import torch
import torch.distributed as dist

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
    check_fused,
    noise_draw,
    payload_total_bits,
)
from repro_torch.core.topology import compile_permute_plan, compile_schedule_plans
from repro_torch.core.wire import UnionWirePlan, compile_union_wire
from repro_torch.kernels.choco_fused import (
    SHIFT_BATCH,
    _encode_pass,
    dtype_scalar,
    fused_mix,
    norms_over,
)
from repro_torch.tree import leaves as tree_leaves
from repro_torch.tree import tree_map, unflatten

__all__ = [
    "choco_round_ppermute",
    "choco_round_ppermute_lanes",
    "choco_round_cached_local",
    "choco_round_cached_local_lanes",
    "mix_stacked_ppermute",
    "mix_stacked_faulted_local",
    "server_average_ppermute",
    "node_mesh_info",
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


# ================================================================ the mesh
def node_mesh_info(mesh, node_axes, num_nodes: int) -> tuple[tuple[str, ...], int, int]:
    """Validated ``(axes, ranks, block)`` for sharding ``num_nodes`` over the
    mesh's ranks; ``block`` is the nodes-per-rank contiguous block.
    ``node_axes`` names the node axis, as in the reference (one axis here:
    the ranks)."""
    axes = (node_axes,) if isinstance(node_axes, str) else tuple(node_axes)
    ndev = int(mesh.size)
    if num_nodes % ndev != 0:
        raise ValueError(
            f"num_nodes={num_nodes} must be divisible by the node-axis device count {ndev} "
            f"(mesh axes {axes}); uneven node/device ratios are a ROADMAP open item")
    return axes, ndev, num_nodes // ndev


def _check_block(irregular: bool, block: int, ndev: int) -> None:
    """Irregular (non-circulant) wire programs need one node per rank: an
    edge step is a permutation of ranks.  A one-rank mesh is exempt."""
    if ndev > 1 and block > 1 and irregular:
        raise ValueError(
            "the ppermute backend runs irregular (non-circulant) graphs with exactly one "
            f"node per device; got a block of {block} nodes/device -- use the rolled backend "
            "or a mesh whose node axes match num_nodes (uneven ratios: ROADMAP open item)")


class WireMeter:
    """The wire's meter, beside the kernels' launch counters: ``count``, the
    bytes this process sent to other ranks, and ``seconds``, the host time
    its exchanges took (staging included)."""

    def __init__(self):
        self.count = 0
        self.seconds = 0.0


#: bytes this process put on the wire (every :func:`exchange` send)
wire_bytes_sent = WireMeter()


class Recv(NamedTuple):
    """What an :func:`exchange` entry receives: its shape, dtype and device."""

    shape: tuple
    dtype: torch.dtype
    device: torch.device


def _like(x: torch.Tensor, rows: int | None = None) -> Recv:
    shape = tuple(x.shape) if rows is None else (rows,) + tuple(x.shape[1:])
    return Recv(shape, x.dtype, x.device)


class _Staging:
    """Page-locked host bytes that an exchange carves its card tensors'
    messages from, kept for the process's later exchanges (each exchange
    waits for its copies, so the bytes are free when the next one starts;
    pinning fresh buffers of every message's size made a round's first
    exchanges several times slower)."""

    def __init__(self):
        self.buf = torch.empty(0, dtype=torch.uint8)

    def take(self, nbytes: int) -> torch.Tensor:
        if self.buf.numel() < nbytes:
            self.buf = torch.empty(max(nbytes, 2 * self.buf.numel()), dtype=torch.uint8,
                                   pin_memory=True)
        return self.buf


_SEND, _RECV = _Staging(), _Staging()


def _raw(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().reshape(-1).view(torch.uint8)


def _aligned(n: int) -> int:
    return -(-n // 64) * 64


def exchange(entries, mesh, meter: bool = True) -> list:
    """Post every message of ``entries`` as one ``batch_isend_irecv`` and wait.

    An entry is ``(send, send_to, recv, recv_from)``: send the tensor
    ``send`` to rank ``send_to`` and receive a :class:`Recv`-shaped tensor
    from rank ``recv_from`` (``None`` for nothing that way).  Every rank
    lists the same logical messages in the same order: an entry's index is
    its tag.  Card tensors are staged through page-locked host buffers, as
    raw bytes.  Adds the bytes sent to :data:`wire_bytes_sent` (unless
    ``meter`` is False: a metric's traffic) and returns the received
    tensors (None where nothing was received)."""
    t0 = time.perf_counter()
    sends = [_raw(e[0]) if e[0] is not None else None for e in entries]
    sizes = [int(np.prod(e[2].shape)) * torch.empty((), dtype=e[2].dtype).element_size()
             if e[2] is not None else 0 for e in entries]
    card = lambda t: t is not None and t.device.type == "cuda"
    out_stage = _SEND.take(sum(_aligned(x.numel()) for x in sends if card(x)))
    in_stage = _RECV.take(sum(_aligned(n) for e, n in zip(entries, sizes)
                              if e[2] is not None and e[2].device.type == "cuda"))
    ops, recvs, staged, o_out, o_in = [], [], False, 0, 0
    group = getattr(mesh, "group", None)
    # a P2POp names its peer by global rank; the entries by the group's rank
    peer = (lambda r: r) if group is None else (lambda r: dist.get_global_rank(group, r))
    for tag, ((send, dst, recv, src), raw, n) in enumerate(zip(entries, sends, sizes)):
        if send is not None:
            if card(raw):
                buf = out_stage[o_out:o_out + raw.numel()]
                buf.copy_(raw, non_blocking=True)
                o_out += _aligned(raw.numel())
                raw, staged = buf, True
            ops.append(dist.P2POp(dist.isend, raw, peer(dst), group, tag))
            if meter:
                wire_bytes_sent.count += raw.numel()
        if recv is not None:
            if recv.device.type == "cuda":
                buf = in_stage[o_in:o_in + n]
                o_in += _aligned(n)
            else:
                buf = torch.empty((n,), dtype=torch.uint8)
            ops.append(dist.P2POp(dist.irecv, buf, peer(src), group, tag))
            recvs.append((tag, buf, recv))
    if staged:
        torch.cuda.synchronize()
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    out = [None] * len(entries)
    for tag, buf, recv in recvs:
        x = buf.view(recv.dtype).reshape(recv.shape)
        out[tag] = x.to(recv.device, non_blocking=True) if recv.device.type == "cuda" else x
    if any(recv.device.type == "cuda" for _, _, recv in recvs):
        torch.cuda.synchronize()  # the staging is free again; the seconds include the copies
    if meter:
        wire_bytes_sent.seconds += time.perf_counter() - t0
    return out


@dataclasses.dataclass(frozen=True)
class _Wire:
    """The node axis as one process sees it: ``m`` nodes, this process's
    rows ``[lo, lo + block)``; ``mesh`` is None on one process."""

    mesh: Any
    m: int
    block: int
    lo: int

    @property
    def size(self) -> int:
        return 1 if self.mesh is None else self.mesh.size

    @property
    def rank(self) -> int:
        return 0 if self.mesh is None else self.mesh.rank

    def local(self, a):
        """This process's columns of a ``[..., m]`` array (numpy or torch)."""
        return a[..., self.lo:self.lo + self.block]


def _wire(mesh, block: int, node_axes="data") -> _Wire:
    """The wire of a mesh whose ranks hold ``block`` rows each (one block of
    everything without a mesh, or on a one-rank mesh)."""
    if mesh is None or mesh.size == 1:
        return _Wire(None, block, block, 0)
    m = block * mesh.size
    node_mesh_info(mesh, node_axes, m)
    return _Wire(mesh, m, block, mesh.rank * block)


def _sender_map(op, m: int) -> np.ndarray:
    kind, arg = op
    if kind == "shift":
        return (np.arange(m) - arg) % m
    snd = np.full((m,), -1, np.int64)
    for src, dst in arg:
        snd[dst] = src
    return snd


def _recv(x: torch.Tensor, op) -> torch.Tensor:
    """One process: the value each node receives on one op, ``out[i] =
    x[senders[i]]`` (zeros where node ``i`` receives nothing)."""
    kind, arg = op
    if kind == "shift":
        return torch.roll(x, int(arg), 0)
    snd = _sender_map(op, x.shape[0])
    out = x.index_select(0, torch.as_tensor(np.clip(snd, 0, None), device=x.device))
    none = np.nonzero(snd < 0)[0]
    if none.size:
        out.index_fill_(0, torch.as_tensor(none, device=x.device), 0)
    return out


def _gather(x: torch.Tensor, snd: np.ndarray, need, wire: _Wire):
    """Exchange entries and a finisher for ``out[i] = x[snd[i]]`` on this
    rank's rows, moving only the rows whose sender is on another rank and,
    with ``need`` (a global [m] bool array), only rows whose receiver needs
    them; other rows are zeros.  One entry per rank offset."""
    R, r, b, lo = wire.size, wire.rank, wire.block, wire.lo
    local_dst, local_src = [], []
    recv_rows = {p: [] for p in range(R)}
    send_rows = {p: [] for p in range(R)}
    for i in range(wire.m):
        j = int(snd[i])
        if j < 0 or (need is not None and not need[i]):
            continue
        ri, rj = i // b, j // b
        if ri == r and rj == r:
            local_dst.append(i - lo)
            local_src.append(j - lo)
        elif ri == r:
            recv_rows[rj].append(i - lo)
        elif rj == r:
            send_rows[ri].append(j - lo)
    entries = []
    for d in range(1, R):
        dst, src = (r + d) % R, (r - d) % R
        sidx, ridx = send_rows[dst], recv_rows[src]
        send = x.index_select(0, torch.as_tensor(sidx, device=x.device)) if sidx else None
        entries.append((send, dst, _like(x, len(ridx)) if ridx else None, src))

    def finish(got):
        out = torch.zeros_like(x)
        if local_dst:
            out[torch.as_tensor(local_dst, device=x.device)] = x.index_select(
                0, torch.as_tensor(local_src, device=x.device))
        for d, g in zip(range(1, R), got):
            ridx = recv_rows[(r - d) % R]
            if ridx:
                out[torch.as_tensor(ridx, device=x.device)] = g
        return out

    return entries, finish


def _recv_many(items, wire: _Wire) -> list:
    """Receive every item ``(x [block, ...], op, need)`` of one exchange:
    each local receiver's value on ``op``.  Across ranks a shift is the
    reference's ``_shard_roll`` (minimal-|s| decomposition: a whole-block
    permute, then one boundary slab, in two batches for all items); an edge
    step, or a shift with ``need`` (a global [m] bool array of the
    receivers that need the row: a resync), gathers rows."""
    if wire.size == 1:
        return [_recv(x, op) for x, op, _ in items]
    R, r, b, m = wire.size, wire.rank, wire.block, wire.m
    out: list = [None] * len(items)
    stage1, later = [], []
    for idx, (x, op, need) in enumerate(items):
        kind, arg = op
        if kind == "perm" or need is not None:
            entries, finish = _gather(x, _sender_map(op, m), need, wire)
            later.append((idx, "gather", len(stage1), len(entries), finish))
            stage1 += entries
            continue
        s = int(arg) % m
        if s == 0:
            out[idx] = x
            continue
        back = s > m // 2  # roll backward by m - s: fewer boundary rows on the wire
        q, rem = divmod(m - s if back else s, b)
        dq = -q if back else q
        at = None
        if q:
            at = len(stage1)
            stage1.append((x.contiguous(), (r + dq) % R, _like(x), (r - dq) % R))
        later.append((idx, "roll", at, back, rem))
    got1 = exchange(stage1, wire.mesh)
    stage2, slabs = [], []
    for idx, kind, *rest in later:
        if kind == "gather":
            at, n, finish = rest
            out[idx] = finish(got1[at:at + n])
            continue
        at, back, rem = rest
        x1 = items[idx][0] if at is None else got1[at]
        if not rem:
            out[idx] = x1
            continue
        slab = x1[:rem] if back else x1[b - rem:]
        slabs.append((idx, x1, back, rem, len(stage2)))
        stage2.append((slab.contiguous(), (r - 1) % R if back else (r + 1) % R, _like(slab),
                       (r + 1) % R if back else (r - 1) % R))
    got2 = exchange(stage2, wire.mesh)
    for idx, x1, back, rem, at in slabs:
        out[idx] = (torch.cat([x1[rem:], got2[at]]) if back
                    else torch.cat([got2[at], x1[:b - rem]]))
    return out


def _shard_roll(x: torch.Tensor, shift: int, wire: _Wire) -> torch.Tensor:
    """``torch.roll(x, shift, 0)`` over the node axis sharded on ``wire``."""
    return _recv_many([(x, ("shift", shift), None)], wire)[0]


def _drive(gens, wire: _Wire, lockstep: bool) -> list:
    """Run round coroutines to their return values.  A coroutine yields
    exchange requests (lists of ``(tensor, op, need)`` items) and is sent
    the received tensors.  In lockstep every live coroutine's request of a
    step goes into one exchange (lanes sharing an edge); otherwise they run
    one after another.  Across ranks the norms of each encode reduce as the
    whole node axis's do (:func:`~repro_torch.kernels.choco_fused.norms_over`)."""
    results = [None] * len(gens)
    reqs: list = [None] * len(gens)

    def advance(k, resp):
        try:
            reqs[k] = gens[k].send(resp)
        except StopIteration as stop:
            reqs[k], results[k] = None, stop.value

    groups = [list(range(len(gens)))] if lockstep else [[k] for k in range(len(gens))]
    with norms_over(wire.m if wire.size > 1 else None):
        for group in groups:
            for k in group:
                advance(k, None)
            while any(reqs[k] is not None for k in group):
                live = [k for k in group if reqs[k] is not None]
                got = _recv_many([item for k in live for item in reqs[k]], wire)
                pos = 0
                for k in live:
                    n = len(reqs[k])
                    advance(k, got[pos:pos + n])
                    pos += n
    return results


def _bcast(w: torch.Tensor, ndim: int) -> torch.Tensor:
    """[block] per-node values broadcast against a [block, ...] tensor."""
    return w.reshape((w.shape[0],) + (1,) * (ndim - 1))


def _inv_op(op):
    """The reverse exchange of a union op: moves a receiver's value to its
    sender (the resync request travels it)."""
    kind, arg = op
    if kind == "shift":
        return (kind, -arg)
    return (kind, tuple((d, s) for (s, d) in arg))


# ================================================================ weights
def _union_round_weights(union: UnionWirePlan, phase: int, alive: torch.Tensor, masked: bool,
                         usable: torch.Tensor | None, wire: _Wire):
    """Coroutine: the round's wire weights on this rank's receivers (f32, on
    ``alive``'s device), ``(self_w [block], ws [n_ops] of [block], alive_nb
    or None)``.  Unmasked, unfaulted rounds read the phase banks; otherwise
    the masked-Metropolis weights are recomputed from the participation
    bits the ops carry, then the degrees, on the phase's active edges
    (times ``usable``, the edges whose mirrors are fresh enough to mix).
    Under asymmetric faults W(t) is row- and not column-stochastic, as in
    the reference."""
    dev = alive.device
    bank = lambda a: wire.local(torch.as_tensor(a[phase], dtype=torch.float32, device=dev))
    if not masked and usable is None:
        wb = bank(union.w_bank)
        return bank(union.self_bank), [wb[k] for k in range(union.n_ops)], None
    act = bank(union.active)
    if usable is not None:
        act = act * usable
    alive_nb = yield [(alive, op, None) for op in union.ops]
    deg = torch.zeros_like(alive)
    for k, nb in enumerate(alive_nb):
        deg = deg + act[k] * alive * nb
    deg_nb = yield [(deg, op, None) for op in union.ops]
    ws = [act[k] * alive * nb / (1.0 + torch.maximum(deg, dnb))
          for k, (nb, dnb) in enumerate(zip(alive_nb, deg_nb))]
    self_w = torch.ones_like(alive)
    for w in ws:
        self_w = self_w - w
    return self_w, ws, alive_nb


def _phase_round_weights(union: UnionWirePlan, p: int, alive: torch.Tensor, masked: bool,
                         wire: _Wire):
    """Coroutine: phase ``p``'s weights restricted to its *active* ops, the
    per-phase wire program of the dense-format mix (a scheduled exact wire
    exchanges only the edges its phase uses).  Returns ``(self_w, ws,
    ops)``; numerics equal the union path's (the skipped ops weigh 0)."""
    dev = alive.device
    act_np = np.asarray(union.active[p])
    sel = [k for k in range(union.n_ops) if act_np[k].any()]
    ops = [union.ops[k] for k in sel]
    loc = lambda row: wire.local(torch.as_tensor(row, dtype=torch.float32, device=dev))
    if not masked:
        return loc(union.self_bank[p]), [loc(union.w_bank[p][k]) for k in sel], ops
    act = [loc(act_np[k]) for k in sel]
    alive_nb = yield [(alive, op, None) for op in ops]
    deg = torch.zeros_like(alive)
    for a, nb in zip(act, alive_nb):
        deg = deg + a * alive * nb
    deg_nb = yield [(deg, op, None) for op in ops]
    ws = [a * alive * nb / (1.0 + torch.maximum(deg, dnb))
          for a, nb, dnb in zip(act, alive_nb, deg_nb)]
    self_w = torch.ones_like(alive)
    for w in ws:
        self_w = self_w - w
    return self_w, ws, ops


def _weighted_mix(x: torch.Tensor, self_w, ws, got) -> torch.Tensor:
    """``sum_j w_ij(t) x_j`` in f32 from the received values ``got`` (one
    per op, already f32)."""
    out = _bcast(self_w, x.ndim) * x.float()
    for w, g in zip(ws, got):
        out = out + _bcast(w, x.ndim) * g
    return out


# ============================================================ faulted wire
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
    """One round's resolved fault picture on this rank's receivers:
    [n_ops, block] gates (CPU), the [block] sender-side bits meter, and the
    global [n_ops, m] resync-needed rows (receivers that want and whose
    sender is here, or who are here)."""

    arrived: torch.Tensor  # bool: the message landed this round
    corrupt: torch.Tensor  # bool: it landed garbled
    want: torch.Tensor  # bool: the receiver requests a dense resync
    bits: torch.Tensor  # f32: wire bits each node's sends realize
    need: np.ndarray  # bool [n_ops, m]: rows a resync moves


def _fault_context(faults, ev: FaultEvents, union: UnionWirePlan, fs: FaultState,
                   alive: torch.Tensor, alive_nb, msg_bits, wire: _Wire):
    """Coroutine: resolve the round's events (CPU) into receiver gates and
    sender billing.  A slot with no sender, or a dead one, carries no
    message: it counts as arrived, so its edge never ages.  Delivered bits
    go to the sender: drops bill 0, dups 2x, corrupt and late messages 1x;
    the resync request travels the reverse op and adds the dense hat to the
    message."""
    exist = wire.local(torch.as_tensor(np.stack([np.asarray(s) >= 0 for s in union.senders])))
    live = exist
    if alive_nb is not None:
        live = live & (torch.stack(alive_nb) > 0.0)
    drop, corrupt_ev, dup, delay = (wire.local(x) for x in ev)
    arrived = torch.where(live, ~(drop | delay), torch.ones_like(live))
    corrupt = corrupt_ev & live
    want = live & (fs.stale.T > faults.stale) & (fs.wait.T <= 0)
    payload_b, digest_b, dense_b = msg_bits
    mult = torch.where(ev.drop, 0.0, torch.where(ev.dup, 2.0, 1.0)).to(torch.float32)
    want_sent = yield [(want[k].to(torch.float32), _inv_op(op), None)
                       for k, op in enumerate(union.ops)]
    bits = torch.zeros(alive.shape, dtype=torch.float32)
    need = np.zeros((union.n_ops, wire.m), bool)
    for k, rcv in enumerate(receiver_maps(union)):
        rcv_t = torch.as_tensor(wire.local(rcv))
        mult_k = torch.where(rcv_t >= 0, mult[k][torch.clamp(rcv_t, min=0)], 0.0)
        bits = bits + mult_k * ((payload_b + digest_b) + want_sent[k] * dense_b)
        need[k, wire.lo:wire.lo + wire.block] = want[k].numpy()
        for j, i in enumerate(wire.local(rcv)):
            if i >= 0 and want_sent[k][j] > 0:
                need[k, i] = True
    return _FaultCtx(arrived, corrupt, want, bits * alive, need)


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


# ============================================================ leaf rounds
def _chunks(trees, block_scan_elems: int):
    """(leaf index, chunk index, views of every tree's chunk) in the
    reference's scan order; ``trees`` are flat leaf lists of one shape."""
    for li, leaf in enumerate(trees[0]):
        inner = int(np.prod(leaf.shape[1:])) if leaf.ndim > 1 else 1
        plan = _scan_plan(tuple(leaf.shape), inner, block_scan_elems)
        if plan is None:
            yield li, None, [t[li] for t in trees]
        else:
            views = [_chunk_views(t[li], plan) for t in trees]
            for ci in range(plan[1]):
                yield li, ci, [v[ci] for v in views]


def _round_leaf_cached(leaf, hat, s, xi, caches, union, weights, gamma, compressor, alive,
                       masked: bool, use_fused: bool, wire: _Wire, gates=None):
    """Coroutine: one cached round of a stacked chunk [block, ...] (the
    reference's ``_round_leaf_cached``).  ``caches`` are the chunk's
    mirrors, one per op; ``gates`` (faulted wire) the round's device-side
    ``(arrived, corrupt, want)``, the host's per-op ``(any corrupt, any
    want)`` and the resync rows.  Returns new (theta, hat, s, mirrors), plus
    the [2, n_ops, block] (delta ok, resync ok) verdict under faults."""
    self_w, ws, alive_nb = weights
    inner_shape, dtype, nd = tuple(leaf.shape[1:]), leaf.dtype, leaf.ndim
    hat32 = hat.float()
    ab = _bcast(alive, nd)
    # averaging from the cached neighbour hats: nothing on the wire
    s_cur = _bcast(self_w, nd) * hat32
    for w, c in zip(ws, caches):
        s_cur = s_cur + _bcast(w, nd) * c.float()
    theta_new = leaf + (ab * gamma).to(dtype) * (s_cur - hat32).to(dtype)
    hat_new = dig_self = payload = None
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
    # the wire: one message per op -- across ranks the packed payload (each
    # receiver decodes it), in one process the sender's decoded delta
    ship = payload is not None and wire.size > 1
    lane = tree_leaves(payload) if ship else [q_self]
    items = [(t, op, None) for op in union.ops for t in lane]
    if gates is not None:
        (_, _, _), (_, any_want), need = gates
        items += [(dig_self, op, None) for op in union.ops]
        # the dense resync rides only requested edges
        items += [(hat_new, op, need[k]) for k, op in enumerate(union.ops)
                  if wire.size > 1 or any_want[k]]
    got = yield items
    n = len(lane)
    recv_q = []
    for k in range(union.n_ops):
        part = got[k * n:(k + 1) * n]
        recv_q.append(compressor.decode(unflatten(payload, part), inner_shape, torch.float32)
                      if ship else part[0])
    mix_q = _bcast(self_w, nd) * q_self
    new_caches, d_oks, r_oks = [], [], []
    pos = union.n_ops * n
    for k, op in enumerate(union.ops):
        q_r = recv_q[k]
        if masked:
            q_r = q_r * _bcast(alive_nb[k], nd)
        if gates is None:
            new_caches.append((caches[k].float() + q_r).to(caches[k].dtype))
            mix_q = mix_q + _bcast(ws[k], nd) * q_r
            continue
        (arrived, corrupt, want), (any_corrupt, any_want), _ = gates
        cb = _bcast(corrupt[k], nd)
        if any_corrupt[k]:
            q_r = torch.where(cb, garble(q_r), q_r)
        cand = (caches[k].float() + q_r).to(caches[k].dtype)
        dig_nb = got[pos + k]
        ok_d = arrived[k] & (digest(cand) == dig_nb)
        okd_b = _bcast(ok_d, nd)
        if any_want[k]:
            hat_recv = got[pos + union.n_ops + (k if wire.size > 1
                                                else sum(any_want[:k]))]
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


def _cached_lane(theta, st: CHOCOState, draw, alive, step: int, events, *, union, gamma,
                 compressor, use_fused, masked, faults, msg_bits, block_scan_elems,
                 wire: _Wire):
    """Coroutine: one cached union-wire round of one lane on this rank's
    block, in place (the reference's ``_cached_round_body``, shared by both
    backends).  ``alive`` is the global [m] mask or None, ``events`` the
    round's global events."""
    lv, hv, sv = (tree_leaves(t) for t in (theta, st.theta_hat, st.s))
    cache_lv = [tree_leaves(c) for c in st.cache]
    block, dev = lv[0].shape[0], lv[0].device
    if not all(x.is_contiguous() for x in lv + hv + sv + [c for cl in cache_lv for c in cl]):
        raise ValueError("the cached round updates its trees in place: pass contiguous leaves")
    alive_host = (torch.ones(block, dtype=torch.float32) if alive is None
                  else wire.local(torch.as_tensor(alive, dtype=torch.float32).cpu()))
    phase = 0 if union.period == 1 else int(step) % union.period
    fs_host, usable = None, None
    if faults is not None:
        fs_host = FaultState(*(x.cpu() for x in st.fault))
        # an edge stale past S leaves the mix until a resync lands
        usable = (fs_host.stale.T <= faults.stale).to(torch.float32)
    w_host = yield from _union_round_weights(union, phase, alive_host, masked, usable, wire)
    fctx, gates = None, None
    if faults is not None:
        fctx = yield from _fault_context(faults, events, union, fs_host, alive_host, w_host[2],
                                         msg_bits, wire)
        gates = (tuple(x.to(dev) for x in (fctx.arrived, fctx.corrupt, fctx.want)),
                 (fctx.corrupt.any(1).tolist(), fctx.want.any(1).tolist()), fctx.need)
    self_w, ws, alive_nb = w_host
    weights = (self_w.to(dev), [w.to(dev) for w in ws],
               None if alive_nb is None else [a.to(dev) for a in alive_nb])
    alive_dev = alive_host.to(dev)
    ok = [torch.ones((union.n_ops, block), dtype=torch.bool, device=dev) for _ in range(2)]
    for li, ci, chunk in _chunks([lv, hv, sv] + cache_lv, block_scan_elems):
        xi = draw(li, ci, tuple(chunk[0].shape[1:]))
        lc, hc, sc, *mc = (x.contiguous() for x in chunk)
        t_new, h_new, s_new, m_new, verdict = yield from _round_leaf_cached(
            lc, hc, sc, xi, mc, union, weights, gamma, compressor, alive_dev, masked,
            use_fused, wire, gates)
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


def _clone_generator(gen: torch.Generator) -> torch.Generator:
    out = torch.Generator(device=gen.device)
    out.set_state(gen.get_state())
    return out


def _lane_draws(lanes, generator, noises, wire: _Wire, block_scan_elems: int, lockstep: bool):
    """Each lane's noise draw on this rank's rows, and a finisher that
    leaves ``generator`` where the rolled round leaves it.  The rolled
    round draws lane after lane from one generator; lanes in lockstep get
    generators placed where their lane starts (the earlier lanes' draws run
    once more and are dropped)."""
    nodes = (wire.lo, wire.m)
    if noises is not None or generator is None or not lockstep or len(lanes) == 1:
        draws = [noise_draw(lane.compressor, tree_leaves(lane.theta), generator,
                            None if noises is None else noises[k], nodes=nodes)
                 for k, lane in enumerate(lanes)]
        return draws, lambda: None
    gens, g = [], _clone_generator(generator)
    for k, lane in enumerate(lanes):
        gens.append(_clone_generator(g))
        if k < len(lanes) - 1:
            leaves = tree_leaves(lane.theta)
            dry = noise_draw(lane.compressor, leaves, g, None, nodes=nodes)
            for li, ci, chunk in _chunks([leaves], block_scan_elems):
                dry(li, ci, tuple(chunk[0].shape[1:]))
    draws = [noise_draw(lane.compressor, tree_leaves(lane.theta), gk, None, nodes=nodes)
             for lane, gk in zip(lanes, gens)]
    return draws, lambda: generator.set_state(gens[-1].get_state())


def _cached_lanes(lanes, *, generator, noises, union, fused, block_scan_elems, step, mask,
                  faults, events, wire: _Wire):
    """The multi-lane cached union-wire round on ``wire``."""
    lanes = tuple(LaneRound(*lane) for lane in lanes)
    if not lanes:
        raise ValueError("a cached union-wire round needs at least one lane")
    masked = mask is not None
    if fused and masked:
        raise ValueError("the fused encode has no participation mask (a dead node's residual "
                         "must be zero): a masked faulted round takes the packed path")
    lockstep = wire.size > 1
    draws, done = _lane_draws(lanes, generator, noises, wire, block_scan_elems, lockstep)
    gens = []
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
            ev = _as_events(faults, events[k], union.n_ops, wire.m)
        msg_bits = (wire_msg_bits(lane.compressor, lane.theta, block_scan_elems)
                    if faults is not None else None)
        gens.append(_cached_lane(
            lane.theta, lane.state, draws[k], mask, step, ev, union=union, gamma=lane.gamma,
            compressor=lane.compressor, use_fused=use_fused, masked=masked, faults=faults,
            msg_bits=msg_bits, block_scan_elems=block_scan_elems, wire=wire))
    outs = _drive(gens, wire, lockstep)
    done()
    return tuple(o[0] for o in outs), tuple(o[1] for o in outs)


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
    m = tree_leaves(lanes[0].theta)[0].shape[0]
    return _cached_lanes(lanes, generator=generator, noises=noises,
                         union=resolve_union(union, schedule, topology), fused=fused,
                         block_scan_elems=block_scan_elems, step=step, mask=mask,
                         faults=faults, events=events, wire=_wire(None, m))


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


# ======================================================== the static round
def _static_lane(lane: LaneRound, plan, draw, use_packed: bool, use_fused: bool,
                 block_scan_elems: int, wire: _Wire):
    """Coroutine: one static CHOCO round of one lane on this rank's block,
    operation for operation with ``gossip._round_leaf``; each chunk's
    messages (every shift's or edge step's) are one exchange request."""
    comp, gamma = lane.compressor, lane.gamma
    lv, hv, sv = (tree_leaves(t) for t in (lane.theta, lane.state.theta_hat, lane.state.s))
    if not all(x.is_contiguous() for x in lv + hv + sv):
        raise ValueError("choco_round updates its trees in place: pass contiguous leaves")
    ops = ([("shift", sh) for sh, _ in plan.shifts] if plan.is_circulant
           else [("perm", step.perm) for step in plan.steps])
    for li, ci, (lc, hc, sc) in _chunks([lv, hv, sv], block_scan_elems):
        xi = draw(li, ci, tuple(lc.shape[1:]))
        leaf, hat, s = lc.contiguous(), hc.contiguous(), sc.contiguous()
        inner_shape, dtype = tuple(leaf.shape[1:]), leaf.dtype
        theta_new = leaf + (s - hat) * dtype_scalar(gamma, dtype)
        if use_fused:
            out = yield from _fused_leaf(theta_new, hat, s, xi, plan.shifts, comp.bits, wire)
        else:
            resid = (theta_new - hat).float()
            payload = None if isinstance(comp, Identity) else comp.encode(resid, xi)
            q_self = resid if payload is None else comp.decode(payload, inner_shape,
                                                               torch.float32)
            ship = use_packed and payload is not None
            lane_t = tree_leaves(payload) if ship else [q_self]
            got = yield [(t, op, None) for op in ops for t in lane_t]
            n = len(lane_t)
            recv = [got[k * n:(k + 1) * n] for k in range(len(ops))]
            if ship:
                deq = lambda part: comp.decode(unflatten(payload, part), inner_shape,
                                               torch.float32)
            else:
                deq = lambda part: part[0]
            # gossip._mix_payload starts from its first term, _mix_leaf from zeros
            mixed = _static_mix(q_self, deq, recv, plan, wire, zero_start=not ship)
            out = (theta_new, (hat.float() + q_self).to(hat.dtype),
                   (s.float() + mixed).to(s.dtype))
        for dst, src in zip((lc, hc, sc), out):
            dst.copy_(src)
    return lane.theta, lane.state


def _static_mix(q_self, deq, recv, plan, wire: _Wire, zero_start: bool = False) -> torch.Tensor:
    """``sum_j w_ij q_j`` from the received messages (one per op): shifts in
    the plan's order, accumulated from zeros as ``gossip._mix_leaf`` does
    (``zero_start``) or from the first term as ``_mix_payload`` does; edge
    steps after the self term (the dense oracle reassociated)."""
    if plan.is_circulant:
        out = torch.zeros_like(q_self) if zero_start else None
        for (shift, weight), part in zip(plan.shifts, recv):
            term = q_self if shift % wire.m == 0 else deq(part)
            out = weight * term if out is None else out + weight * term
        return out
    dev, nd = q_self.device, q_self.ndim
    sw = wire.local(torch.as_tensor(plan.self_weight, dtype=torch.float32, device=dev))
    out = _bcast(sw, nd) * q_self
    for step, part in zip(plan.steps, recv):
        w = wire.local(torch.as_tensor(step.weights, dtype=torch.float32, device=dev))
        out = out + _bcast(w, nd) * deq(part)
    return out


def _fused_leaf(theta_new, hat, s, xi, shifts, bits: int, wire: _Wire):
    """Coroutine: the fused round of one chunk on this rank's block
    (``choco_fused.fused_round_leaf`` with the payload on the wire): the
    fused encode, then the packed payload and the sender's dequantize scales
    travel each shift, and ``fused_mix`` decodes the received shifts,
    pre-rolled ``[K, block, ...]``, into ``s``."""
    b, dtype = theta_new.shape[0], theta_new.dtype
    (lvl, sign, hat_new_g), _, scale_deq, grid3, unpad = _encode_pass(theta_new, hat, xi, bits,
                                                                      False)
    got = yield [(t, ("shift", sh), None) for sh, _ in shifts for t in (lvl, sign, scale_deq)]
    rolled = [got[3 * k:3 * k + 3] for k in range(len(shifts))]
    # the f32 s grid is carried across shift batches and cast once at the end
    s_new_g = grid3(s.reshape(b, -1).to(torch.float32, copy=True)).contiguous()
    for lo in range(0, len(shifts), SHIFT_BATCH):
        batch = list(zip(shifts[lo:lo + SHIFT_BATCH], rolled[lo:lo + SHIFT_BATCH]))
        wscale = torch.stack([w * sc for (_, w), (_, _, sc) in batch])
        s_new_g = fused_mix(torch.stack([lv for _, (lv, _, _) in batch]),
                            torch.stack([sg for _, (_, sg, _) in batch]), s_new_g, wscale, bits)
    return theta_new, unpad(hat_new_g), unpad(s_new_g).to(dtype)


# ============================================================ the backend
def choco_round_ppermute(theta_half, state: CHOCOState, topology, gamma: float,
                         compressor: Compressor, *, mesh, node_axes="data",
                         generator: torch.Generator | None = None, noise=None,
                         packed: bool = True, fused: bool = False,
                         block_scan_elems: int = BLOCK_SCAN_ELEMS, schedule=None,
                         step: int | None = None, mask=None, union=None, faults=None,
                         events=None):
    """One compressed-consensus round on the neighbour-exchange backend: the
    rank's ``[block, ...]`` rows of ``theta_half`` and ``state``, updated in
    place and returned.

    Drop-in for ``gossip.choco_round`` (reached through its
    ``backend="ppermute"`` dispatch): the same state threading, noise and
    chunking, with only compressed payloads on the wire -- the static
    packed / fused formats, or (time-varying and faulted rounds) the
    hat-delta format against the NeighborCache.  ``schedule`` + ``step`` +
    ``mask`` (the global [m] participation mask) select the round's
    weights from the union wire's banks; ``faults`` with the round's global
    ``events`` runs the faulted wire.  ``noise(leaf, chunk, shape)`` gives
    the whole node axis's noise, as for the rolled round."""
    thetas, states = choco_round_ppermute_lanes(
        (LaneRound(theta_half, state, gamma, compressor),), topology, generator, mesh=mesh,
        node_axes=node_axes, noises=None if noise is None else (noise,), packed=packed,
        fused=fused, block_scan_elems=block_scan_elems, schedule=schedule, step=step,
        mask=mask, union=union, faults=faults, events=None if events is None else (events,))
    return thetas[0], states[0]


def choco_round_ppermute_lanes(lanes, topology, generator: torch.Generator | None = None, *,
                               mesh, node_axes="data", noises=None, packed: bool = True,
                               fused: bool = False, block_scan_elems: int = BLOCK_SCAN_ELEMS,
                               schedule=None, step: int | None = None, mask=None, union=None,
                               faults=None, events=None):
    """The multi-lane round on the neighbour-exchange backend: every edge of
    the round carries one message per lane.  Across ranks the lanes run in
    lockstep, so one batch holds every lane's messages of a chunk; each lane
    keeps its own noise (the rolled round's: lane after lane from
    ``generator``, or ``noises[k]``), mirrors and fault state (``events[k]``).
    Returns ``(thetas, states)``, one entry per lane, updated in place."""
    if mesh is None:
        raise ValueError("backend='ppermute' requires a mesh (see launch.mesh.make_node_mesh)")
    lanes = tuple(LaneRound(*lane) for lane in lanes)
    if not lanes:
        raise ValueError("choco_round_ppermute_lanes needs at least one lane")
    wire = _wire(mesh, tree_leaves(lanes[0].theta)[0].shape[0], node_axes)
    time_varying = ((schedule is not None and not getattr(schedule, "is_static", True))
                    or mask is not None or faults is not None)
    if time_varying:
        union = resolve_union(union, schedule, topology)
        _check_block(any(k == "perm" for k, _ in union.ops), wire.block, wire.size)
        return _cached_lanes(lanes, generator=generator, noises=noises, union=union,
                             fused=fused, block_scan_elems=block_scan_elems,
                             step=0 if step is None else step, mask=mask, faults=faults,
                             events=events, wire=wire)
    plan = compile_permute_plan(topology)
    _check_block(not plan.is_circulant, wire.block, wire.size)
    if fused:
        for lane in lanes:
            check_fused(topology, lane.compressor)
    lockstep = wire.size > 1
    draws, done = _lane_draws(lanes, generator, noises, wire, block_scan_elems, lockstep)
    gens = [_static_lane(lane, plan, draws[k],
                         packed and not isinstance(lane.compressor, Identity),
                         fused and not isinstance(lane.compressor, Identity), block_scan_elems,
                         wire)
            for k, lane in enumerate(lanes)]
    outs = _drive(gens, wire, lockstep)
    done()
    return tuple(o[0] for o in outs), tuple(o[1] for o in outs)


# ====================================================== the dense-format mix
def _dense_msg_bits(tree) -> float:
    """Bits of one dense message (the tree at leaf dtype) plus its 32-bit
    per-leaf digest lane."""
    total = 0.0
    for leaf in tree_leaves(tree):
        d = int(np.prod(leaf.shape[1:])) if leaf.ndim > 1 else 1
        total += float(d) * leaf.element_size() * 8.0 + 32.0
    return total


def _memoryless_fault(ev: FaultEvents, union: UnionWirePlan, dense_msg: float, wire: _Wire):
    """A memoryless wire (exact consensus, the lambda gossip) has no mirror
    to heal: a dropped, garbled or late message leaves the round's mix.
    Returns ``(usable [n_ops, block] f32, bits [block] f32)`` (CPU)."""
    usable = wire.local((~(ev.drop | ev.corrupt | ev.delay)).to(torch.float32))
    mult = torch.where(ev.drop, 0.0, torch.where(ev.dup, 2.0, 1.0)).to(torch.float32)
    bits = torch.zeros(wire.block, dtype=torch.float32)
    for k, rcv in enumerate(receiver_maps(union)):
        rcv_t = torch.as_tensor(wire.local(rcv))
        bits = bits + torch.where(rcv_t >= 0, mult[k][rcv_t.clamp(min=0)], 0.0)
    return usable, bits * dense_msg


def _mix_union(tree, union: UnionWirePlan, wire: _Wire, *, step, mask, faults, events,
               per_phase: bool):
    """Coroutine: the dense-format mix of a stacked tree over the union
    wire on ``wire`` (weights from the phase banks, the per-phase program,
    or the masked / faulted recompute).  Returns ``(mixed, bits or
    None)``."""
    leaves = tree_leaves(tree)
    dev = leaves[0].device
    alive = (torch.ones(wire.block, dtype=torch.float32) if mask is None
             else wire.local(torch.as_tensor(mask, dtype=torch.float32).cpu()))
    phase = 0 if union.period == 1 else int(step or 0) % union.period
    usable = bits = None
    if faults is not None:
        ev = _as_events(faults, events, union.n_ops, wire.m)
        usable, bits = _memoryless_fault(ev, union, _dense_msg_bits(tree), wire)
        bits = bits * alive
    if per_phase:
        self_w, ws, ops = yield from _phase_round_weights(union, phase, alive, mask is not None,
                                                          wire)
    else:
        self_w, ws, _ = yield from _union_round_weights(union, phase, alive, mask is not None,
                                                        usable, wire)
        ops = list(union.ops)
    self_w, ws = self_w.to(dev), [w.to(dev) for w in ws]
    got = yield [(x.float(), op, None) for x in leaves for op in ops]
    n = len(ops)
    mixed = [_weighted_mix(x, self_w, ws, got[i * n:(i + 1) * n]).to(x.dtype)
             for i, x in enumerate(leaves)]
    return unflatten(tree, mixed), bits


def _run(gen, wire: _Wire):
    return _drive([gen], wire, False)[0]


def mix_stacked_faulted_local(tree, *, union=None, topology=None, schedule=None,
                              step: int = 0, mask=None, faults, events):
    """The memoryless faulted mix of a stacked tree in one process (the
    exact wire and the lambda gossip): returns ``(mixed, bits)``, ``bits``
    the [m] per-sender delivered-bits meter (CPU)."""
    union = resolve_union(union, schedule, topology)
    m = tree_leaves(tree)[0].shape[0]
    return _run(_mix_union(tree, union, _wire(None, m), step=step, mask=mask, faults=faults,
                           events=events, per_phase=False), _wire(None, m))


def mix_stacked_ppermute(tree, topology, *, mesh, node_axes="data", schedule=None, step=None,
                         mask=None, union=None, faults=None, events=None):
    """Uncompressed (dense-format) gossip of the rank's rows of a stacked
    tree over the neighbour-exchange wire: the lambda gossip and
    :class:`~repro_torch.core.trainer.ExactConsensus` ride these sends on
    the ppermute backend.  A static topology mixes by its shifts (in
    ``gossip.mix_stacked``'s order) or edge steps; ``schedule`` / ``step`` /
    ``mask`` select the round's weights from the union wire (a scheduled,
    fault-free mix exchanges only its phase's active edges).  ``faults``
    with the round's global ``events`` runs the memoryless faulted mix and
    returns ``(mixed, bits)``, ``bits`` the rank's [block] meter."""
    if mesh is None:
        raise ValueError("backend='ppermute' requires a mesh (see launch.mesh.make_node_mesh)")
    leaves = tree_leaves(tree)
    wire = _wire(mesh, leaves[0].shape[0], node_axes)
    time_varying = ((schedule is not None and not getattr(schedule, "is_static", True))
                    or mask is not None or faults is not None)
    if not time_varying:
        plan = compile_permute_plan(topology)
        _check_block(not plan.is_circulant, wire.block, wire.size)
        ops = ([("shift", sh) for sh, _ in plan.shifts] if plan.is_circulant
               else [("perm", st.perm) for st in plan.steps])
        wdt = lambda x: x.dtype if x.is_floating_point() else torch.float32
        got = _recv_many([(x.to(wdt(x)), op, None) for x in leaves for op in ops], wire)
        n = len(ops)
        out = []
        for i, x in enumerate(leaves):
            xw = x.to(wdt(x))
            recv = [[g] for g in got[i * n:(i + 1) * n]]
            if plan.is_circulant:  # gossip._mix_leaf's accumulation, term for term
                acc = torch.zeros_like(xw)
                for (shift, weight), part in zip(plan.shifts, recv):
                    acc = acc + weight * (xw if shift % wire.m == 0 else part[0])
                out.append(acc)
            else:
                out.append(_static_mix(xw, lambda p: p[0], recv, plan, wire).to(x.dtype))
        return unflatten(tree, out)
    if faults is not None and events is None:
        raise ValueError("faulted mixes need the round's events")
    union = resolve_union(union, schedule, topology)
    _check_block(any(k == "perm" for k, _ in union.ops), wire.block, wire.size)
    mixed, bits = _run(_mix_union(tree, union, wire, step=step, mask=mask, faults=faults,
                                  events=events,
                                  per_phase=union.period > 1 and faults is None), wire)
    return (mixed, bits) if faults is not None else mixed


# ============================================================ the server
def all_reduce_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of ``x`` over the mesh's ranks (staged through the host for a
    card's tensor); ``x`` itself on a one-rank mesh."""
    if mesh is None or mesh.size == 1:
        return x
    buf = x.detach().to("cpu", copy=True).contiguous()
    dist.all_reduce(buf, group=mesh.group)
    return buf.to(x.device)


def all_gather_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """Every rank's ``[block, ...]`` rows of ``x``, concatenated in rank
    order: ``[m, ...]`` (a metric's traffic, not the wire's; a card's
    tensor goes through page-locked host buffers)."""
    if mesh is None or mesh.size == 1:
        return x
    pin = x.device.type == "cuda"
    buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=pin)
    buf.copy_(x, non_blocking=pin)
    whole = torch.empty((mesh.size,) + tuple(x.shape), dtype=x.dtype, pin_memory=pin)
    if pin:
        torch.cuda.synchronize()
    dist.all_gather(list(whole.unbind(0)), buf, group=mesh.group)
    whole = whole.reshape((-1,) + tuple(x.shape[1:]))
    return whole.to(x.device, non_blocking=pin) if pin else whole


def server_average_ppermute(tree, sampled, *, mesh, node_axes="data"):
    """Weighted server average of a stacked tree, the ppermute wire of
    :class:`~repro_torch.core.trainer.FedAvg`: each rank sums its block's
    sampled models, then one all-reduce over the ranks (the reference's
    ``psum``) aggregates them.  ``sampled`` is the global [m] mask; the
    output (no node axis) is the same on every rank."""
    if mesh is None:
        raise ValueError("backend='ppermute' requires a mesh (see launch.mesh.make_node_mesh)")
    leaves = tree_leaves(tree)
    wire = _wire(mesh, leaves[0].shape[0], node_axes)
    sm_all = torch.as_tensor(sampled, dtype=torch.float32).to(leaves[0].device)
    sm = wire.local(sm_all) if wire.size > 1 else sm_all
    wsum = sm_all.sum()

    def avg(x):
        part = (x.float() * _bcast(sm, x.ndim)).sum(0)
        return (all_reduce_sum(part, mesh) / wsum).to(x.dtype)

    return tree_map(avg, tree)
