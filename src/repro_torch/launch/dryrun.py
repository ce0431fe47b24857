"""Multi-pod dry run (port of ``repro.launch.dryrun``): prove that every
(arch x input shape x mesh) builds and fits, and give its roofline terms,
with no hardware.

For each pair this script runs the step the reference builds:

  prefill_32k  -> ``make_prefill_step``: the full forward plus cache priming
                  on the consensus params,
  decode_32k / long_500k -> ``make_decode_step``: one token against a
                  seq_len cache,
  train_4k     -> ``make_trainer(...).step`` on the node-stacked trainer
                  state (m = 16 or 32 nodes over ``data`` (x ``pod``)),
                  as device 0 runs it (``trace_train``),

on the (16, 16) = 256-device and (2, 16, 16) = 512-device meshes of
``launch/mesh.py``: a world of fake ranks in this one process, seen from
rank 0.  The state is placed by ``launch/sharding.py`` as DTensors whose
local shards are fake tensors (``FakeTensorMode``): nothing is allocated,
computed or sent, and no kernel is launched.  The step takes the plain
model path (``attn_kernel=None``), as the reference prices its XLA path:
attention is query-chunked above ``layers.CHUNK_THRESHOLD``, and a ctypes
kernel cannot take a fake tensor.  Where DTensor's own strategy would not
give the per-device program GSPMD makes, ``placed_layers`` swaps in its
form (attention, the MoE, the embedding, the gold-logit gather, the cache
writes, the blocks' outputs).

``launch/op_cost.py`` counts the per-device flops, bytes and collective
bytes of the ops the step dispatches and follows its live storages:
``mem_per_device`` holds the reference's keys (argument, output and temp
bytes; no generated code) and ``peak_bytes``.  The roofline terms use the
H100's constants (``launch/roofline.py``).  One JSON row per pair goes to
``experiments/dryrun_torch/<arch>_<shape>_<mesh>.json``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape decode_32k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--both-meshes] [--skip-existing]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback

import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.shapes import SHAPES, batch_specs, supports_shape
from repro_torch.kernels.ref import NEG_INF
from repro_torch.launch import sharding as sh
from repro_torch.launch import steps as st
from repro_torch.launch.mesh import fake_world, make_production_mesh, node_axes
from repro_torch.launch.op_cost import Cost, OpCost
from repro_torch.launch.roofline import model_flops_for, roofline_terms
from repro_torch.models import layers
from repro_torch.models import transformer as T

_plain_attend = layers._attend

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "experiments", "dryrun_torch")


def _mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


@dataclasses.dataclass
class Traced:
    """What one traced step gives: its per-device cost, its matmul flops,
    the memory per device (the reference's keys and the peak) and the
    host seconds the trace took."""

    cost: Cost
    matmul_flops: float
    mem: dict
    seconds: float
    ops: int


def _run(fn, args, grad: bool = False) -> Traced:
    """Run ``fn(*args)`` under the counter (``args``' storages held as the
    arguments; autograd on with ``grad``); outputs the run made count as
    output bytes."""
    from torch.distributed.tensor.experimental import implicit_replication

    counter = OpCost(track_memory=True)
    t0 = time.perf_counter()
    with counter, implicit_replication(), torch.set_grad_enabled(grad):
        held = counter.hold(args)
        out = fn(*args)
        out_bytes = counter.live_new(out)
        peak = counter.peak_bytes
    mem = {"argument_bytes": held, "output_bytes": out_bytes,
           "temp_bytes": peak - held - out_bytes, "generated_code_bytes": None,
           "peak_bytes": peak}
    return Traced(counter.cost, counter.matmul_flops, mem, time.perf_counter() - t0,
                  counter.ops)


def trace_serving(cfg, step: str, mesh, *, batch: int, seq: int, cache_len: int,
                  lead: tuple[str, ...] = ("data",), pos: int | None = None) -> Traced:
    """Trace one serving step of ``cfg`` on ``mesh`` (inside its fake
    world): ``"prefill"`` of ``batch`` x ``seq`` tokens into a fresh
    ``cache_len`` cache, or ``"decode"`` of one token per row against a
    ``cache_len`` cache at position ``pos`` (default ``seq``).  The
    parameters (and the decode cache) are placed by ``launch/sharding.py``
    and counted as arguments; the prefill's cache is made, placed, inside
    the step, an output as in the reference."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg = dataclasses.replace(cfg, attn_kernel=None, quantized_kv=False)
    with FakeTensorMode(allow_non_fake_inputs=True):
        params_abs = st.abstract_params(cfg)
        params = T.params_from_jax(
            sh.shardings(mesh, sh.param_pspecs(params_abs, mesh), params_abs), cfg,
            device=mesh.device_type)
        cache_abs = st.abstract_cache(cfg, batch, cache_len)
        cache_spec = sh.cache_pspecs(cache_abs, mesh, batch, lead_axes=lead)
        if step == "prefill":
            batch_abs = batch_specs(cfg, batch, seq)
            inputs = sh.shardings(mesh, sh.batch_pspecs(batch_abs, mesh, lead_axes=lead),
                                  batch_abs)
            prefill = st.make_prefill_step(cfg, cache_len=cache_len)

            def run(params, inputs):
                cache = st.serving_cache(sh.shardings(mesh, cache_spec, cache_abs), cfg)
                return prefill(params, inputs, cache=cache)

            return _run(run, (params, inputs))
        cache = st.serving_cache(sh.shardings(mesh, cache_spec, cache_abs), cfg)
        dec = {"tokens": torch.empty((batch, 1), dtype=torch.int32, device="meta")}
        tokens = sh.shardings(mesh, sh.batch_pspecs(dec, mesh, lead_axes=lead), dec)["tokens"]
        position = torch.full((), seq if pos is None else pos, dtype=torch.int32,
                              device=mesh.device_type)
        return _run(st.make_decode_step(cfg), (params, cache, tokens, position))


# ------------------------------------------- the cache writes on a mesh
def _store_rows(dst, rows, slot, src) -> None:
    """``layers.store_rows`` (``dst[rows, slot] = src``) for a placed
    ``dst``: this rank's rows of ``src`` (redistributed to ``dst``'s
    placements), written where the global slots fall inside its shard (a
    masked write into the clamped slots, static shapes: what the owning
    shard of a dynamic-update-slice does)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(dst, DTensor):
        dst[rows, slot] = src
        return
    mesh = dst.device_mesh
    local = dst.to_local()
    _, offset = _offsets(dst, mesh)
    b, n = local.shape[0], local.shape[1]
    # src drops dst's dim 1 (the slot): its dims 0, 2, 3 are src's 0, 1, 2
    placements = [Shard(p.dim - (p.dim > 1)) if isinstance(p, Shard) and p.dim != 1
                  else Replicate() for p in dst.placements]
    part = src.redistribute(mesh, placements).to_local().to(local.dtype)
    r = torch.arange(b, device=local.device)
    s = slot[offset[0]:offset[0] + b] - offset[1]
    inside = (s >= 0) & (s < n)
    s = torch.clamp(s, 0, n - 1)
    keep = local[r, s]
    local[r, s] = torch.where(inside.reshape((-1,) + (1,) * (part.dim() - 1)), part, keep)


def _store_prompt(c: dict, k, v) -> None:
    """The prefill's cache write (``transformer._store_prompt``) for a placed
    cache: the prompt's K/V, its last L rows rolled into ring order when it
    is longer than the cache, padded to the cache's length and copied in
    (a prompt as long as the cache, as every pair's is, pads nothing)."""
    import torch.nn.functional as F

    S, L = k.shape[1], c["k"].shape[1]
    for name, src in (("k", k), ("v", v)):
        dst = c[name]
        if S > L:
            src = torch.roll(src[:, S - L:], S % L, dims=1)
        elif S < L:
            src = F.pad(src, (0, 0, 0, 0, 0, L - S))
        dst.copy_(src.to(dst.dtype))


class _ShardEmbed(torch.autograd.Function):
    """The lookup in a table this device holds rows ``[lo, lo + n)`` of:
    other ids read 0 (a pending sum over the shards), the backward adds into
    the local rows (Megatron's vocab-parallel embedding)."""

    @staticmethod
    def forward(ctx, table, ids, lo: int):
        inside = (ids >= lo) & (ids < lo + table.shape[0])
        at = torch.where(inside, ids - lo, 0)
        ctx.save_for_backward(at, inside)
        ctx.shape = table.shape
        return torch.nn.functional.embedding(at, table) * inside[..., None]

    @staticmethod
    def backward(ctx, grad):
        at, inside = ctx.saved_tensors
        out = torch.zeros(ctx.shape, dtype=grad.dtype, device=grad.device)
        rows = (grad * inside[..., None]).reshape(-1, ctx.shape[1])
        return out.index_add_(0, at.reshape(-1), rows), None, None


def _embed(params, tokens):
    """The embedding lookup in a vocab-sharded table, its pending sum done
    at once (the one all-reduce of [B, S, d], the reference's): a masked
    local lookup with a backward (DTensor's own ``_MaskPartial`` serves one
    reduction and has no backward that runs)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    table = params["table"]
    if not isinstance(table, DTensor) or not any(p.is_shard() for p in table.placements):
        return layers.embed(params, tokens)
    mesh = table.device_mesh
    _, offset = _offsets(table, mesh)
    ids = tokens.long()
    ids_pl = ids.placements if isinstance(ids, DTensor) else [Replicate()] * mesh.ndim
    local = _ShardEmbed.apply(table.to_local(), ids.to_local() if isinstance(ids, DTensor)
                              else ids, offset[0])
    pending = [Partial() if isinstance(p, Shard) else q for p, q in zip(table.placements, ids_pl)]
    x = DTensor.from_local(local, mesh, pending, run_check=False)
    return x.redistribute(mesh, [Replicate() if isinstance(p, Partial) else p for p in pending])


def _offsets(t, mesh) -> tuple[list[int], list[int]]:
    """(local shape, global offset) of this rank's shard of DTensor ``t``
    (even shards, outer mesh dims first)."""
    from torch.distributed.tensor import Shard

    coord, size, offset = mesh.get_coordinate(), list(t.shape), [0] * t.dim()
    for i, p in enumerate(t.placements):
        if isinstance(p, Shard):
            size[p.dim] //= mesh.size(i)
            offset[p.dim] += coord[i] * size[p.dim]
    return size, offset


def _attend(q, k, v, mask, scale):
    """``layers._attend`` on placed q / k / v, as GSPMD partitions it: each
    device attends its own batch rows and query heads (k and v take q's
    batch and head placements: a local slice of replicated keys, no
    collective).  Keys sharded on their sequence dim (the decode cache's
    flash-decoding layout) stay so: the query comes whole over that mesh
    dim, and the softmax's max and sum and the P.V product are all-reduced
    over it."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not any(isinstance(t, DTensor) for t in (q, k, v)):
        return _plain_attend(q, k, v, mask, scale)
    mesh = next(t.device_mesh for t in (q, k, v) if isinstance(t, DTensor))

    def placed(t):
        return t if isinstance(t, DTensor) else DTensor.from_local(
            t, mesh, [Replicate()] * mesh.ndim, run_check=False)

    q, k, v = placed(q), placed(k), placed(v)
    if _SEQ_SHARD and "model" in mesh.mesh_dim_names:  # --seq-shard-attn
        i = mesh.mesh_dim_names.index("model")
        if (not isinstance(q.placements[i], Shard) and q.shape[1] % mesh.size(i) == 0
                and q.shape[1] >= mesh.size(i)):
            q = q.redistribute(mesh, [Shard(1) if j == i else p
                                      for j, p in enumerate(q.placements)])
    # keys sharded on their sequence (the decode cache's flash-decoding
    # layout) stay so, and the query (one token) comes whole over that dim
    split = [i for i, p in enumerate(k.placements) if isinstance(p, Shard) and p.dim == 1]
    q = q.redistribute(mesh, [Replicate() if i in split else p
                              for i, p in enumerate(q.placements)])
    kv_pl = [Shard(1) if i in split else p if isinstance(p, Shard) and p.dim in (0, 2)
             else Replicate() for i, p in enumerate(q.placements)]
    k, v = k.redistribute(mesh, kv_pl), v.redistribute(mesh, kv_pl)
    ql, kl, vl = q.to_local(), k.to_local(), v.to_local()
    logits = torch.einsum("bqhk,bshk->bhqs", ql, kl).float() * scale
    if mask is not None:
        mask = mask.full_tensor() if isinstance(mask, DTensor) else mask
        (_, qs, _, _), qo = _offsets(q, mesh)
        (_, ks, _, _), ko = _offsets(k, mesh)
        b0 = qo[0] if mask.shape[0] > 1 else 0
        m = mask[b0:b0 + (ql.shape[0] if mask.shape[0] > 1 else 1)]
        m = m[:, qo[1]:qo[1] + qs] if m.shape[1] > 1 else m
        m = m[..., ko[1]:ko[1] + ks]
        logits = logits.masked_fill(~m[:, None], NEG_INF)
    if not split:
        probs = torch.softmax(logits, dim=-1).to(vl.dtype)
        out = torch.einsum("bhqs,bshk->bqhk", probs, vl)
    else:
        group = [mesh.get_group(i) for i in split]
        top = logits.amax(-1, keepdim=True)
        for g in group:
            top = funcol.all_reduce(top, "max", g)
        e = torch.exp(logits - top)
        total = e.sum(-1, keepdim=True)
        for g in group:
            total = funcol.all_reduce(total, "sum", g)
        out = torch.einsum("bhqs,bshk->bqhk", (e / total).to(vl.dtype), vl)
        for g in group:
            out = funcol.all_reduce(out, "sum", g)
    return DTensor.from_local(out, mesh, q.placements, run_check=False)


def _apply_moe(params, x, cfg, *, per_row: bool = False):
    """``moe.apply_moe`` on placed weights, as expert parallelism runs it:
    the router (replicated) routes every token of a group (one group of all
    ``B * S`` tokens: the tokens are gathered over the batch's mesh dims;
    ``per_row``: each local row its own group), each device runs its own
    experts' slots (its shard of the expert dim, or of every expert's
    hidden dim) and the shared experts' hidden shard, and its tokens' sum
    is left pending over the dims that shard the weights (``_megatron``
    reduces it)."""
    import torch.nn.functional as F
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.models import moe

    if not isinstance(x, DTensor):
        return moe.apply_moe(params, x, cfg, per_row=per_row)
    mesh = x.device_mesh

    def local(t):
        return t.to_local() if isinstance(t, DTensor) else t

    def sharded_dims(*ts):
        return {i for t in ts if isinstance(t, DTensor)
                for i, p in enumerate(t.placements) if isinstance(p, Shard)}

    B, S, d = x.shape
    xs = x if per_row else x.redistribute(mesh, [Replicate()] * mesh.ndim)
    xl = xs.to_local()
    xg = xl if per_row else xl.reshape(1, -1, d)
    G, T_, _ = xg.shape
    K = cfg.experts_per_token
    r = moe.route({"router": local(params["router"])}, xg, cfg)
    C = r["capacity"]
    (El, _, _), (e0, _, _) = _offsets(params["w_gate"], mesh)
    eb = torch.cat([xg, torch.zeros(G, 1, d, dtype=xg.dtype, device=xg.device)], 1)
    eb = eb[torch.arange(G, device=xg.device)[:, None, None], r["src_tok"][:, e0:e0 + El]]
    eb = eb.transpose(0, 1).reshape(El, G * C, d)
    h = F.silu(torch.bmm(eb, local(params["w_gate"]))) * torch.bmm(eb, local(params["w_up"]))
    yb = torch.bmm(h, local(params["w_down"])).reshape(El, G, C, d).transpose(0, 1)
    weighted = (yb * r["gate_slot"][:, e0:e0 + El, :, None].to(yb.dtype)).reshape(G, El * C, d)
    by_expert = torch.argsort(r["expert_idx"], dim=-1)
    eid = torch.gather(r["expert_idx"], 2, by_expert)
    slots = torch.gather(r["slot"], 2, by_expert) - e0 * C
    mine = torch.gather(r["kept"], 2, by_expert) & (eid >= e0) & (eid < e0 + El)
    slots = torch.clamp(slots, 0, El * C - 1)
    y = torch.zeros(G, T_, d, dtype=x.dtype, device=xg.device)
    for k in range(K):
        w = torch.gather(weighted, 1, slots[..., k, None].expand(G, T_, d))
        y = torch.where(mine[..., k, None], y + w, y)
    routed = sharded_dims(params["w_gate"], params["w_up"], params["w_down"])
    pending = set(routed)
    if "shared" in params:
        sp = params["shared"]
        pending |= sharded_dims(*sp.values())
    n = 1
    for i in pending - routed:  # a replicated part adds once over the pending dims
        n *= mesh.size(i)
    y = y.reshape(xl.shape) / n if n > 1 else y.reshape(xl.shape)
    if "shared" in params:
        sh_ = {k: local(v) for k, v in params["shared"].items()}
        ys = layers.apply_mlp(sh_, xl)
        m = 1
        for i in pending - sharded_dims(*params["shared"].values()):
            m *= mesh.size(i)
        y = y + (ys / m if m > 1 else ys)
    if not per_row:  # this device's rows of the batch
        (bl, _, _), (b0, _, _) = _offsets(x, mesh)
        y = y[b0:b0 + bl]
    placements = [Partial() if i in pending else p for i, p in enumerate(x.placements)]
    out = DTensor.from_local(y, mesh, placements, run_check=False, shape=x.shape,
                             stride=x.stride())
    # the router's loss: every device routed the same tokens
    aux = DTensor.from_local(r["aux"].sum(), mesh, [Replicate()] * mesh.ndim, run_check=False)
    return out, aux


class _ShardGather(torch.autograd.Function):
    """``gather`` along a dim this device holds the slice ``[lo, lo + n)``
    of: the ids outside it read 0 (a pending sum over the shards), the
    backward scatters into the local slice (Megatron's vocab-parallel
    gather)."""

    @staticmethod
    def forward(ctx, local, index, lo: int):
        n = local.shape[-1]
        inside = (index >= lo) & (index < lo + n)
        at = torch.where(inside, index - lo, 0)
        ctx.save_for_backward(at, inside)
        ctx.shape = local.shape
        return torch.gather(local, -1, at) * inside

    @staticmethod
    def backward(ctx, grad):
        at, inside = ctx.saved_tensors
        out = torch.zeros(ctx.shape, dtype=grad.dtype, device=grad.device)
        return out.scatter_add_(-1, at, grad * inside), None, None


_real_gather = torch.gather


def _gather(input, dim, index, **kw):
    """``torch.gather`` of a last dim (the vocabulary) sharded over every
    mesh dim that shards ``input`` (``lm_loss``'s gold logits): a masked
    local gather whose sum is pending (DTensor's own vocab-sharded gather
    has no backward that runs)."""
    from torch.distributed.tensor import DTensor, Partial, Shard

    last = dim in (-1, getattr(input, "ndim", 0) - 1)
    if not (isinstance(input, DTensor) and last and not kw):
        return _real_gather(input, dim, index, **kw)
    mesh = input.device_mesh
    vocab = [isinstance(p, Shard) and p.dim in (-1, input.ndim - 1) for p in input.placements]
    if not any(vocab) or any(p.is_shard() and not v for p, v in zip(input.placements, vocab)):
        return _real_gather(input, dim, index, **kw)
    _, offset = _offsets(input, mesh)
    index = index.full_tensor() if isinstance(index, DTensor) else index
    out = _ShardGather.apply(input.to_local(), index, offset[-1])
    return DTensor.from_local(out, mesh, [Partial() if v else p
                                          for p, v in zip(input.placements, vocab)],
                              run_check=False)


def _reduced(tree):
    """Pending sums of a tree's DTensors done (``Partial`` -> ``Replicate``)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    if isinstance(tree, DTensor):
        if any(isinstance(p, Partial) for p in tree.placements):
            return tree.redistribute(tree.device_mesh, [
                Replicate() if isinstance(p, Partial) else p for p in tree.placements])
        return tree
    if isinstance(tree, tuple):
        return tuple(_reduced(t) for t in tree)
    return tree


def _gathered(tree):
    """A block output's sequence shard (``--seq-shard-attn``) gathered back
    into the replicated residual stream."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if isinstance(tree, DTensor):
        if any(isinstance(p, Shard) and p.dim == 1 for p in tree.placements):
            return tree.redistribute(tree.device_mesh, [
                Replicate() if isinstance(p, Shard) and p.dim == 1 else p
                for p in tree.placements])
        return tree
    if isinstance(tree, tuple):
        return tuple(_gathered(t) for t in tree)
    return tree


def _megatron(fn):
    """A mixer or FFN whose row-parallel output projection leaves a pending
    sum: all-reduced as it leaves the block, so the residual stream stays
    replicated over ``model`` (Megatron's one all-reduce per attention and
    per MLP, the reference's GSPMD layout), not left to DTensor's choice;
    under ``--seq-shard-attn`` the output's sequence shard is gathered."""
    def placed(*a, **kw):
        out = _reduced(fn(*a, **kw))
        return _gathered(out) if _SEQ_SHARD else out

    return placed


#: the model functions whose outputs _megatron reduces
_BLOCKS = ("apply_attention", "decode_attention", "apply_mlp", "apply_moe", "apply_rglru",
           "decode_rglru", "mamba2_scan", "decode_mamba2")


#: --seq-shard-attn: attention's query-sequence dim over ``model`` where
#: q's heads are not (the reference's ``layers.SEQ_SHARD_AXIS = "model"``)
_SEQ_SHARD = False


@contextlib.contextmanager
def placed_layers(attn_chunk: int | None = None, seq_shard_attn: bool = False):
    """``layers.CHUNK_THRESHOLD`` (``--attn-chunk``), ``--seq-shard-attn``,
    and the placed forms of the cache writes, the embedding, attention and
    the blocks' outputs, for the extent of the ``with``."""
    global _SEQ_SHARD
    swaps = [(layers, "store_rows", _store_rows), (layers, "_attend", _attend),
             (T, "_store_prompt", _store_prompt), (T, "embed", _embed),
             (torch, "gather", _gather)]
    swaps += [(T, name, _megatron(_apply_moe if name == "apply_moe" else getattr(T, name)))
              for name in _BLOCKS]
    if attn_chunk is not None:
        swaps.append((layers, "CHUNK_THRESHOLD", attn_chunk))
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, new in swaps:
        setattr(mod, name, new)
    _SEQ_SHARD = seq_shard_attn
    try:
        yield
    finally:
        _SEQ_SHARD = False
        for mod, name, old in saved:
            setattr(mod, name, old)


def trace_train(cfg, mesh, lead: tuple[str, ...], *, seq: int, global_batch: int,
                compressor: str = "q4b", microbatches: int = 1,
                grad_accum_dtype: str = "float32") -> Traced:
    """Trace one AD-GDA round (``make_trainer(...).step``) as device 0 of
    ``mesh`` runs it: the m nodes over ``lead`` (one per rank of the node
    axes), the node's model tensor-parallel over ``model`` inside it.  The
    rolled backend's rolls over a sharded node axis are, per device, sends
    to and receives from the neighbours' ranks (GSPMD's collective-permutes):
    that program is the trainer's ``ppermute`` backend on the node axes'
    group, which this runs.  The state is this device's: its node's block
    of theta, the moments, the CHOCO trackers and lambda's row, each leaf
    its ``model`` shard (``sharding.param_pspecs``), plain local tensors
    that the loss places on the ``model`` submesh; the batch is the node's
    ``global_batch / m`` sequences."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor

    from repro_torch.launch.mesh import NodeMesh

    names = tuple(mesh.mesh_dim_names)
    m = 1
    for a in lead:
        m *= mesh.size(names.index(a))
    nodes = mesh[lead] if len(lead) == 1 else mesh[lead]._flatten("nodes")
    model = mesh["model"]
    mi = names.index("model")
    dev = torch.device(mesh.device_type)
    node_mesh = NodeMesh(rank=nodes.get_local_rank(), size=m, device=dev,
                         group=nodes.get_group())
    with FakeTensorMode(allow_non_fake_inputs=True):
        params_abs = st.abstract_params(cfg)
        spec = sh.param_pspecs(params_abs, mesh)
        # each leaf's placement over `model`
        along = sh._with_paths(params_abs, lambda n, _: sh._at(spec, n)[mi])

        def local(names_, t):
            p = sh._at(along, names_)
            shape = list(t.shape)
            if p.is_shard():
                shape[p.dim] //= mesh.size(mi)
            return torch.empty(shape, dtype=t.dtype, device=dev)

        trainer = st.make_trainer(cfg, m, compressor=compressor, microbatches=microbatches,
                                  grad_accum_dtype=grad_accum_dtype, gossip_backend="ppermute",
                                  mesh=node_mesh, device=dev)

        def placed_loss(params, batch, rng):
            placed = sh._with_paths(params, lambda n, t: DTensor.from_local(
                t, model, [sh._at(along, n)], run_check=False))
            return T.lm_loss(placed, batch, cfg, rng).to_local()

        trainer.loss_fn = placed_loss
        state = trainer.init(sh._with_paths(params_abs, local))
        batch = {k: torch.empty((1,) + tuple(v.shape[1:]), dtype=v.dtype, device=dev)
                 for k, v in batch_specs(cfg, global_batch, seq, m).items()}
        return _run(trainer.step, (state, batch), grad=True)


def trace_on_one_device(cfg, step: str, *, batch: int, seq: int, cache_len: int,
                        pos: int | None = None) -> Traced:
    """:func:`trace_serving` on a one-device (1 x 1) mesh in a world of one
    fake rank: the program one card runs, whose ``mem_per_device`` the card
    can check (``chip_smoke.py``'s phase 18b)."""
    from repro_torch.launch.mesh import make_cpu_mesh

    with fake_world(1), placed_layers(None):
        return trace_serving(cfg, step, make_cpu_mesh(1, 1), batch=batch, seq=seq,
                             cache_len=cache_len, pos=pos)


def lower_pair(arch: str, shape_name: str, multi_pod: bool, *, compressor: str = "q4b",
               microbatches: int = 1, grad_accum_dtype: str = "float32",
               attn_chunk: int | None = None, seq_shard_attn: bool = False):
    """Build and trace one (arch, shape, mesh) in its own fake world.
    Returns (Traced or None, meta)."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    if not supports_shape(cfg, shape):
        return None, {"skipped": f"{arch} does not support {shape_name} (full attention; "
                                 f"see DESIGN)"}
    chips = 512 if multi_pod else 256
    train = shape.step == "train"
    with fake_world(chips), placed_layers(attn_chunk, seq_shard_attn):
        # the trainer's exchange stages card tensors through page-locked host
        # memory, which no fake tensor takes: its fake device is the host's
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu" if train else None)
        lead = node_axes(mesh)
        if train:
            traced = trace_train(cfg, mesh, lead, seq=shape.seq_len,
                                 global_batch=shape.global_batch, compressor=compressor,
                                 microbatches=microbatches, grad_accum_dtype=grad_accum_dtype)
        else:
            step = "prefill" if shape.step == "prefill" else "decode"
            traced = trace_serving(cfg, step, mesh, batch=shape.global_batch,
                                   seq=shape.seq_len, cache_len=shape.seq_len, lead=lead)
    meta = {"arch": arch, "shape": shape_name, "mesh": _mesh_name(multi_pod),
            "compile_s": round(traced.seconds, 1)}
    return traced, meta


def run_pair(arch: str, shape_name: str, multi_pod: bool, *, verbose: bool = True,
             compressor: str = "q4b", tag: str = "", out_dir: str = OUT_DIR, **lower_kw):
    cfg = get_config(arch)
    arch = cfg.name  # canonical id (e.g. "qwen3-1.7b")
    shape = SHAPES[shape_name]
    mesh_name = _mesh_name(multi_pod)
    try:
        traced, meta = lower_pair(arch, shape_name, multi_pod, compressor=compressor,
                                  **lower_kw)
    except Exception as e:
        traceback.print_exc()
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "error": f"{type(e).__name__}: {e}"}
    if traced is None:
        if verbose:
            print(f"SKIP {arch} x {shape_name}: {meta['skipped']}")
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name, **meta}

    chips = 512 if multi_pod else 256
    report = roofline_terms(traced.cost, traced.mem, arch=arch, shape=shape_name,
                            mesh_name=meta["mesh"], chips=chips,
                            model_flops=model_flops_for(cfg, shape))
    row = report.row()
    row["compile_s"] = meta["compile_s"]
    if tag:
        row["tag"] = tag
    if verbose:
        print({k: v for k, v in traced.mem.items()})
        print({"flops": traced.cost.flops, "bytes accessed": traced.cost.bytes})
        print(f"{arch} x {shape_name} @ {meta['mesh']}: "
              f"compute={report.compute_s * 1e3:.2f}ms memory={report.memory_s * 1e3:.2f}ms "
              f"collective={report.collective_s * 1e3:.2f}ms dominant={report.dominant} "
              f"useful_flops={report.useful_flops_frac:.2%} (traced {traced.ops} ops in "
              f"{meta['compile_s']}s)")
    os.makedirs(out_dir, exist_ok=True)
    suffix = f"_{tag}" if tag else ""
    fname = os.path.join(out_dir, f"{arch.replace('.', '_')}_{shape_name}_{meta['mesh']}"
                                  f"{suffix}.json")
    with open(fname, "w") as f:
        json.dump(row, f, indent=1)
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default=None, help="architecture id (default: all)")
    ap.add_argument("--shape", default=None, choices=list(SHAPES),
                    help="input shape (default: all)")
    ap.add_argument("--multi-pod", action="store_true", help="use the 2x16x16 512-device mesh")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true", help="every (arch x shape)")
    ap.add_argument("--compressor", default="q4b")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--tag", default="", help="variant tag for perf experiments")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-accum-dtype", default="float32")
    ap.add_argument("--attn-chunk", type=int, default=None,
                    help="override layers.CHUNK_THRESHOLD (query-chunked attention)")
    ap.add_argument("--seq-shard-attn", action="store_true",
                    help="context-parallel attention: shard the query-seq dim over `model`")
    ap.add_argument("--out-dir", default=OUT_DIR, help="where the JSON rows go")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else [a.replace("_", "-") for a in ARCHS]
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    t0 = time.perf_counter()
    results = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                suffix = f"_{args.tag}" if args.tag else ""
                name = get_config(arch).name.replace(".", "_")
                fname = os.path.join(args.out_dir, f"{name}_{shape}_{_mesh_name(mp)}{suffix}.json")
                if args.skip_existing and os.path.exists(fname):
                    print(f"EXISTS {arch} x {shape} @ {_mesh_name(mp)}")
                    continue
                results.append(run_pair(arch, shape, mp, compressor=args.compressor,
                                        tag=args.tag, out_dir=args.out_dir,
                                        microbatches=args.microbatches,
                                        grad_accum_dtype=args.grad_accum_dtype,
                                        attn_chunk=args.attn_chunk,
                                        seq_shard_attn=args.seq_shard_attn))

    errs = [r for r in results if "error" in r]
    print(f"\n== dry-run summary: {len(results) - len(errs)}/{len(results)} OK, in "
          f"{time.perf_counter() - t0:.1f} s ==")
    for r in errs:
        print(f"FAIL {r['arch']} x {r['shape']} @ {r['mesh']}: {r['error']}")
    return 1 if errs else 0


if __name__ == "__main__":
    raise SystemExit(main())
