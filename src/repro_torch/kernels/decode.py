"""Decode attention: the ``decode_attn`` CUDA kernel's wrapper, its plain
version, and a plain twin of the kernel's split-L plan.

Replaces ``repro/kernels/decode.py::decode_attention_pallas``; the plain
version is the counterpart of its XLA twin ``decode_attention_fused_xla``.
One query token per head attends a ``[B, L, KV, hd]`` cache under a
``[B, L]`` valid mask (linear cache or wrapped ring buffer); grouped heads
share one pass over K/V.  With ``k_scale``/``v_scale`` the cache is int8 and
the kernel's quantized variant dequantizes inside its contractions; that
variant counts its launches separately.

The kernel cuts L into chunks of whole 64-row tiles (:func:`split_plan`), one
block per (chunk, kv head, batch row); tiles with no live row are skipped
and each chunk leaves an f32 partial ``(m, l, acc)`` that the last of its
row's blocks to finish combines.  Head dims 64, 128 and 256 and 1 to 64
query heads per kv head: past 2 heads, or at hd 256, a wider body runs the
same plan -- for bf16 queries on the tensor cores (the G heads padded to
16-row tiles; P split into two bf16 halves, so it keeps about 16 bits), for
f32 queries on the CUDA cores.  :func:`decode_attention_split` runs that
plan on the host, for the CPU tests, and with ``tensor_cores=True`` also the
tensor-core body's arithmetic.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import NEG_INF, decode_attention_ref

launches = _build.LaunchCounter("decode_attention")
launches_int8 = _build.LaunchCounter("decode_attention_int8")

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128, 256)
#: query heads per kv head (``csrc/decode_attn.cu::MAX_GROUP``); past 2, or at
#: hd 256, the kernel's wide body runs the same plan
_MAX_GROUP = 64
_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]
#: cache rows per tile of the kernel; a chunk is a whole number of tiles
TILE = 64
#: blocks the plan aims at before it merges tiles into longer chunks: a wave
#: of 128-thread blocks at full occupancy on the H100's 132 SMs
MAX_BLOCKS = 16 * 132
#: chunks per cache row at most (the combining block keeps a weight for each)
MAX_SPLITS = 256
#: chunks x query heads per cache row at most (``csrc/decode_attn.cu::
#: MAX_PARTIALS``: the (m, l) pairs the tensor-core body's combine keeps)
MAX_PARTIALS = 2048
#: cache rows a chunk holds per query head at least where the partials go
#: through device memory: a chunk's f32 partial (G x hd floats) then stays at
#: most a quarter of its bf16 K/V bytes
ROWS_PER_HEAD = 4
#: chunks of a cache row that the wide body combines in one thread-block
#: cluster, through distributed shared memory (``csrc/decode_attn.cu::
#: MAX_CLUSTER``), and the tiles a chunk may hold to fit a row in one
CLUSTER, CLUSTER_TILES = 8, 4


def split_plan(B: int, KV: int, L: int, G: int = 1) -> tuple[int, int]:
    """``(chunk, splits)``: cache rows per block, a multiple of ``TILE``, and
    ``ceil(L / chunk)`` chunks.  Past 2 query heads per kv head a cache row
    of at most ``CLUSTER x CLUSTER_TILES`` tiles is cut into at most
    ``CLUSTER`` chunks (one cluster, whose blocks combine on chip).  Else the
    ``splits x KV x B`` grid holds at most about ``MAX_BLOCKS`` blocks (one
    tile per block while that fits), a cache row at most ``MAX_SPLITS``
    chunks and ``MAX_PARTIALS`` partials (chunks x ``G``), and a chunk at
    least ``ROWS_PER_HEAD x G`` rows."""
    tiles = -(-L // TILE)
    if G > 2 and tiles <= CLUSTER * CLUSTER_TILES:
        per = -(-tiles // CLUSTER)
    else:
        per = max(1, -(-(tiles * B * KV) // MAX_BLOCKS), -(-tiles // MAX_SPLITS),
                  -(-(ROWS_PER_HEAD * G) // TILE), -(-tiles // (MAX_PARTIALS // G)))
    chunk = TILE * per
    return chunk, -(-L // chunk)


def decode_attention_plain(q, k, v, valid, *, scale=None, k_scale=None, v_scale=None):
    """Plain version: materialized single-query softmax (fused dequant)."""
    return decode_attention_ref(q, k, v, valid, scale=scale, k_scale=k_scale, v_scale=v_scale)


def decode_attention_split(q, k, v, valid, *, scale=None, k_scale=None, v_scale=None,
                           tensor_cores=False):
    """The kernel's plan in plain PyTorch (f32): the chunks of :func:`split_plan`
    tile by tile with an online softmax, tiles without a live row skipped,
    dead rows contributing nothing (their K/V never read), the per-chunk
    partials ``(m, l, acc)`` and the combine; a batch row with no live row
    takes the uniform mean of V over all L.  Same arguments and result as
    :func:`decode_attention_plain`.  With ``tensor_cores`` (bf16 queries),
    the tensor-core body's arithmetic: the raw queries times K with the scale
    on the f32 scores, and P.V as ``bf16(p).V + bf16(p - bf16(p)).V``.
    Float64 queries (and K/V) run the plan in float64: an oracle whose
    rounding stays far below the f32 bound."""
    B, KV, G, hd = q.shape
    L = k.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    quant = k_scale is not None
    chunk, splits = split_plan(B, KV, L, G)
    ct = torch.float64 if q.dtype == torch.float64 else torch.float32  # compute type
    qs = q.to(ct) if tensor_cores else q.to(ct) * scale
    opts = dict(dtype=ct, device=q.device)
    m = torch.full((B, KV, splits, G), -math.inf, **opts)
    l = torch.zeros(B, KV, splits, G, **opts)
    acc = torch.zeros(B, KV, splits, G, hd, **opts)
    for s in range(splits):
        run_m = torch.full((B, KV, G), -math.inf, **opts)
        run_l = torch.zeros(B, KV, G, **opts)
        run_acc = torch.zeros(B, KV, G, hd, **opts)
        for l0 in range(s * chunk, min((s + 1) * chunk, L), TILE):
            l1 = min(l0 + TILE, L)  # rows past L score -inf: weight exactly 0
            live = valid[:, l0:l1].bool()  # [B, n]
            took = live.any(1)  # tiles without a live row are skipped
            if not bool(took.any()):
                continue
            kt = torch.where(live[:, :, None, None], k[:, l0:l1].to(ct), 0.0)
            vt = torch.where(live[:, :, None, None], v[:, l0:l1].to(ct), 0.0)
            sc = torch.einsum("bngd,blnd->bngl", qs, kt)
            if tensor_cores:
                sc = sc * scale
            if quant:
                sc = sc * k_scale[:, l0:l1].permute(0, 2, 1)[:, :, None, :]
            sc = sc.masked_fill(~live[:, None, None, :], NEG_INF)
            m_new = torch.maximum(run_m, sc.amax(-1))
            p = torch.exp(sc - m_new[..., None])
            total = p.sum(-1)
            if quant:
                p = p * v_scale[:, l0:l1].permute(0, 2, 1)[:, :, None, :]
            alpha = torch.exp(run_m - m_new)
            t = took[:, None, None]
            run_l = torch.where(t, run_l * alpha + total, run_l)
            if tensor_cores:  # p as two bf16 halves, each product on f32 sums
                hi = p.to(torch.bfloat16).float()
                pv = (torch.einsum("bngl,blnd->bngd", hi, vt)
                      + torch.einsum("bngl,blnd->bngd", (p - hi).to(torch.bfloat16).float(), vt))
            else:
                pv = torch.einsum("bngl,blnd->bngd", p, vt)
            run_acc = torch.where(t[..., None], run_acc * alpha[..., None] + pv, run_acc)
            run_m = torch.where(t, m_new, run_m)
        m[:, :, s], l[:, :, s], acc[:, :, s] = run_m, run_l, run_acc
    # combine: empty chunks (m = -inf) carry no weight and no acc
    big = m.amax(2, keepdim=True)
    empty = m == -math.inf
    w = torch.where(empty, 0.0, torch.exp(m - torch.where(empty, 0.0, big)))
    lsum = (w * l).sum(2)
    out = (w[..., None] * torch.where(empty[..., None], 0.0, acc)).sum(2)
    out = out / torch.clamp(lsum, min=1e-30)[..., None]
    vf = v.to(ct) * (v_scale[..., None] if quant else 1.0)
    uniform = (vf.sum(1) / L)[:, :, None, :].expand(B, KV, G, hd)  # no live row at all
    out = torch.where(big[:, :, 0, :, None] == -math.inf, uniform, out)
    return out.to(q.dtype)


_WORKSPACE: dict[tuple[int, int], tuple[torch.Tensor, torch.Tensor]] = {}


def _workspace(dev: torch.device, stream: int, n: int, rows: int):
    """The kernel's scratch for launches on ``stream``: ``n`` f32 for the
    partials and ``rows`` int32 completion counts, zero between calls (the
    kernel sets each back to 0).  One pair per (device, stream), grown when a
    call needs more; calls on one stream run in order, so a call's partials
    and counts are done with before the next call's kernel starts."""
    key = (dev.index, stream)
    work = _WORKSPACE.get(key)
    if work is None or work[0].numel() < n or work[1].numel() < rows:
        work = (torch.empty(max(n, 1 << 16), dtype=torch.float32, device=dev),
                torch.zeros(max(rows, 1024), dtype=torch.int32, device=dev))
        _WORKSPACE[key] = work
    return work


def _refuse(q, k, v, valid, k_scale, v_scale):
    """Raise for what the kernel does not take (no-op when all is well)."""
    quantized = k_scale is not None
    tensors = {"q": q, "k": k, "v": v, "valid": valid}
    if quantized:
        tensors.update(k_scale=k_scale, v_scale=v_scale)
    _build.check_cuda(tensors, "decode_attn")
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"decode_attn {name} must be contiguous")
    if q.ndim != 4 or k.ndim != 4:
        raise ValueError(f"decode_attn q{tuple(q.shape)} and k{tuple(k.shape)} must be 4-D")
    B, KV, G, hd = q.shape
    L = k.shape[1]
    if q.dtype not in _DTYPES:
        raise TypeError(f"decode_attn takes f32 or bf16 queries, got {q.dtype}")
    cache_dtype = torch.int8 if quantized else q.dtype
    if k.dtype != cache_dtype or v.dtype != cache_dtype:
        raise TypeError(f"decode_attn cache dtype {k.dtype}/{v.dtype}, expected {cache_dtype}")
    if k.shape != (B, L, KV, hd) or v.shape != k.shape or valid.shape != (B, L):
        raise ValueError(f"decode_attn shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)} valid{tuple(valid.shape)}")
    if quantized and (k_scale.shape != (B, L, KV) or v_scale.shape != (B, L, KV)
                      or k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32):
        raise ValueError("decode_attn scales must be f32 [B, L, KV]")
    if hd not in _HEAD_DIMS or not 1 <= G <= _MAX_GROUP:
        raise ValueError(f"decode_attn supports head_dim in {_HEAD_DIMS} and 1..{_MAX_GROUP} "
                         f"query heads per kv head, got hd={hd} G={G}")
    if not 1 <= B <= 65535 or not 1 <= KV <= 65535 or L < 1:
        raise ValueError(f"decode_attn grid: B={B}, KV={KV} (max 65535), L={L}")
    if valid.dtype != torch.bool:
        raise TypeError(f"decode_attn valid must be bool, got {valid.dtype}")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("decode_attn K and V must start on a 16-byte boundary")


_FNS: dict[str, object] = {}


def _launch(q, k, v, valid, scale, k_scale, v_scale, symbol="repro_decode_attn"):
    quantized = k_scale is not None
    dev = q.device
    # one pass over what the kernel needs; the detailed checks name the fault
    ok = (dev.type == "cuda" and q.ndim == 4 and k.ndim == 4 and valid.dtype == torch.bool
          and q.dtype in _DTYPES and k.dtype == v.dtype
          and k.dtype == (torch.int8 if quantized else q.dtype)
          and k.device == dev and v.device == dev and valid.device == dev
          and k.is_contiguous() and v.is_contiguous() and valid.is_contiguous()
          and not k.data_ptr() % 16 and not v.data_ptr() % 16)
    if ok:
        B, KV, G, hd = q.shape
        L = k.shape[1]
        ok = (k.shape == (B, L, KV, hd) and v.shape == k.shape and valid.shape == (B, L)
              and hd in _HEAD_DIMS and 1 <= G <= _MAX_GROUP and B <= 65535 and KV <= 65535
              and L >= 1 and B >= 1 and KV >= 1)
        if ok and quantized:
            ok = (k_scale.device == dev and v_scale.device == dev
                  and k_scale.dtype == torch.float32 and v_scale.dtype == torch.float32
                  and k_scale.shape == (B, L, KV) and v_scale.shape == (B, L, KV)
                  and k_scale.is_contiguous() and v_scale.is_contiguous())
    if not ok:
        _refuse(q, k, v, valid, k_scale, v_scale)
        raise ValueError("decode_attn: arguments the kernel does not take")
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    chunk, splits = split_plan(B, KV, L, G)
    n_part = B * KV * splits * G
    stream = torch.cuda.current_stream(dev).cuda_stream
    part, counts = _workspace(dev, stream, n_part * (hd + 2), B * KV)
    out = torch.empty_like(q)
    fn = _FNS.get(symbol)
    if fn is None:
        fn = _FNS[symbol] = _build.function("decode_attn", symbol, _ARGTYPES)
    acc_ptr = part.data_ptr()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(),
            k_scale.data_ptr() if quantized else None,
            v_scale.data_ptr() if quantized else None, out.data_ptr(),
            acc_ptr, acc_ptr + 4 * n_part * hd, counts.data_ptr(), _DTYPES[q.dtype],
            int(quantized), B, L, KV, G, hd, chunk, float(scale), stream)
    if torch.cuda.current_device() == dev.index:
        err = fn(*args)
    else:
        with torch.cuda.device(dev):
            err = fn(*args)
    _build.raise_on_error(err, "decode_attn")
    (launches_int8 if quantized else launches).add()
    return out


def decode_attention(q, k, v, valid, *, scale=None, k_scale=None, v_scale=None):
    """q: [B, KV, G, hd]; k, v: [B, L, KV, hd]; valid: [B, L] bool
    -> [B, KV, G, hd].  CPU tensors take the plain version; CUDA tensors
    launch the kernel."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale come together")
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, valid, scale=scale, k_scale=k_scale,
                                      v_scale=v_scale)
    return _launch(q.contiguous(), k, v, valid, scale, k_scale, v_scale)


def decode_attention_wide_body(q, k, v, valid, *, scale=None, k_scale=None, v_scale=None):
    """The kernel's wide body at any shape the kernel takes, also where the
    split body runs (hd 64 / 128 with at most 2 query heads per kv head): for
    timing the two bodies on the same inputs.  CUDA tensors only."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale come together")
    return _launch(q.contiguous(), k, v, valid, scale, k_scale, v_scale,
                   "repro_decode_attn_wide")
