"""Flash attention: the ``flash_attn_fwd`` CUDA kernel's wrapper, its plain
PyTorch version, and the kernel's tile schedule written out on the host.

Replaces ``repro/kernels/flash_attention.py::flash_attention_pallas``.  The
kernel (``csrc/flash_attn.cu``, the shared mainloop of
``csrc/attn_mainloop.cuh``) also serves ``kernels/sliding_window.py``: a
query tile visits only its live kv tiles, which is what the TPU's separate
sliding-window kernel was for.  Each wrapper keeps its own launch counter.

Layout: q, k, v are ``[B, S, H, hd]`` with kv heads already repeated to H
(the model's convention); the kernel reads them through their strides (bf16:
TMA tensor maps over the same view) and masks ragged lengths itself, so
nothing is folded, padded or copied.

bf16 runs on the tensor cores (head dims 64, 128 and 256; at 256 each
128-key tile arrives as two 64-key stages) and rounds each softmax
probability to bf16 once before the PV product, which the plain version (f32 throughout) does
not: the two differ by at most ``ref.p_rounding_bound`` per element beyond
the output's own rounding.  f32 runs on the CUDA cores in f32.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_attention_ref

launches = _build.LaunchCounter("flash_attention")

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128, 256)
#: keys per kv tile of both kernels (``csrc/attn_mainloop.cuh::TILE_K``)
TILE_K = 128
#: how the kernels mask a kv tile (``csrc/attn_mainloop.cuh::MASK_*``): not at
#: all (every pair live), by the causal / window rule and ``k < Sk``, or by
#: the block-sparse pattern's own rule (its bitmap)
MASK_NONE, MASK_ELEM, MASK_BLOCKS = 0, 1, 2
_ARGTYPES = (
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 12
    + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
)


def flash_attention_plain(q, k, v, *, causal=True, window=None, scale=None):
    """Plain version: materialized softmax over [B, S, H, hd] -> [B, Sq, H, hd]."""
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]

    def fold(x, s):
        return x.permute(0, 2, 1, 3).reshape(B * H, s, hd)

    out = flash_attention_ref(fold(q, Sq), fold(k, Sk), fold(v, Sk), causal=causal,
                              window=window, scale=scale)
    return out.reshape(B, H, Sq, hd).permute(0, 2, 1, 3)


def tile_q(seq_q: int) -> int:
    """Query rows per kernel tile (``csrc/attn_mainloop.cuh::tile_q_for``):
    two 64-row consumer warpgroups, or one when ``seq_q <= 64``."""
    return 64 if seq_q <= 64 else 128


def range_schedule(seq_q: int, seq_k: int, *, causal: bool,
                   window: int | None) -> list[list[tuple[int, int]]]:
    """The kv tiles each query tile of ``flash_attn_fwd`` visits, with their
    masks, as ``csrc/attn_mainloop.cuh::RangeSchedule`` computes them
    in-kernel: per query tile, ``[(kv_tile, MASK_*), ...]`` ascending.

    A query tile covers ``tile_q(seq_q)`` rows, a kv tile ``TILE_K`` keys.  The range runs from the first tile the window
    reaches to the last the causal limit allows; a tile is ``MASK_NONE`` when
    every (q, k) pair in it is live (rows past ``seq_q`` do not count, keys
    past ``seq_k`` are dead), else ``MASK_ELEM``.
    """
    bm = tile_q(seq_q)
    w = window or 0
    n_kv = -(-seq_k // TILE_K)
    out = []
    for qt in range(-(-seq_q // bm)):
        q0, q_last = qt * bm, min((qt + 1) * bm, seq_q) - 1
        first = max(q0 - w + 1, 0) // TILE_K if w > 0 else 0
        end = min(q_last // TILE_K + 1, n_kv) if causal else n_kv
        tiles = []
        for kt in range(first, end):
            k0, k_last = kt * TILE_K, (kt + 1) * TILE_K - 1
            full = (k_last < seq_k and (not causal or k_last <= q0)
                    and (w <= 0 or q_last - k0 < w))
            tiles.append((kt, MASK_NONE if full else MASK_ELEM))
        out.append(tiles)
    return out


def _rows_aligned(x: torch.Tensor) -> bool:
    """Head dim contiguous and every [b, s, h] row on a 16-byte boundary, at
    a positive stride (what a TMA tensor map takes; a broadcast view is
    copied)."""
    el = x.element_size()
    return (
        x.stride(3) == 1
        and x.data_ptr() % 16 == 0
        and all(x.stride(i) > 0 and (x.stride(i) * el) % 16 == 0 for i in range(3))
    )


def launch_flash(q, k, v, *, causal, window, scale, counter) -> torch.Tensor:
    """Launch ``flash_attn_fwd`` on CUDA tensors [B, S, H, hd]; count it."""
    _build.check_cuda({"q": q, "k": k, "v": v}, "flash_attn_fwd")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attn_fwd takes f32 or bf16 q/k/v of one dtype, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    if k.shape != (B, Sk, H, hd) or v.shape != k.shape:
        raise ValueError(f"flash_attn_fwd shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)}")
    if hd not in _HEAD_DIMS:
        raise ValueError(f"flash_attn_fwd supports head_dim in {_HEAD_DIMS}, got {hd}")
    if causal and Sq != Sk:
        raise ValueError("causal flash_attn_fwd needs Sq == Sk")
    if window is not None and window < 1:
        raise ValueError(f"flash_attn_fwd window must be >= 1, got {window}")
    if B * H > 65535 or Sq < 1 or Sk < 1:
        raise ValueError(f"flash_attn_fwd grid: B*H={B * H} (max 65535), Sq={Sq}, Sk={Sk}")
    q, k, v = (t if _rows_aligned(t) else t.clone(memory_format=torch.contiguous_format)
               for t in (q, k, v))
    out = torch.empty(B, Sq, H, hd, dtype=q.dtype, device=q.device)
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    fn = _build.function("flash_attn", "repro_flash_attn_fwd", _ARGTYPES)
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _DTYPES[q.dtype],
                 B, H, Sq, Sk, hd, *strides, float(scale), int(bool(causal)),
                 int(window) if window is not None else 0, _build.stream_ptr(q))
    _build.raise_on_error(err, "flash_attn_fwd")
    counter.add()
    return out


def flash_attention(q, k, v, *, causal=True, window=None, scale=None):
    """Causal / windowed attention over [B, S, H, hd] -> [B, Sq, H, hd].

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window, scale=scale)
    return launch_flash(q, k, v, causal=causal, window=window, scale=scale, counter=launches)
