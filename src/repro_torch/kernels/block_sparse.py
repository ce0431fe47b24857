"""Block-sparse attention: the pattern, the ``block_sparse_attn_fwd`` CUDA
kernel's wrapper and its plain PyTorch version.

Replaces ``repro/kernels/block_sparse.py::block_sparse_attention_pallas``.
The pattern is a per-(q-block, kv-block) bitmap with three states:

    0 -- skip: the kv block is never loaded or computed,
    1 -- partial: compute, then apply the element-level causal/window mask,
    2 -- full: compute with no element mask (every pair is live).

:class:`BlockSparsePattern` builds the bitmap on the host (numpy) for the
causal, causal+windowed and strided (local blocks + every ``stride``-th
earlier block) layouts and compacts it into per-q-block kv lists, which the
kernel walks: O(density * S^2) work.  Patterns keep the diagonal block live
(the online softmax's finite ``-1e30`` sentinel needs a live key per row);
``from_bitmap`` checks.

Layout: q, k, v are ``[B, S, H, hd]`` with kv heads already repeated (the
model's convention), read through their strides.  The compacted lists are
uploaded once per pattern and device.  CPU tensors take the plain version;
CUDA tensors launch the kernel (built from ``csrc/block_sparse_attn.cu``).
"""
from __future__ import annotations

import ctypes
import dataclasses
import math

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import _DTYPES, _HEAD_DIMS, _rows_aligned
from repro_torch.kernels.ref import block_sparse_attention_ref

SKIP, PARTIAL, FULL = 0, 1, 2

launches = _build.LaunchCounter("block_sparse_attention")

_ARGTYPES = (
    [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [ctypes.c_longlong] * 12
    + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
)


@dataclasses.dataclass(frozen=True)
class BlockSparsePattern:
    """Host-side block bitmap + compacted per-q-block kv index lists."""

    seq_q: int
    seq_k: int
    block_q: int
    block_k: int
    bitmap: np.ndarray  # [num_q, num_kv] int32 in {SKIP, PARTIAL, FULL}
    causal: bool
    window: int | None
    # the kernel's copies of compact(), per device (filled at first launch)
    device_lists: dict = dataclasses.field(default_factory=dict, init=False, repr=False,
                                           compare=False)

    @staticmethod
    def _pool(seq_q: int, seq_k: int, block_q: int, block_k: int,
              causal: bool, window: int | None) -> np.ndarray:
        """Pool the element-level (causal and window) mask into block states."""
        qp = np.arange(seq_q)[:, None]
        kp = np.arange(seq_k)[None, :]
        live = np.ones((seq_q, seq_k), bool)
        if causal:
            live &= qp >= kp
        if window is not None:
            live &= (qp - kp) < window
        nq, nk = seq_q // block_q, seq_k // block_k
        blocks = live.reshape(nq, block_q, nk, block_k)
        frac = blocks.sum(axis=(1, 3))
        full = frac == block_q * block_k
        return np.where(full, FULL, np.where(frac > 0, PARTIAL, SKIP)).astype(np.int32)

    @classmethod
    def causal_pattern(cls, seq_q: int, seq_k: int, block_q: int = 128,
                       block_k: int = 128) -> "BlockSparsePattern":
        bm = cls._pool(seq_q, seq_k, block_q, block_k, True, None)
        return cls(seq_q, seq_k, block_q, block_k, bm, True, None)

    @classmethod
    def windowed(cls, seq_q: int, seq_k: int, window: int, block_q: int = 128,
                 block_k: int = 128) -> "BlockSparsePattern":
        bm = cls._pool(seq_q, seq_k, block_q, block_k, True, window)
        return cls(seq_q, seq_k, block_q, block_k, bm, True, window)

    @classmethod
    def strided(cls, seq_q: int, seq_k: int, *, local_blocks: int, stride: int,
                block_q: int = 128, block_k: int = 128) -> "BlockSparsePattern":
        """Sparse-Transformer layout: each q block attends to the nearest
        ``local_blocks`` kv blocks plus every ``stride``-th block before."""
        pool = cls._pool(seq_q, seq_k, block_q, block_k, True, None)
        nq, nk = pool.shape
        qi = np.arange(nq)[:, None]
        kj = np.arange(nk)[None, :]
        allowed = (qi - kj < local_blocks) | (kj % stride == 0)
        bm = np.where(allowed, pool, SKIP).astype(np.int32)
        return cls(seq_q, seq_k, block_q, block_k, bm, True, None)

    @classmethod
    def from_bitmap(cls, bitmap: np.ndarray, *, block_q: int, block_k: int,
                    causal: bool = True, window: int | None = None) -> "BlockSparsePattern":
        bitmap = np.asarray(bitmap, np.int32)
        nq, nk = bitmap.shape
        pool = cls._pool(nq * block_q, nk * block_k, block_q, block_k, causal, window)
        if np.any((bitmap != SKIP) & (pool == SKIP)):
            raise ValueError("bitmap marks blocks live that the causal/window "
                             "mask fully excludes")
        diag = np.array([((i + 1) * block_q - 1) // block_k for i in range(nq)])
        if np.any(bitmap[np.arange(nq), np.minimum(diag, nk - 1)] == SKIP):
            raise ValueError("diagonal block must stay live (softmax carry "
                             "needs >= 1 live key per row)")
        return cls(nq * block_q, nk * block_k, block_q, block_k, bitmap, causal, window)

    def density(self) -> float:
        """Fraction of kv blocks computed (vs. a dense S x S sweep)."""
        return float((self.bitmap != SKIP).mean())

    def compact(self) -> tuple[np.ndarray, np.ndarray, np.ndarray, int]:
        """Per-q-block (kv_index, kv_state, count, max_count) int32 arrays."""
        nq, nk = self.bitmap.shape
        counts = (self.bitmap != SKIP).sum(axis=1).astype(np.int32)
        width = max(int(counts.max()), 1)
        idx = np.zeros((nq, width), np.int32)
        state = np.zeros((nq, width), np.int32)
        for i in range(nq):
            live = np.nonzero(self.bitmap[i] != SKIP)[0]
            idx[i, : live.size] = live
            state[i, : live.size] = self.bitmap[i, live]
        return idx, state, counts, width


def _device_lists(pattern: BlockSparsePattern, device: torch.device):
    """(kv_index, kv_state, count, width) on ``device``, uploaded once."""
    lists = pattern.device_lists.get(str(device))
    if lists is None:
        idx, state, counts, width = pattern.compact()
        lists = tuple(torch.from_numpy(a).to(device) for a in (idx, state, counts)) + (width,)
        pattern.device_lists[str(device)] = lists
    return lists


def block_sparse_attention_plain(q, k, v, pattern: BlockSparsePattern, *, scale=None):
    """Plain version over [B, S, H, hd] -> [B, Sq, H, hd]."""
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]

    def fold(x, s):
        return x.permute(0, 2, 1, 3).reshape(B * H, s, hd)

    out = block_sparse_attention_ref(fold(q, Sq), fold(k, Sk), fold(v, Sk), pattern, scale=scale)
    return out.reshape(B, H, Sq, hd).permute(0, 2, 1, 3)


def block_sparse_attention(q, k, v, pattern: BlockSparsePattern, *, scale=None):
    """Attention over [B, S, H, hd] restricted to ``pattern``'s live blocks.

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    if (Sq, Sk) != (pattern.seq_q, pattern.seq_k):
        raise ValueError(f"block_sparse_attention: q/k lengths {(Sq, Sk)} do not match the "
                         f"pattern's {(pattern.seq_q, pattern.seq_k)}")
    if q.device.type == "cpu":
        return block_sparse_attention_plain(q, k, v, pattern, scale=scale)
    _build.check_cuda({"q": q, "k": k, "v": v}, "block_sparse_attn_fwd")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"block_sparse_attn_fwd takes f32 or bf16 q/k/v of one dtype, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if k.shape != (B, Sk, H, hd) or v.shape != k.shape:
        raise ValueError(f"block_sparse_attn_fwd shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)}")
    if hd not in _HEAD_DIMS:
        raise ValueError(f"block_sparse_attn_fwd supports head_dim in {_HEAD_DIMS}, got {hd}")
    if pattern.block_q % 8 or B * H > 65535:
        raise ValueError(f"block_sparse_attn_fwd needs block_q % 8 == 0 (got {pattern.block_q}) "
                         f"and B*H <= 65535 (got {B * H})")
    if pattern.window is not None and pattern.window < 1:
        raise ValueError(f"block_sparse_attn_fwd window must be >= 1, got {pattern.window}")
    q, k, v = (t if _rows_aligned(t) else t.clone(memory_format=torch.contiguous_format)
               for t in (q, k, v))
    idx, state, counts, width = _device_lists(pattern, q.device)
    out = torch.empty(B, Sq, H, hd, dtype=q.dtype, device=q.device)
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    fn = _build.function("block_sparse_attn", "repro_block_sparse_attn_fwd", _ARGTYPES)
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), idx.data_ptr(),
                 state.data_ptr(), counts.data_ptr(), width, _DTYPES[q.dtype], B, H, Sq, Sk, hd,
                 pattern.block_q, pattern.block_k, *strides, float(scale),
                 int(bool(pattern.causal)),
                 int(pattern.window) if pattern.window is not None else 0, _build.stream_ptr(q))
    _build.raise_on_error(err, "block_sparse_attn_fwd")
    launches.add()
    return out
