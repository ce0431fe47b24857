"""Block-sparse attention: the pattern, the ``block_sparse_attn_fwd`` CUDA
kernel's wrapper and its plain PyTorch version.

Replaces ``repro/kernels/block_sparse.py::block_sparse_attention_pallas``.
The pattern is a per-(q-block, kv-block) bitmap with three states:

    0 -- skip: the kv block is never loaded or computed,
    1 -- partial: compute, then apply the element-level causal/window mask,
    2 -- full: compute with no element mask (every pair is live).

:class:`BlockSparsePattern` builds the bitmap on the host (numpy) for the
causal, causal+windowed and strided (local blocks + every ``stride``-th
earlier block) layouts, compacts it into per-q-block kv lists (the
reference's ``compact``), and re-tiles it to the kernel's tiles
(``kernel_tiles``): per query tile of ``tile_q`` rows, the ascending kv tiles
of ``TILE_K`` keys that hold a live pair, each with the mask it needs.  The
kernel walks those lists: O(density * S^2) work, any block size.  Patterns
keep the diagonal block live (the online softmax's finite ``-1e30`` sentinel
needs a live key per row); ``from_bitmap`` checks.

Layout: q, k, v are ``[B, S, H, hd]`` with kv heads already repeated (the
model's convention), read through their strides.  The kernel's lists and
the bitmap are uploaded once per pattern, device and tile shape.  CPU
tensors take the plain version; CUDA tensors launch the kernel (built from
``csrc/block_sparse_attn.cu``, the shared mainloop of
``csrc/attn_mainloop.cuh``).
"""
from __future__ import annotations

import ctypes
import dataclasses
import math

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import (MASK_BLOCKS, MASK_ELEM, MASK_NONE, TILE_K,
                                                 _DTYPES, _HEAD_DIMS, _rows_aligned, tile_q)
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
    # the kernel's tile lists and bitmap, per (device, tile_q) (filled at first launch)
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

    def kernel_tiles(self, tile_rows: int):
        """The pattern re-tiled to the kernel's (``tile_rows`` x ``TILE_K``)
        tiles: ``(entries [n_q_tiles, width] int32, counts [n_q_tiles]
        int32, width)``.  Row ``t`` of ``entries`` lists, ascending, the kv
        tiles holding a live (q, k) pair for a query of tile ``t``, each as
        ``kv_tile << 2 | mask``: ``MASK_NONE`` when every pair of the tile is
        live (rows past ``seq_q`` do not count, keys past ``seq_k`` are
        dead), ``MASK_ELEM`` when the pairs live are exactly those of the
        causal / window rule with ``k < seq_k``, else ``MASK_BLOCKS`` (the
        kernel reads the bitmap).

        Computed on rectangles: the row and key boundaries of blocks and
        tiles together cut the plane into pieces that each lie in one block
        pair and one tile pair, and on a piece the causal / window rule is a
        band of q - k, so whether some or all of its pairs live follows from
        the band's ends.
        """
        def cuts(n, block, tile):
            edges = np.union1d(np.arange(0, n, block), np.arange(0, n, tile))
            return edges, np.append(edges[1:], n)

        r0, r1 = cuts(self.seq_q, self.block_q, tile_rows)
        c0, c1 = cuts(self.seq_k, self.block_k, TILE_K)
        state = self.bitmap[(r0 // self.block_q)[:, None], (c0 // self.block_k)[None, :]]
        # q - k over a piece spans [lo, hi]; the causal / window rule keeps [0 | -inf, window - 1]
        lo = r0[:, None] - (c1[None, :] - 1)
        hi = (r1[:, None] - 1) - c0[None, :]
        keep_lo = 0 if self.causal else -np.inf
        keep_hi = self.window - 1 if self.window is not None else np.inf
        some = (lo <= keep_hi) & (hi >= keep_lo)
        every = (lo >= keep_lo) & (hi <= keep_hi)
        live_any = (state == FULL) | ((state == PARTIAL) & some)
        live_all = (state == FULL) | ((state == PARTIAL) & every)
        # the pattern keeps exactly the rule's pairs on this piece
        as_rule = ((state == PARTIAL) | ((state == FULL) & every)
                   | ((state == SKIP) & ~some))
        # reduce the pieces to tiles
        row_tile, key_tile = r0 // tile_rows, c0 // TILE_K
        n_qt, n_kt = -(-self.seq_q // tile_rows), -(-self.seq_k // TILE_K)
        any_t = np.zeros((n_qt, n_kt), bool)
        all_t = np.ones((n_qt, n_kt), bool)
        rule_t = np.ones((n_qt, n_kt), bool)
        at = (row_tile[:, None], key_tile[None, :])
        np.logical_or.at(any_t, at, live_any)
        np.logical_and.at(all_t, at, live_all)
        np.logical_and.at(rule_t, at, as_rule)
        all_t &= ((np.arange(n_kt) + 1) * TILE_K <= self.seq_k)[None, :]
        mask = np.where(all_t, MASK_NONE, np.where(rule_t, MASK_ELEM, MASK_BLOCKS))
        counts = any_t.sum(axis=1).astype(np.int32)
        width = max(int(counts.max()), 1)
        entries = np.zeros((n_qt, width), np.int32)
        for t in range(n_qt):
            kts = np.nonzero(any_t[t])[0]
            entries[t, : kts.size] = (kts << 2) | mask[t, kts]
        return entries, counts, width


def _device_lists(pattern: BlockSparsePattern, device: torch.device, tile_rows: int):
    """(entries, counts, bitmap, width) for the kernel on ``device``,
    uploaded once per device and tile shape."""
    key = (str(device), tile_rows)
    lists = pattern.device_lists.get(key)
    if lists is None:
        entries, counts, width = pattern.kernel_tiles(tile_rows)
        lists = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                      for a in (entries, counts, pattern.bitmap)) + (width,)
        pattern.device_lists[key] = lists
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
    entries, counts, bitmap, width = _device_lists(pattern, q.device, tile_q(Sq))
    out = torch.empty(B, Sq, H, hd, dtype=q.dtype, device=q.device)
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    fn = _build.function("block_sparse_attn", "repro_block_sparse_attn_fwd", _ARGTYPES)
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), entries.data_ptr(),
                 bitmap.data_ptr(), counts.data_ptr(), width, _DTYPES[q.dtype], B, H, Sq, Sk, hd,
                 pattern.block_q, pattern.block_k, *strides, float(scale),
                 int(bool(pattern.causal)),
                 int(pattern.window) if pattern.window is not None else 0, _build.stream_ptr(q))
    _build.raise_on_error(err, "block_sparse_attn_fwd")
    launches.add()
    return out
