"""Block top-k: the ``block_topk`` CUDA kernel's wrapper and its plain version.

Replaces ``repro/kernels/topk.py::block_topk_pallas``.  ``x`` is ``[rows,
block]`` f32 (one compression block per row); each row is masked to its k
largest magnitudes by ``BISECT_ITERS`` rounds of threshold bisection, so the
result equals the reference kernel's bit for bit, ties included.

CPU tensors take the plain version; CUDA tensors launch the kernel (built
from ``csrc/block_topk.cu``) or raise.  The kernel's later rounds count only
the band of magnitudes still undecided; :func:`block_topk_band` runs those
rounds on the host, for the CPU tests.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import BISECT_ITERS, block_topk_ref

MAX_BLOCK = 2048

launches = _build.LaunchCounter("block_topk")

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_void_p]
#: the kernel takes the band only while ``hi`` is below this (no overflow in lo + hi)
BAND_HI_LIMIT = 1e38


def full_rounds(block: int) -> int:
    """Bisection rounds the kernel runs over every element of a row before it
    counts only the band [lo, hi) (``csrc/block_topk.cu``: 7 for rows of more
    than 1024 elements, else 6)."""
    return 7 if block > 1024 else 6


def block_topk_plain(x: torch.Tensor, k: int, iters: int = BISECT_ITERS) -> torch.Tensor:
    """Plain version: [rows, block] f32 masked to ~top-k per row."""
    return block_topk_ref(x, k, iters)


def block_topk_band(x: torch.Tensor, k: int, iters: int = BISECT_ITERS) -> torch.Tensor:
    """The kernel's rounds in plain PyTorch: :func:`full_rounds` counts over the
    whole row, then, every later ``mid`` lying in ``[lo, hi]``, each count
    as ``#{|x| >= hi}`` plus the count over the band ``[lo, hi)``.  The
    kernel keeps the band in lists of at most 4 elements per lane and
    falls back to full counts where a lane's list would overflow; both give
    the same integers, so this twin counts the whole band.  Equals
    :func:`block_topk_plain` bit for bit."""
    assert x.ndim == 2
    mag = x.abs()
    hi = mag.amax(dim=1, keepdim=True)
    lo = torch.zeros_like(hi)
    c_hi = torch.full_like(hi, -1, dtype=torch.int64)  # unknown until a round moves hi
    full = min(iters, full_rounds(x.shape[1]))
    for _ in range(full):
        mid = 0.5 * (lo + hi)
        cnt = (mag >= mid).sum(dim=1, keepdim=True)
        too_many = cnt > k
        lo = torch.where(too_many, mid, lo)
        hi = torch.where(too_many, hi, mid)
        c_hi = torch.where(too_many, c_hi, cnt)
    if iters > full:
        c_hi = torch.where(c_hi < 0, (mag >= hi).sum(dim=1, keepdim=True), c_hi)
        band = torch.where((mag >= lo) & (mag < hi), mag, torch.full_like(mag, -1.0))
        banded = hi < BAND_HI_LIMIT
        for _ in range(iters - full):
            mid = 0.5 * (lo + hi)
            cnt = torch.where(banded, c_hi + (band >= mid).sum(dim=1, keepdim=True),
                              (mag >= mid).sum(dim=1, keepdim=True))
            too_many = cnt > k
            lo = torch.where(too_many, mid, lo)
            hi = torch.where(too_many, hi, mid)
    return x * (mag >= hi).to(x.dtype)


def block_topk(x: torch.Tensor, k: int, iters: int = BISECT_ITERS) -> torch.Tensor:
    """x: [rows, block] f32 -> same shape, each row masked to its top k
    magnitudes (all entries tied at the threshold are kept)."""
    if x.device.type == "cpu":
        return block_topk_plain(x, k, iters)
    _build.check_cuda({"x": x}, "block_topk")
    if x.dtype != torch.float32 or x.ndim != 2:
        raise TypeError(f"block_topk takes [rows, block] f32, got {x.dtype} {tuple(x.shape)}")
    rows, block = x.shape
    if not 1 <= block <= MAX_BLOCK or rows < 1 or k < 1 or iters < 0:
        raise ValueError(f"block_topk: rows {rows}, block {block} (1..{MAX_BLOCK}), k {k}, "
                         f"iters {iters}")
    x = x.contiguous()
    out = torch.empty_like(x)
    fn = _build.function("block_topk", "repro_block_topk", _ARGTYPES)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), out.data_ptr(), rows, block, int(k), int(iters),
                 _build.stream_ptr(x))
    _build.raise_on_error(err, "block_topk")
    launches.add()
    return out
