"""Block top-k: the ``block_topk`` CUDA kernel's wrapper and its plain version.

Replaces ``repro/kernels/topk.py::block_topk_pallas``.  ``x`` is ``[rows,
block]`` f32 (one compression block per row); each row is masked to its k
largest magnitudes by ``BISECT_ITERS`` rounds of threshold bisection, so the
result equals the reference kernel's bit for bit, ties included.

CPU tensors take the plain version; CUDA tensors launch the kernel (built
from ``csrc/block_topk.cu``) or raise.
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


def block_topk_plain(x: torch.Tensor, k: int, iters: int = BISECT_ITERS) -> torch.Tensor:
    """Plain version: [rows, block] f32 masked to ~top-k per row."""
    return block_topk_ref(x, k, iters)


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
