"""Stochastic b-bit quantization with bit-packing, and its inverse: the
``quantize`` / ``dequantize`` CUDA kernels' wrappers and plain versions.

Replaces ``repro/kernels/quantize.py::quantize_pallas`` and
``dequantize_pallas``.  Layout as there: a flat vector padded to
``[rows, 128]`` f32 with ``rows % (8 * 8/bits) == 0``; levels pack ``8/bits``
consecutive rows per byte, signs 8 rows per byte.  The norm and the dequant
scale are f32 tensors on the data's device (the kernels read them there, so
no host synchronisation sits in the round).

CPU tensors take the plain version; CUDA tensors launch the kernel (built
from ``csrc/quantize.cu``) or raise.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import LANES, dequantize_ref, quantize_ref

BITS = (1, 2, 4, 8)

quantize_launches = _build.LaunchCounter("quantize")
dequantize_launches = _build.LaunchCounter("dequantize")

_Q_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
_DQ_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]


def _scalar_on(x: torch.Tensor, value) -> torch.Tensor:
    t = torch.as_tensor(value, dtype=torch.float32, device=x.device)
    if t.numel() != 1:
        raise ValueError(f"expected one scalar, got shape {tuple(t.shape)}")
    return t.reshape(1).contiguous()


def _check_grid(x: torch.Tensor, bits: int, what: str) -> int:
    if bits not in BITS:
        raise ValueError(f"{what}: bits must be one of {BITS}, got {bits}")
    if x.ndim != 2 or x.shape[1] != LANES or x.shape[0] % (8 * (8 // bits)):
        raise ValueError(f"{what}: expected [rows, {LANES}] with rows % {8 * (8 // bits)} == 0, "
                         f"got {tuple(x.shape)}")
    return x.shape[0]


def quantize_plain(x, xi, norm, bits: int):
    """Plain version: (packed levels [rows/pack, 128] u8, packed signs [rows/8, 128] u8)."""
    return quantize_ref(x, xi, norm, bits)


def dequantize_plain(packed_lvl, packed_sign, scale, bits: int):
    """Plain version: [rows, 128] f32, ``±level * scale``."""
    return dequantize_ref(packed_lvl, packed_sign, scale, bits)


def quantize(x: torch.Tensor, xi: torch.Tensor, norm, bits: int):
    """x, xi: [rows, 128] f32; norm: the tensor's f32 norm (a device scalar).

    Returns (packed_levels [rows/pack, 128] u8, packed_signs [rows/8, 128] u8).
    """
    if x.device.type == "cpu":
        return quantize_plain(x, xi, norm, bits)
    rows = _check_grid(x, bits, "quantize")
    norm = _scalar_on(x, norm)
    _build.check_cuda({"x": x, "xi": xi, "norm": norm}, "quantize")
    if x.dtype != torch.float32 or xi.dtype != torch.float32 or xi.shape != x.shape:
        raise TypeError(f"quantize takes f32 x and xi of one shape, got {x.dtype} "
                        f"{tuple(x.shape)} / {xi.dtype} {tuple(xi.shape)}")
    x, xi = x.contiguous(), xi.contiguous()
    lvl = torch.empty(rows * bits // 8, LANES, dtype=torch.uint8, device=x.device)
    sign = torch.empty(rows // 8, LANES, dtype=torch.uint8, device=x.device)
    fn = _build.function("quantize", "repro_quantize", _Q_ARGTYPES)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), xi.data_ptr(), norm.data_ptr(), lvl.data_ptr(), sign.data_ptr(),
                 rows, bits, _build.stream_ptr(x))
    _build.raise_on_error(err, "quantize")
    quantize_launches.add()
    return lvl, sign


def dequantize(packed_lvl: torch.Tensor, packed_sign: torch.Tensor, scale, bits: int):
    """Inverse of :func:`quantize` -> [rows, 128] f32; ``scale`` = norm / (2^b tau)."""
    if packed_lvl.device.type == "cpu":
        return dequantize_plain(packed_lvl, packed_sign, scale, bits)
    if bits not in BITS:
        raise ValueError(f"dequantize: bits must be one of {BITS}, got {bits}")
    rows = packed_lvl.shape[0] * (8 // bits)
    scale = _scalar_on(packed_lvl, scale)
    _build.check_cuda({"levels": packed_lvl, "signs": packed_sign, "scale": scale}, "dequantize")
    if (packed_lvl.dtype != torch.uint8 or packed_sign.dtype != torch.uint8
            or packed_lvl.ndim != 2 or packed_lvl.shape[1] != LANES
            or tuple(packed_sign.shape) != (rows // 8, LANES) or rows % 8):
        raise ValueError(f"dequantize: levels {tuple(packed_lvl.shape)} {packed_lvl.dtype} and "
                         f"signs {tuple(packed_sign.shape)} {packed_sign.dtype} do not match "
                         f"a [rows, {LANES}] grid at {bits} bits")
    packed_lvl, packed_sign = packed_lvl.contiguous(), packed_sign.contiguous()
    out = torch.empty(rows, LANES, dtype=torch.float32, device=packed_lvl.device)
    fn = _build.function("quantize", "repro_dequantize", _DQ_ARGTYPES)
    with torch.cuda.device(packed_lvl.device):
        err = fn(packed_lvl.data_ptr(), packed_sign.data_ptr(), scale.data_ptr(), out.data_ptr(),
                 rows, bits, _build.stream_ptr(packed_lvl))
    _build.raise_on_error(err, "dequantize")
    dequantize_launches.add()
    return out
