"""Decode attention: the ``decode_attn`` CUDA kernel's wrapper and its plain
version.

Replaces ``repro/kernels/decode.py::decode_attention_pallas``; the plain
version is the counterpart of its XLA twin ``decode_attention_fused_xla``.
One query token per head attends a ``[B, L, KV, hd]`` cache under a
``[B, L]`` valid mask (linear cache or wrapped ring buffer); grouped heads
share one pass over K/V.  With ``k_scale``/``v_scale`` the cache is int8 and
the kernel's quantized variant dequantizes inside its contractions; that
variant counts its launches separately.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import decode_attention_ref

launches = _build.LaunchCounter("decode_attention")
launches_int8 = _build.LaunchCounter("decode_attention_int8")

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
_MAX_GROUP = 8
_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]


def decode_attention_plain(q, k, v, valid, *, scale=None, k_scale=None, v_scale=None):
    """Plain version: materialized single-query softmax (fused dequant)."""
    return decode_attention_ref(q, k, v, valid, scale=scale, k_scale=k_scale, v_scale=v_scale)


def _launch(q, k, v, valid, scale, k_scale, v_scale):
    quantized = k_scale is not None
    tensors = {"q": q, "k": k, "v": v, "valid": valid}
    if quantized:
        tensors.update(k_scale=k_scale, v_scale=v_scale)
    _build.check_cuda(tensors, "decode_attn")
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"decode_attn {name} must be contiguous")
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
    if B > 65535 or L < 1:
        raise ValueError(f"decode_attn grid: B={B} (max 65535), L={L}")
    if valid.dtype != torch.bool:
        raise TypeError(f"decode_attn valid must be bool, got {valid.dtype}")
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    out = torch.empty_like(q)
    fn = _build.function("decode_attn", "repro_decode_attn", _ARGTYPES)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(),
                 k_scale.data_ptr() if quantized else None,
                 v_scale.data_ptr() if quantized else None, out.data_ptr(),
                 _DTYPES[q.dtype], int(quantized), B, L, KV, G, hd, float(scale),
                 _build.stream_ptr(q))
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
