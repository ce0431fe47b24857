"""Public attention ops over the model's layouts (attention half of
``repro.kernels.ops``).

Prefill: ``[B, S, H, hd]`` with kv heads already repeated.  Decode: a
``[B, 1, H, hd]`` query over a ``[B, L, KV, hd]`` cache, query heads
kv-major (head ``j*G+g`` belongs to kv head ``j``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import decode as _decode
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import sliding_window as _sliding
from repro_torch.kernels.ref import quantize_kv_ref


def flash_attention(q, k, v, *, causal: bool = True, window: int | None = None):
    """Flash attention over [B, S, H, hd]; ragged lengths are masked in the
    kernel, which equals the reference wrapper's pad / unpad result."""
    return _flash.flash_attention(q, k, v, causal=causal, window=window)


def sliding_window_attention(q, k, v, *, window: int):
    """Causal sliding-window attention over [B, S, H, hd]."""
    return _sliding.sliding_window_attention(q, k, v, window=window)


def decode_attention_kernel(q, k, v, valid, *, k_scale=None, v_scale=None):
    """Decode attention: q [B, 1, H, hd] over the cache -> [B, 1, H, hd]."""
    B, one, H, hd = q.shape
    if one != 1:
        raise ValueError(f"decode query must be [B, 1, H, hd], got {tuple(q.shape)}")
    KV = k.shape[2]
    qg = q.reshape(B, KV, H // KV, hd)
    out = _decode.decode_attention(qg, k, v, valid, k_scale=k_scale, v_scale=v_scale)
    return out.reshape(B, 1, H, hd)


def quantize_kv(x: torch.Tensor):
    """Per-(position, kv-head) int8 KV quantization; x: [..., hd] ->
    (int8 [..., hd], f32 scales [...])."""
    return quantize_kv_ref(x)
