"""Plain PyTorch oracles for the attention kernels (attention half of
``repro.kernels.ref``).

They compute exactly what the kernels compute, with materialized scores and
the same finite ``-1e30`` mask sentinel, in float32.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal=True, window=None, scale=None):
    """q, k, v: [BH, S, hd] -> [BH, Sq, hd] in q.dtype.

    Plain materialized-softmax attention with causal / sliding-window masks.
    """
    hd = q.shape[-1]
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    s = torch.einsum("bqk,bsk->bqs", q.float(), k.float()) * scale
    qpos = torch.arange(q.shape[1], device=q.device)
    kpos = torch.arange(k.shape[1], device=q.device)
    mask = torch.ones(q.shape[1], k.shape[1], dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos[:, None] >= kpos[None, :]
    if window is not None:
        mask &= qpos[:, None] - kpos[None, :] < window
    s = s.masked_fill(~mask[None], NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqs,bsk->bqk", p, v.float()).to(q.dtype)


def quantize_kv_ref(x: torch.Tensor):
    """Per-(position, kv-head) int8 symmetric quantization of a KV tensor.

    x: [..., hd] -> (int8 values [..., hd], f32 scales [...]).  scale =
    absmax/127; all-zero rows get scale 0.  ``torch.round`` rounds half to
    even, as ``jnp.round`` does, so the int8 values match the reference.
    """
    xf = x.float()
    absmax = xf.abs().amax(dim=-1)
    scale = absmax / 127.0
    safe = torch.where(absmax > 0, absmax, torch.ones_like(absmax))
    inv = torch.where(absmax > 0, 127.0 / safe, torch.zeros_like(absmax))
    q = torch.clamp(torch.round(xf * inv[..., None]), -127, 127).to(torch.int8)
    return q, scale


def decode_attention_ref(q, k, v, valid, *, scale=None, k_scale=None, v_scale=None):
    """Single-query grouped-query attention over a KV cache.

      q: [B, KV, G, hd]; k, v: [B, L, KV, hd] (float, or int8 with scales);
      valid: [B, L] bool; k_scale, v_scale: [B, L, KV] f32 -- k_scale scales
      the scores after QK, v_scale scales p before PV.
    Returns [B, KV, G, hd] in q.dtype.
    """
    hd = q.shape[-1]
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    kf, vf = k.float(), v.float()
    s = torch.einsum("bngd,blnd->bngl", q.float() * scale, kf)
    if k_scale is not None:
        s = s * k_scale.permute(0, 2, 1)[:, :, None, :]
    s = s.masked_fill(~valid[:, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    if v_scale is not None:
        p = p * v_scale.permute(0, 2, 1)[:, :, None, :]
    return torch.einsum("bngl,blnd->bngd", p, vf).to(q.dtype)
