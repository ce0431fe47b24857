"""Shared transformer layers (PyTorch port of ``repro.models.layers``):
norms, RoPE, GQA self- and cross-attention (prefill and decode), MLPs,
embeddings.

Functional style over dicts of tensors, with the reference's layouts:
activations ``[B, S, d]``; ``wq`` ``[d, H, hd]``, ``wk``/``wv``
``[d, KV, hd]``, ``wo`` ``[H, hd, d]``; caches ``[B, L, KV, hd]``; query
heads kv-major (head ``j*G+g`` belongs to kv head ``j``).

Attention above ``CHUNK_THRESHOLD`` tokens is query-chunked so long prefills
never hold a full ``[S, S]`` score matrix.  Decode updates the cache in
place (the reference returns a new cache; updating in place keeps one copy
of a multi-GiB cache on the card) and takes per-row positions.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.kernels.block_sparse import BlockSparsePattern
from repro_torch.kernels.ref import NEG_INF

CHUNK_THRESHOLD = 4096
QUERY_CHUNK = 1024


# ---------------------------------------------------------------------- init
def dense_init(gen, fan_in, shape, dtype, device):
    scale = 1.0 / math.sqrt(fan_in)
    w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return w.mul_(scale).to(dtype)  # in place: one f32 temporary (8.4 GB for command-r's embed)


# --------------------------------------------------------------------- norms
def init_norm(cfg, device, d=None):
    d = d or cfg.d_model
    dt = cfg.activation_dtype
    p = {"scale": torch.ones(d, dtype=dt, device=device)}
    if cfg.norm_type == "layernorm":
        p["bias"] = torch.zeros(d, dtype=dt, device=device)
    return p


def apply_norm(params, x, eps=1e-6):
    xf = x.float()
    if "bias" in params:
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        out = (xf - mu) * torch.rsqrt(var + eps)
        out = out * params["scale"].float() + params["bias"].float()
    else:
        ms = (xf * xf).mean(-1, keepdim=True)
        out = xf * torch.rsqrt(ms + eps) * params["scale"].float()
    return out.to(x.dtype)


# ---------------------------------------------------------------------- rope
def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Half-split rotary embedding. x: [B, S, H, hd]; positions: [B, S] or [S]."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = torch.exp(
        -torch.arange(0, half, dtype=torch.float32, device=x.device) * (math.log(theta) / half)
    )
    if positions.dim() == 1:
        positions = positions[None, :]
    angles = positions[..., None].float() * freqs  # [B, S, half]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------- attention
def init_attention(gen, cfg, device, cross: bool = False):
    d, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    dt = cfg.activation_dtype
    p = {
        "wq": dense_init(gen, d, (d, H, hd), dt, device),
        "wk": dense_init(gen, d, (d, KV, hd), dt, device),
        "wv": dense_init(gen, d, (d, KV, hd), dt, device),
        "wo": dense_init(gen, H * hd, (H, hd, d), dt, device),
    }
    if cfg.use_bias:
        p["bq"] = torch.zeros(H, hd, dtype=dt, device=device)
        p["bk"] = torch.zeros(KV, hd, dtype=dt, device=device)
        p["bv"] = torch.zeros(KV, hd, dtype=dt, device=device)
        p["bo"] = torch.zeros(d, dtype=dt, device=device)
    if cfg.qk_norm and not cross:
        p["q_norm"] = torch.ones(hd, dtype=dt, device=device)
        p["k_norm"] = torch.ones(hd, dtype=dt, device=device)
    return p


def _qk_normalize(v, scale):
    vf = v.float()
    ms = (vf * vf).mean(-1, keepdim=True)
    return (vf * torch.rsqrt(ms + 1e-6) * scale.float()).to(v.dtype)


def _project_qkv(params, x, cfg, positions, kv_src=None):
    """q from ``x``, k and v from ``kv_src`` (cross-attention: no rope) or
    from ``x`` (self-attention: rope at ``positions``)."""
    cross = kv_src is not None
    kv_in = kv_src if cross else x
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    k = torch.einsum("bsd,dhk->bshk", kv_in, params["wk"])
    v = torch.einsum("bsd,dhk->bshk", kv_in, params["wv"])
    if "bq" in params:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    if "q_norm" in params:
        q = _qk_normalize(q, params["q_norm"])
        k = _qk_normalize(k, params["k_norm"])
    if not cross:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _repeat_kv(k: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, S, KV, hd] -> [B, S, H, hd] by repeating groups (kv-major heads)."""
    kv = k.shape[2]
    if kv == num_heads:
        return k
    return torch.repeat_interleave(k, num_heads // kv, dim=2)


def _attend(q, k, v, mask, scale):
    """q: [B, Sq, H, hd], k, v: [B, Sk, H, hd], mask: [B?, Sq, Sk] or None."""
    logits = torch.einsum("bqhk,bshk->bhqs", q, k).float() * scale
    if mask is not None:
        logits = logits.masked_fill(~mask[:, None], NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqs,bshk->bqhk", probs, v)


@functools.lru_cache(maxsize=64)
def _sparse_pattern(seq: int, window, block: int) -> BlockSparsePattern:
    if window is None:
        return BlockSparsePattern.causal_pattern(seq, seq, block, block)
    return BlockSparsePattern.windowed(seq, seq, window, block, block)


def _kernel_attention(q, k, v, kernel: str, window: int | None):
    """Route [B, S, H, hd] q/k/v through a kernel of ``kernels/``, or return
    None when no kernel fits the shape (the caller keeps the plain path, as
    the reference does: block-sparse needs a block of 128/64/32/16/8 that
    divides S)."""
    S = q.shape[1]
    if kernel == "flash":
        if window is not None and S >= 256:
            return ops.sliding_window_attention(q, k, v, window=window)
        return ops.flash_attention(q, k, v, causal=True, window=window)
    if kernel == "block_sparse":
        block = next((b for b in (128, 64, 32, 16, 8) if S % b == 0), None)
        if block is None:
            return None
        return ops.block_sparse_attention(q, k, v, _sparse_pattern(S, window, block))
    raise ValueError(f"unknown attn_kernel {kernel!r}")


def apply_attention(params, x, cfg, *, causal: bool = True, window: int | None = None,
                    kv_src=None, return_kv: bool = False):
    """Prefill / training attention; query-chunked beyond CHUNK_THRESHOLD.

    ``kv_src`` [B, Sk, d] makes it cross-attention (whisper's decoder over
    the encoder output: no rope, no mask).  Only causal self-attention takes
    ``cfg.attn_kernel``; cross and non-causal attention keep the plain path,
    as the reference dispatches them.  With ``return_kv`` also returns the
    (rope'd, unrepeated) k and v [B, Sk, KV, hd], which prefill writes into
    the cache.
    """
    B, S, _ = x.shape
    cross = kv_src is not None
    Sk = kv_src.shape[1] if cross else S
    positions = torch.arange(S, device=x.device)
    q, k0, v0 = _project_qkv(params, x, cfg, positions, kv_src)
    k = _repeat_kv(k0, cfg.num_heads)
    v = _repeat_kv(v0, cfg.num_heads)
    scale = 1.0 / math.sqrt(cfg.hd)

    kernel = cfg.attn_kernel
    out = None
    if kernel is not None and causal and not cross:
        out = _kernel_attention(q, k, v, kernel, window)
    if out is None:
        def mask_for(q_pos):
            if cross or (not causal and window is None):
                return None
            kpos = torch.arange(Sk, device=x.device)
            m = torch.ones(q_pos.shape[0], Sk, dtype=torch.bool, device=x.device)
            if causal:
                m &= q_pos[:, None] >= kpos[None, :]
            if window is not None:
                m &= q_pos[:, None] - kpos[None, :] < window
            return m.expand(B, q_pos.shape[0], Sk)

        if S <= CHUNK_THRESHOLD:
            out = _attend(q, k, v, mask_for(torch.arange(S, device=x.device)), scale)
        else:
            if S % QUERY_CHUNK:
                raise ValueError("long-seq prefill requires seq % QUERY_CHUNK == 0")
            outs = []
            for c in range(S // QUERY_CHUNK):
                qpos = c * QUERY_CHUNK + torch.arange(QUERY_CHUNK, device=x.device)
                qc = q[:, c * QUERY_CHUNK:(c + 1) * QUERY_CHUNK]
                outs.append(_attend(qc, k, v, mask_for(qpos), scale))
            out = torch.cat(outs, dim=1)

    y = torch.einsum("bshk,hkd->bsd", out, params["wo"])
    if "bo" in params:
        y = y + params["bo"]
    return (y, (k0, v0)) if return_kv else y


# --------------------------------------------------------------- decode path
def init_attn_cache(cfg, batch: int, length: int, device, dtype=None):
    dt = dtype or cfg.activation_dtype
    shape = (batch, length, cfg.num_kv_heads, cfg.hd)
    if cfg.quantized_kv:
        # int8 cache + per-(slot, kv-head) scales, dequantized inside the
        # decode kernel
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.zeros(shape[:3], dtype=torch.float32, device=device),
            "v_scale": torch.zeros(shape[:3], dtype=torch.float32, device=device),
        }
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def row_positions(pos, batch: int, device) -> torch.Tensor:
    """int or [B] tensor of context lengths -> [B] long tensor on ``device``
    (one host-to-device copy for an int: convert once per decode step)."""
    p = torch.as_tensor(pos, device=device).to(torch.long).reshape(-1)
    return p.expand(batch) if p.numel() == 1 else p


def store_rows(dst: torch.Tensor, rows: torch.Tensor, slot: torch.Tensor,
               src: torch.Tensor) -> None:
    """``dst[rows[i], slot[i]] = src[i]`` in place: one decode step's cache
    write (``launch/dryrun.py`` swaps in its form for placed caches)."""
    dst[rows, slot] = src


def decode_attention(params, x, cache: dict, pos, cfg, *, window: int | None = None,
                     cross_kv=None):
    """One-token decode.  x: [B, 1, d]; pos: int or [B] long (tokens so far,
    per row).  Writes the new K/V into ``cache`` in place (ring buffer when
    ``window``) and returns ``(y, cache)``.  With ``cross_kv`` (whisper: the
    encoder's K/V [B, Sk, KV, hd], computed at prefill) it attends those on
    the plain path, as the reference does, and leaves ``cache`` alone."""
    B = x.shape[0]
    if cross_kv is not None:
        q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
        if "bq" in params:
            q = q + params["bq"]
        k, v = (_repeat_kv(t, cfg.num_heads) for t in cross_kv)
        out = _attend(q, k, v, None, 1.0 / math.sqrt(cfg.hd))
        y = torch.einsum("bshk,hkd->bsd", out, params["wo"])
        if "bo" in params:
            y = y + params["bo"]
        return y, cache
    length = cache["k"].shape[1]
    pos = row_positions(pos, B, x.device)
    q, k, v = _project_qkv(params, x, cfg, pos[:, None])

    rows = torch.arange(B, device=x.device)
    if window is not None:
        slot = torch.remainder(pos, length)
    else:
        slot = torch.clamp(pos, max=length - 1)  # the reference's update clamps too
    quantized = "k_scale" in cache
    if quantized:
        kq, ks = ops.quantize_kv(k)
        vq, vs = ops.quantize_kv(v)
        new = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    else:
        new = {"k": k.to(cache["k"].dtype), "v": v.to(cache["v"].dtype)}
    for name, t in new.items():
        store_rows(cache[name], rows, slot, t[:, 0])

    idx = torch.arange(length, device=x.device)
    if window is not None:
        # ring slot i is live iff its latest write is within the window
        age = torch.remainder(slot[:, None] - idx[None, :], length)  # 0 = newest
        valid = age < torch.clamp(pos + 1, max=length)[:, None]
    else:
        valid = idx[None, :] <= pos[:, None]

    if quantized or cfg.attn_kernel is not None:
        out = ops.decode_attention_kernel(
            q, cache["k"], cache["v"], valid,
            k_scale=cache.get("k_scale"), v_scale=cache.get("v_scale"),
        ).to(x.dtype)
    else:
        kk = _repeat_kv(cache["k"].to(x.dtype), cfg.num_heads)
        vv = _repeat_kv(cache["v"].to(x.dtype), cfg.num_heads)
        out = _attend(q, kk, vv, valid[:, None, :], 1.0 / math.sqrt(cfg.hd))
    y = torch.einsum("bshk,hkd->bsd", out, params["wo"])
    if "bo" in params:
        y = y + params["bo"]
    return y, cache


# ----------------------------------------------------------------------- mlp
def init_mlp(gen, cfg, device, d_ff=None):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    dt = cfg.activation_dtype
    if cfg.mlp_type == "swiglu":
        return {
            "w_gate": dense_init(gen, d, (d, f), dt, device),
            "w_up": dense_init(gen, d, (d, f), dt, device),
            "w_down": dense_init(gen, f, (f, d), dt, device),
        }
    p = {"w1": dense_init(gen, d, (d, f), dt, device),
         "w2": dense_init(gen, f, (f, d), dt, device)}
    if cfg.use_bias:
        p["b1"] = torch.zeros(f, dtype=dt, device=device)
        p["b2"] = torch.zeros(d, dtype=dt, device=device)
    return p


def apply_mlp(params, x):
    if "w_gate" in params:
        h = F.silu(x @ params["w_gate"]) * (x @ params["w_up"])
        return h @ params["w_down"]
    h = x @ params["w1"]
    if "b1" in params:
        h = h + params["b1"]
    h = F.gelu(h, approximate="tanh")  # jax.nn.gelu's default form
    y = h @ params["w2"]
    if "b2" in params:
        y = y + params["b2"]
    return y


# ----------------------------------------------------------------- embedding
def init_embedding(gen, cfg, device):
    return {"table": dense_init(gen, cfg.d_model, (cfg.vocab_size, cfg.d_model),
                                cfg.activation_dtype, device)}


def embed(params, tokens):
    return F.embedding(tokens.long(), params["table"])


def unembed(params, x):
    """Tied unembedding: logits against ``embed.table``."""
    return torch.einsum("bsd,vd->bsv", x, params["table"])
