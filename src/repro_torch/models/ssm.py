"""Mamba2 — state-space duality (SSD) mixer (PyTorch port of
``repro.models.ssm``; [arXiv:2405.21060]).

Prefill and training run the chunked SSD algorithm: the sequence is split
into chunks of length L; within a chunk the recurrence is a masked
attention-like product, and the state passes from chunk to chunk in a
Python loop (the reference's ``lax.scan``).  Decode is the O(1) recurrent
step.

Layout: x [B, S, d]; heads H = expand*d / head_dim P; shared B/C of state
size N (one group).  The recurrence per head h:

    state_t = exp(dt_t * A_h) * state_{t-1} + dt_t * x_t ⊗ B_t
    y_t     = C_t · state_t + D_h * x_t

Dtypes follow the reference: ``A_log``, ``D``, ``dt_bias``, the state and
the cumulative decays are f32; the conv tail is in the activation dtype.
The scan has no TPU kernel in the reference, so plain PyTorch is the port.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init

DT_BIAS_INIT = math.log(math.e - 1)  # softplus^-1(1)


def dims(cfg):
    di = cfg.ssm_expand * cfg.d_model
    H = di // cfg.ssm_head_dim
    N = cfg.ssm_state
    conv_ch = di + 2 * N
    return di, H, N, conv_ch


def init_mamba2(gen, cfg, device):
    d = cfg.d_model
    di, H, N, conv_ch = dims(cfg)
    dt = cfg.activation_dtype
    W = cfg.ssm_conv_width
    return {
        # order: [z (di), x (di), B (N), C (N), dt (H)]
        "in_proj": dense_init(gen, d, (d, 2 * di + 2 * N + H), dt, device),
        "conv_w": dense_init(gen, W, (W, conv_ch), dt, device),
        "conv_b": torch.zeros(conv_ch, dtype=dt, device=device),
        "A_log": torch.zeros(H, dtype=torch.float32, device=device),  # A = -exp(A_log) = -1
        "D": torch.ones(H, dtype=torch.float32, device=device),
        "dt_bias": torch.full((H,), DT_BIAS_INIT, dtype=torch.float32, device=device),
        "norm_scale": torch.ones(di, dtype=dt, device=device),
        "out_proj": dense_init(gen, di, (di, d), dt, device),
    }


def _split_proj(proj, cfg):
    di, H, N, _ = dims(cfg)
    z = proj[..., :di]
    x = proj[..., di:2 * di]
    b = proj[..., 2 * di:2 * di + N]
    c = proj[..., 2 * di + N:2 * di + 2 * N]
    dt = proj[..., 2 * di + 2 * N:]
    return z, x, b, c, dt


def _causal_conv(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d; u: [B, S, C], w: [W, C]."""
    W, S = w.shape[0], u.shape[1]
    pad = F.pad(u, (0, 0, W - 1, 0))
    out = pad[:, 0:S] * w[0]
    for i in range(1, W):
        out = out + pad[:, i:i + S] * w[i]
    return out + b


def _gated_norm(y, z, scale, eps=1e-6):
    """RMS norm of ``y * silu(z)`` over the whole inner width (one group)."""
    gf = (y * F.silu(z)).float()
    ms = (gf * gf).mean(-1, keepdim=True)
    return (gf * torch.rsqrt(ms + eps) * scale.float()).to(y.dtype)


def apply_mamba2(params, x: torch.Tensor, cfg) -> torch.Tensor:
    """Full-sequence (train/prefill) chunked SSD.  x: [B, S, d] -> [B, S, d]."""
    y, _ = mamba2_scan(params, x, cfg, return_state=False)
    return y


def mamba2_scan(params, x: torch.Tensor, cfg, return_state: bool = True, init_state=None):
    """Full-sequence chunked SSD.  x: [B, S, d] -> (y [B, S, d], state),
    ``state = {"ssm": [B, H, P, N] f32, "conv": [B, W-1, conv_ch]}`` (the
    last ``W-1`` pre-activation conv inputs) or None.  ``init_state``: the
    SSM state [B, H, P, N] f32 that enters the first chunk (default zeros);
    the conv starts from zeros either way, as in the reference."""
    B, S, d = x.shape
    di, H, N, conv_ch = dims(cfg)
    P = cfg.ssm_head_dim
    L = min(cfg.ssm_chunk, S)
    if S % L:
        raise ValueError(f"seq {S} must be divisible by ssm chunk {L}")
    nc = S // L

    proj = x @ params["in_proj"]
    z, xs, bs, cs, dts = _split_proj(proj, cfg)
    conv_in = torch.cat([xs, bs, cs], dim=-1)
    conv_out = F.silu(_causal_conv(conv_in, params["conv_w"], params["conv_b"]))
    xs, bs, cs = conv_out[..., :di], conv_out[..., di:di + N], conv_out[..., di + N:]

    xh = xs.reshape(B, S, H, P).float()
    bs, cs = bs.float(), cs.float()
    dt = F.softplus(dts.float() + params["dt_bias"])  # [B, S, H]
    A = -torch.exp(params["A_log"])  # [H], negative

    tril = torch.tril(torch.ones(L, L, dtype=torch.bool, device=x.device))
    state = (torch.zeros(B, H, P, N, dtype=torch.float32, device=x.device)
             if init_state is None else init_state)
    ys = []
    for c in range(nc):
        sl = slice(c * L, (c + 1) * L)
        xc, bc, cc, dtc = xh[:, sl], bs[:, sl], cs[:, sl], dt[:, sl]
        cum = torch.cumsum(dtc * A, dim=1)  # [B, L, H] inclusive, <= 0
        # intra-chunk: y_t += sum_{s<=t} exp(cum_t - cum_s) (C_t.B_s) dt_s x_s;
        # masked before exp (after it, inf * 0 = NaN on the upper triangle)
        diff = cum[:, :, None, :] - cum[:, None, :, :]  # [B, L, L, H]
        decay = torch.exp(torch.where(tril[None, :, :, None], diff, -math.inf))
        cb = torch.einsum("bln,bsn->bls", cc, bc)
        m = cb[..., None] * decay * dtc[:, None, :, :]  # [B, l, s, H]
        y = torch.einsum("blsh,bshp->blhp", m, xc)
        # inter-chunk: the incoming state's contribution
        y = y + torch.exp(cum)[..., None] * torch.einsum("bln,bhpn->blhp", cc, state)
        to_end = torch.exp(cum[:, -1:, :] - cum) * dtc  # [B, L, H]
        state = torch.exp(cum[:, -1, :])[:, :, None, None] * state + torch.einsum(
            "blh,blhp,bln->bhpn", to_end, xc, bc)
        ys.append(y + params["D"][None, None, :, None] * xc)
    y = torch.cat(ys, dim=1).reshape(B, S, di).to(x.dtype)

    out = _gated_norm(y, z, params["norm_scale"]) @ params["out_proj"]
    if not return_state:
        return out, None
    W = cfg.ssm_conv_width
    return out, {"ssm": state, "conv": conv_in[:, S - (W - 1):]}


# ----------------------------------------------------------------- decode
def init_mamba2_cache(cfg, batch: int, device):
    di, H, N, conv_ch = dims(cfg)
    return {
        "ssm": torch.zeros(batch, H, cfg.ssm_head_dim, N, dtype=torch.float32, device=device),
        "conv": torch.zeros(batch, cfg.ssm_conv_width - 1, conv_ch, dtype=cfg.activation_dtype,
                            device=device),
    }


def decode_mamba2(params, x: torch.Tensor, cache: dict, cfg):
    """One-token step.  x: [B, 1, d] -> (y [B, 1, d], cache), the cache
    updated in place."""
    B = x.shape[0]
    di, H, N, conv_ch = dims(cfg)
    P = cfg.ssm_head_dim

    proj = (x @ params["in_proj"])[:, 0]
    z, xs, bs, cs, dts = _split_proj(proj, cfg)
    conv_in = torch.cat([xs, bs, cs], dim=-1)  # [B, conv_ch]
    window = torch.cat([cache["conv"], conv_in[:, None, :].to(cache["conv"].dtype)], dim=1)
    conv_out = F.silu(torch.einsum("bwc,wc->bc", window, params["conv_w"]) + params["conv_b"])

    xs, bs, cs = conv_out[:, :di], conv_out[:, di:di + N], conv_out[:, di + N:]
    xh = xs.reshape(B, H, P).float()
    dt = F.softplus(dts.float() + params["dt_bias"])  # [B, H]
    da = torch.exp(dt * -torch.exp(params["A_log"]))

    state = cache["ssm"] * da[:, :, None, None] + torch.einsum(
        "bh,bhp,bn->bhpn", dt, xh, bs.float())
    y = torch.einsum("bn,bhpn->bhp", cs.float(), state)
    y = (y + params["D"][None, :, None] * xh).reshape(B, di).to(x.dtype)

    out = _gated_norm(y, z, params["norm_scale"]) @ params["out_proj"]
    cache["ssm"].copy_(state)
    cache["conv"].copy_(window[:, 1:])
    return out[:, None, :], cache
