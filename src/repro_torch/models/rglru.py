"""RG-LRU recurrent block (PyTorch port of ``repro.models.rglru``; RecurrentGemma
/ Griffin [arXiv:2402.19427]).

Griffin's recurrent block: two branches — a GeLU gate branch and a
(causal conv -> RG-LRU) branch — multiplied and projected out.  The RG-LRU
is a gated linear recurrence

    r_t = sigmoid(W_a u_t);  i_t = sigmoid(W_x u_t)
    log a_t = -c * softplus(Lambda) * r_t            (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t ⊙ u_t)

evaluated over the sequence by a log-depth scan (first-order linear
recurrences compose associatively; the reference uses
``jax.lax.associative_scan``), and as an O(1) update in decode.

Dtypes follow the reference: ``lamb`` and the state ``h`` are f32, the gates
are computed in f32 from f32 products, the conv tail is in the activation
dtype.  The scan has no TPU kernel in the reference, so plain PyTorch is the
port.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init

C_FACTOR = 8.0
CONV_WIDTH = 4
LAMB_INIT = 0.65  # softplus -> a ~ exp(-8 * 1.05 * r)


def init_rglru(gen, cfg, device):
    d = cfg.d_model
    dr = cfg.rglru_width or cfg.d_model
    dt = cfg.activation_dtype
    return {
        "w_gate_branch": dense_init(gen, d, (d, dr), dt, device),
        "w_in": dense_init(gen, d, (d, dr), dt, device),
        "conv_w": dense_init(gen, CONV_WIDTH, (CONV_WIDTH, dr), dt, device),
        "conv_b": torch.zeros(dr, dtype=dt, device=device),
        "w_a": dense_init(gen, dr, (dr, dr), dt, device),
        "w_x": dense_init(gen, dr, (dr, dr), dt, device),
        "lamb": torch.full((dr,), LAMB_INIT, dtype=torch.float32, device=device),
        "w_out": dense_init(gen, dr, (dr, d), dt, device),
    }


def _gelu(x):
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default form


def _causal_conv(u, w, b):
    """Depthwise causal conv over the sequence: u [B, S, dr], w [W, dr]."""
    W, S = w.shape[0], u.shape[1]
    pad = F.pad(u, (0, 0, W - 1, 0))
    out = pad[:, 0:S] * w[0]
    for i in range(1, W):
        out = out + pad[:, i:i + S] * w[i]
    return out + b


def _gates(params, u):
    uf = u.float()
    r = torch.sigmoid(uf @ params["w_a"].float())
    i = torch.sigmoid(uf @ params["w_x"].float())
    lamb = params["lamb"]
    log_a = -C_FACTOR * torch.logaddexp(lamb, torch.zeros_like(lamb)) * r  # softplus
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * uf)
    return a, b


def _scan(a, b):
    """Inclusive scan of ``(a_t, b_t)`` under ``(a1, b1) . (a2, b2) = (a1 a2,
    a2 b1 + b2)`` along axis 1, Hillis-Steele: ceil(log2 S) passes of
    elementwise ops over the whole tensor.  Returns (prod of a, h)."""
    S = a.shape[1]
    d = 1
    while d < S:
        a, b = (torch.cat([a[:, :d], a[:, :-d] * a[:, d:]], 1),
                torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], 1))
        d *= 2
    return a, b


def rglru_scan(params, u: torch.Tensor, init_state=None):
    """u: [B, S, dr] -> (h [B, S, dr] in u's dtype, final_state [B, dr] f32)."""
    a, b = _gates(params, u)  # [B, S, dr] f32
    acc_a, h = _scan(a, b)
    if init_state is not None:
        h = h + acc_a * init_state[:, None, :].float()
    return h.to(u.dtype), h[:, -1, :]


def apply_rglru(params, x: torch.Tensor, cfg, init_state=None, return_state: bool = False):
    """Griffin recurrent block.  x: [B, S, d] -> [B, S, d] (and, with
    ``return_state``, the decode state ``{h, conv}`` after the last token)."""
    gate = _gelu(x @ params["w_gate_branch"])
    conv_in = x @ params["w_in"]
    u = _causal_conv(conv_in, params["conv_w"], params["conv_b"])
    h0 = init_state["h"] if init_state is not None else None
    h, final = rglru_scan(params, u, init_state=h0)
    out = (gate * h) @ params["w_out"]
    if not return_state:
        return out
    # the last CONV_WIDTH - 1 conv inputs (zeros before the first token)
    tail = F.pad(conv_in, (0, 0, CONV_WIDTH - 1, 0))[:, -(CONV_WIDTH - 1):]
    return out, {"h": final, "conv": tail}


# ------------------------------------------------------------------- decode
def init_rglru_cache(cfg, batch: int, device):
    dr = cfg.rglru_width or cfg.d_model
    return {
        "h": torch.zeros(batch, dr, dtype=torch.float32, device=device),
        "conv": torch.zeros(batch, CONV_WIDTH - 1, dr, dtype=cfg.activation_dtype, device=device),
    }


def decode_rglru(params, x: torch.Tensor, cache: dict, cfg):
    """x: [B, 1, d] -> (y [B, 1, d], cache), the cache updated in place."""
    gate = _gelu(x[:, 0] @ params["w_gate_branch"])  # [B, dr]
    cin = x[:, 0] @ params["w_in"]
    window = torch.cat([cache["conv"], cin[:, None, :].to(cache["conv"].dtype)], dim=1)
    u = torch.einsum("bwc,wc->bc", window, params["conv_w"]) + params["conv_b"]
    a, b = _gates(params, u[:, None, :])
    h = a[:, 0] * cache["h"] + b[:, 0]
    out = (gate * h.to(x.dtype)) @ params["w_out"]
    cache["h"].copy_(h)
    cache["conv"].copy_(window[:, 1:])
    return out[:, None, :], cache
