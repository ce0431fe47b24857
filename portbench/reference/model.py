"""The plain reference of the benchmark's models: an all-attention decoder
(dense GELU or SwiGLU FFN, or a mixture of experts with shared experts) and
its next-token loss, in float32 with TF32 off, written from the layer
equations with plain ``torch`` operations.  It imports nothing of the port.

Layers, as the configurations state them: RMSNorm or LayerNorm (eps 1e-6),
grouped-query attention with half-split rotary embeddings, causal softmax
attention, a tied unembedding; a MoE layer routes each token to the top-k
experts of a float32 softmax router, renormalises the k gates, keeps each
expert's first ``C = max(8, roundup8(ceil(cf * T * k / E)))`` assignments
in token order (GShard capacity) and adds the shared experts; the loss is
the mean next-token cross entropy plus ``router_aux_weight`` times the
Switch load-balance loss ``E * sum_e mean_t(p_te) * count_e / (T k)`` of
every MoE layer.

``precision="fp8"`` is the correctness control: every matrix product's
operands are rounded to float8 e4m3 (one scale per tensor, amax to 448)
before a float32 product, the precision below the configurations' bfloat16.
``precision="bf16"`` rounds them to bfloat16, the program's own precision
(``calibrate.py --look`` compares it with float32).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

NEG_INF = -1e30
FP8_MAX = 448.0


class Matmul:
    """The reference's matrix products: float32, or float32 over operands
    rounded to float8 e4m3 or bfloat16 (straight through in the backward)."""

    def __init__(self, precision: str = "f32"):
        if precision not in ("f32", "fp8", "bf16"):
            raise ValueError(f"unknown precision {precision!r}")
        self.precision = precision

    def _q(self, x: torch.Tensor) -> torch.Tensor:
        if self.precision == "f32":
            return x
        if self.precision == "bf16":
            return x + (x.detach().to(torch.bfloat16).float() - x.detach())
        amax = x.detach().abs().amax().clamp(min=1e-30)
        scale = amax / FP8_MAX
        q = (x.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
        return x + (q - x.detach())

    def __call__(self, spec: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.einsum(spec, self._q(a), self._q(b))


def norm(p: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    if "bias" in p:
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        return (x - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * p["scale"]


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Half-split rotary embedding of x [B, S, H, hd] at positions 0..S-1."""
    S, hd = x.shape[1], x.shape[-1]
    half = hd // 2
    freqs = torch.exp(-torch.arange(half, dtype=torch.float32, device=x.device)
                      * (math.log(theta) / half))
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(p: dict, x: torch.Tensor, m: dict, mm: Matmul) -> torch.Tensor:
    B, S, _ = x.shape
    H, KV = m["num_heads"], m["num_kv_heads"]
    hd = p["wq"].shape[-1]
    q = mm("bsd,dhk->bshk", x, p["wq"])
    k = mm("bsd,dhk->bshk", x, p["wk"])
    v = mm("bsd,dhk->bshk", x, p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if "q_norm" in p:
        q = norm({"scale": p["q_norm"]}, q)
        k = norm({"scale": p["k_norm"]}, k)
    q, k = rope(q, m.get("rope_theta", 10_000.0)), rope(k, m.get("rope_theta", 10_000.0))
    k = k.repeat_interleave(H // KV, dim=2)  # query head j*G+g reads kv head j
    v = v.repeat_interleave(H // KV, dim=2)
    logits = mm("bqhk,bshk->bhqs", q, k) / math.sqrt(hd)
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    probs = torch.softmax(logits.masked_fill(~causal, NEG_INF), dim=-1)
    out = mm("bhqs,bshk->bqhk", probs, v)
    y = mm("bshk,hkd->bsd", out, p["wo"])
    return y + p["bo"] if "bo" in p else y


def mlp(p: dict, x: torch.Tensor, mm: Matmul) -> torch.Tensor:
    if "w_gate" in p:
        h = F.silu(mm("...d,df->...f", x, p["w_gate"])) * mm("...d,df->...f", x, p["w_up"])
        return mm("...f,fd->...d", h, p["w_down"])
    h = mm("...d,df->...f", x, p["w1"])
    if "b1" in p:
        h = h + p["b1"]
    y = mm("...f,fd->...d", F.gelu(h, approximate="tanh"), p["w2"])
    return y + p["b2"] if "b2" in p else y


def capacity(tokens: int, m: dict) -> int:
    c = math.ceil(m.get("capacity_factor", 1.25) * tokens * m["experts_per_token"]
                  / m["num_experts"])
    return max(8, -(-c // 8) * 8)


def moe(p: dict, x: torch.Tensor, m: dict, mm: Matmul):
    """x [B, S, d] -> (y, Switch aux loss): all B * S tokens route together."""
    B, S, d = x.shape
    xt = x.reshape(B * S, d)
    T, E, K = xt.shape[0], m["num_experts"], m["experts_per_token"]
    C = capacity(T, m)
    probs = torch.softmax(mm("td,de->te", xt, p["router"]), dim=-1)
    top, idx = torch.topk(probs, K, dim=-1)
    gates = top / torch.clamp(top.sum(-1, keepdim=True), min=1e-9)
    counts = torch.bincount(idx.reshape(-1), minlength=E).float()
    aux = E * (probs.mean(0) * counts / (T * K)).sum()
    y = torch.zeros_like(xt)
    for e in range(E):
        tok, slot = torch.nonzero(idx == e, as_tuple=True)  # token order
        tok, slot = tok[:C], slot[:C]
        if tok.numel() == 0:
            continue
        xe = xt[tok]
        h = F.silu(mm("td,df->tf", xe, p["w_gate"][e])) * mm("td,df->tf", xe, p["w_up"][e])
        ye = mm("tf,fd->td", h, p["w_down"][e])
        y = y.index_add(0, tok, ye * gates[tok, slot][:, None])
    if "shared" in p:
        y = y + mlp(p["shared"], xt, mm)
    return y.reshape(B, S, d), aux


def layer_at(stacked, b: int):
    if isinstance(stacked, dict):
        return {k: layer_at(v, b) for k, v in stacked.items()}
    return stacked[b]


def layers(params: dict, m: dict):
    """(layer params, is MoE) in global order."""
    out = [(p, False) for p in params.get("prefix", [])]
    for stacked in params.get("blocks", []):
        nb = next(iter(_leaves(stacked))).shape[0]
        pre = len(out)
        out += [(layer_at(stacked, b), m.get("num_experts", 0) > 0
                 and pre + b >= m.get("first_dense_layers", 0)) for b in range(nb)]
    return out


def _leaves(t):
    if isinstance(t, dict):
        for v in t.values():
            yield from _leaves(v)
    else:
        yield t


def block(p: dict, x: torch.Tensor, aux: torch.Tensor, m: dict, mm: Matmul, is_moe: bool):
    """One layer: attention and FFN (dense or MoE) with pre-norms."""
    x = x + attention(p["mixer"], norm(p["norm1"], x), m, mm)
    h = norm(p["norm2"], x)
    if is_moe:
        y, a = moe(p["ffn"], h, m, mm)
        return x + y, aux + a
    return x + mlp(p["ffn"], h, mm), aux


def loss(params: dict, tokens: torch.Tensor, m: dict, mm: Matmul) -> torch.Tensor:
    """Mean next-token cross entropy of tokens [B, S] plus the router term."""
    table = params["embed"]["table"]
    x = table[tokens.long()]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for p, is_moe in layers(params, m):
        # each layer's activations are made again in the backward, so that
        # one layer's float32 activations are held at a time
        x, aux = checkpoint(block, p, x, aux, m, mm, is_moe, use_reentrant=False)
    x = norm(params["final_norm"], x)
    logits = mm("bsd,vd->bsv", x[:, :-1], table)
    targets = tokens[:, 1:].long()
    nll = torch.logsumexp(logits, -1) - torch.gather(logits, -1, targets[..., None])[..., 0]
    return nll.mean() + m.get("router_aux_weight", 0.01) * aux
