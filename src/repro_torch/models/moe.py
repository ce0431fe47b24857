"""Mixture-of-Experts FFN with sort-based capacity dispatch (PyTorch port of
``repro.models.moe``).

Routing is top-k softmax in f32; dispatch is the reference's static-shape
sort / gather scheme:

  1. top-k experts per token, gates renormalised;
  2. assignments sorted by expert id (stable argsort, so an expert keeps the
     first ``C`` of its tokens in token order);
  3. tokens past the capacity ``C = max(8, roundup8(ceil(cf * T * k / E)))``
     are dropped (GShard);
  4. tokens gathered into an ``[E, C, d]`` buffer (empty slots zero) by
     ``kernels/moe_dispatch.py``, whose backward sums each token's kept
     slots, and the experts run as three batched products;
  5. each token adds its kept slot outputs, gate-weighted, in ascending
     expert order into a zero of ``x.dtype``, as the reference's sequential
     scatter-add does (no atomics: two runs give the same bits), plus the
     always-on shared experts.

``apply_moe(..., per_row=True)`` routes each batch row on its own, with the
capacity of that row's tokens: the reference engine decodes one slot per
``vmap`` lane, so each slot's router sees ``T = 1``, and the port's batched
decode must drop exactly what that drops (nothing).  The reference computes
the router and the expert products outside any Pallas kernel, so plain
PyTorch is the port, but for the dispatch: a CUDA kernel each way
(``kernels/moe_dispatch.py``; why, in ``csrc/moe_dispatch.cu``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch import tracing
from repro_torch.kernels.moe_dispatch import moe_dispatch
from repro_torch.models.layers import apply_mlp, dense_init, init_mlp


def init_moe(gen, cfg, device):
    d, f, E = cfg.d_model, cfg.moe_d_ff or cfg.d_ff, cfg.num_experts
    dt = cfg.activation_dtype
    p = {
        "router": dense_init(gen, d, (d, E), torch.float32, device),
        "w_gate": dense_init(gen, d, (E, d, f), dt, device),
        "w_up": dense_init(gen, d, (E, d, f), dt, device),
        "w_down": dense_init(gen, f, (E, f, d), dt, device),
    }
    if cfg.num_shared_experts > 0:
        p["shared"] = init_mlp(gen, cfg, device, d_ff=f * cfg.num_shared_experts)
    return p


def capacity_for(tokens: int, cfg) -> int:
    c = int(math.ceil(cfg.capacity_factor * tokens * cfg.experts_per_token / cfg.num_experts))
    return max(8, -(-c // 8) * 8)


def select(params, x: torch.Tensor, cfg):
    """The router over x [G, T, d]: f32 softmax probabilities [G, T, E] and
    the top-k gates (renormalised with ``max(sum, 1e-9)``) and expert ids
    [G, T, K]."""
    probs = torch.softmax(x.float() @ params["router"], dim=-1)
    gate_vals, expert_idx = torch.topk(probs, cfg.experts_per_token, dim=-1)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)
    return probs, gate_vals, expert_idx


def route(params, x: torch.Tensor, cfg) -> dict:
    """Routing of each group's tokens on its own.  x: [G, T, d].

    Returns ``expert_idx`` / ``gates`` [G, T, K] (top-k order), ``counts``
    [G, E] (assignments per expert, dropped ones included), ``src_tok``
    [G, E, C] (the token in each slot; ``T`` for an empty slot),
    ``gate_slot`` [G, E, C] f32, ``slot`` / ``kept`` [G, T, K] (each
    assignment's flat slot ``e * C + c`` and whether it is within capacity),
    the same in ascending expert order, ``slot_by_expert`` /
    ``kept_by_expert`` (the order the dispatch's backward and the combine
    sum a token's slots in), and ``aux`` [G] (the Switch load-balance loss
    ``E * sum(me * ce)``).
    """
    G, T, _ = x.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    C = capacity_for(T, cfg)
    dev = x.device
    probs, gate_vals, expert_idx = select(params, x, cfg)

    flat_e = expert_idx.reshape(G, T * K)
    counts = torch.zeros(G, E, dtype=torch.long, device=dev).scatter_add_(
        1, flat_e, torch.ones_like(flat_e))
    aux = E * (probs.mean(1) * (counts.float() / (T * K))).sum(-1)

    order = torch.argsort(flat_e, dim=-1, stable=True)
    st = order // K  # token of each sorted assignment
    sg = torch.gather(gate_vals.reshape(G, T * K), 1, order)
    starts = torch.cumsum(counts, -1) - counts
    cs = torch.arange(C, device=dev)
    valid = cs[None, None, :] < torch.clamp(counts, max=C)[..., None]  # [G, E, C]
    slot_src = torch.where(valid, starts[..., None] + cs, T * K).reshape(G, E * C)
    st_pad = torch.cat([st, torch.full((G, 1), T, dtype=st.dtype, device=dev)], 1)
    sg_pad = torch.cat([sg, torch.zeros(G, 1, dtype=sg.dtype, device=dev)], 1)
    src_tok = torch.gather(st_pad, 1, slot_src).reshape(G, E, C)
    gate_slot = torch.where(valid, torch.gather(sg_pad, 1, slot_src).reshape(G, E, C), 0.0)

    # each assignment's rank within its expert: its place in the sorted
    # order less the expert's start
    places = torch.arange(T * K, device=dev).expand(G, -1)
    rank = torch.empty_like(order).scatter_(1, order, places)
    rank = rank - torch.gather(starts, 1, flat_e)
    kept = (rank < C).reshape(G, T, K)
    slot = (flat_e * C + torch.clamp(rank, max=C - 1)).reshape(G, T, K)
    by_expert = torch.argsort(expert_idx, dim=-1)  # top-k ids are distinct
    return dict(expert_idx=expert_idx, gates=gate_vals, counts=counts, src_tok=src_tok,
                gate_slot=gate_slot, slot=slot, kept=kept,
                slot_by_expert=torch.gather(slot, 2, by_expert),
                kept_by_expert=torch.gather(kept, 2, by_expert), aux=aux, capacity=C)


def apply_moe(params, x: torch.Tensor, cfg, *, per_row: bool = False):
    """x: [B, S, d] -> (y [B, S, d], aux).

    One routing group of all ``B * S`` tokens (the reference's call), or with
    ``per_row`` one group per batch row.  ``aux`` is the groups' Switch loss
    summed (the reference's scalar for one group).
    """
    B, S, d = x.shape
    xg = x.reshape(1, B * S, d) if not per_row else x
    G, T, _ = xg.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    # each section's span marks its tensors (under the profiler only) so that
    # its backward runs inside ``<section>.backward``
    with tracing.span("moe.route") as sec:
        r = route(params, sec.input(xg), cfg)
        r["gate_slot"], r["aux"] = sec.output(r["gate_slot"], r["aux"])
    C = r["capacity"]

    slots, kept = r["slot_by_expert"], r["kept_by_expert"]
    with tracing.span("moe.dispatch") as sec:
        eb = sec.output(moe_dispatch(sec.input(xg), r["src_tok"], slots, kept))  # [E, G*C, d]
    with tracing.span("moe.experts") as sec:
        eb = sec.input(eb)
        h = F.silu(torch.bmm(eb, params["w_gate"])) * torch.bmm(eb, params["w_up"])
        yb = torch.bmm(h, params["w_down"]).reshape(E, G, C, d).transpose(0, 1)  # [G, E, C, d]
        yb = sec.output(yb)

    with tracing.span("moe.combine") as sec:
        yb, gate_slot = sec.input(yb, r["gate_slot"])
        weighted = (yb * gate_slot[..., None].to(yb.dtype)).reshape(G, E * C, d)
        # each token's kept slots in ascending expert order
        y = torch.zeros(G, T, d, dtype=x.dtype, device=x.device)
        for k in range(K):
            w = torch.gather(weighted, 1, slots[..., k, None].expand(G, T, d))
            y = torch.where(kept[..., k, None], y + w, y)
        y = sec.output(y.reshape(B, S, d))
    if "shared" in params:
        with tracing.span("moe.shared") as sec:
            shared = apply_mlp(params["shared"], sec.input(x).reshape(B * S, d))
            y = y + sec.output(shared.reshape(B, S, d))
    return y, r["aux"].sum()
