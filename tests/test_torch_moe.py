"""repro_torch's MoE FFN (``models/moe.py``) against ``repro.models.moe``.

Reduced deepseek-moe-16b widths (d 256, expert d_ff 256, one shared expert)
in f32, JAX-initialised weights, numpy inputs from a seed.  Tolerances:
routing (the top-k expert ids, the per-expert counts, which token fills each
capacity slot, which assignments are kept) exactly equal; the layer output,
of unit scale, to ``1e-5`` relative to that scale (``rtol = atol = 1e-5``:
the same math, with f32 sums of 256 products in another order, ~1e-6
apart); the aux loss to ``1e-6``.  The decode case holds the port's batched ``decode_step``,
which routes each row on its own, against the JAX model decoded one slot per
``jax.vmap`` lane, as the reference engine decodes, to the model tolerance
of ``tests/test_torch_archs.py`` (``1e-4``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import moe as JM
from repro.models import transformer as JT
from repro_torch.configs import get_config as torch_config
from repro_torch.models import moe as TM
from repro_torch.models import transformer as TT
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ARCH = "deepseek-moe-16b"


def _cfgs(experts=4, **kw):
    return (dataclasses.replace(jax_config(ARCH).reduced(experts=experts), **kw),
            dataclasses.replace(torch_config(ARCH).reduced(experts=experts), **kw))


def _jax_route(params, xt, cfg):
    """The reference's routing and slot map (``repro/models/moe.py:58-90``,
    the same jnp operations): expert ids, counts, the token in each slot."""
    T = xt.shape[0]
    E, K = cfg.num_experts, cfg.experts_per_token
    C = JM.capacity_for(T, cfg)
    probs = jax.nn.softmax(xt.astype(jnp.float32) @ params["router"], axis=-1)
    _, expert_idx = jax.lax.top_k(probs, K)
    flat_e = expert_idx.reshape(T * K)
    flat_t = jnp.repeat(jnp.arange(T), K)
    order = jnp.argsort(flat_e, stable=True)
    se, st = flat_e[order], flat_t[order]
    counts = jnp.zeros((E,), jnp.int32).at[se].add(1)
    starts = jnp.cumsum(counts) - counts
    slot_src = starts[:, None] + jnp.arange(C)[None, :]
    valid = jnp.arange(C)[None, :] < jnp.minimum(counts, C)[:, None]
    slot_src = jnp.where(valid, slot_src, T * K)
    src_tok = jnp.concatenate([st, jnp.array([T], st.dtype)])[slot_src]
    return np.asarray(expert_idx), np.asarray(counts), np.asarray(src_tok)


def _moe_params(jcfg, tcfg, seed=0):
    jp = JM.init_moe(jax.random.PRNGKey(seed), jcfg)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    return jp, tp


@pytest.mark.parametrize("experts,cf,shape", [
    (4, 1.25, (2, 24)),    # deepseek's reduced routing, nothing dropped at this seed
    (8, 0.5, (3, 40)),     # capacity below the load: tokens drop
    (4, 1.0, (1, 7)),      # T < 8: the capacity floor of 8 slots
])
def test_apply_moe_matches_jax(experts, cf, shape):
    jcfg, tcfg = _cfgs(experts, capacity_factor=cf)
    jp, tp = _moe_params(jcfg, tcfg)
    x = np.random.default_rng(experts).standard_normal((*shape, jcfg.d_model)).astype(np.float32)
    jy, jaux = JM.apply_moe(jp, jnp.asarray(x), jcfg)
    ty, taux = TM.apply_moe(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)

    T = shape[0] * shape[1]
    idx, counts, src_tok = _jax_route(jp, jnp.asarray(x.reshape(T, -1)), jcfg)
    r = TM.route(tp, torch.from_numpy(x.reshape(1, T, -1)), tcfg)
    np.testing.assert_array_equal(r["expert_idx"][0].numpy(), idx)
    np.testing.assert_array_equal(r["counts"][0].numpy(), counts)
    np.testing.assert_array_equal(r["src_tok"][0].numpy(), src_tok)
    kept = np.array([[t in src_tok[e] for e in row] for t, row in enumerate(idx)])
    np.testing.assert_array_equal(r["kept"][0].numpy(), kept)
    assert r["capacity"] == JM.capacity_for(T, jcfg) == src_tok.shape[1]
    dropped = int((~kept).sum())
    assert (dropped > 0) == (cf < 1.0), dropped


def test_combine_is_deterministic_and_in_expert_order():
    """Each token adds its kept slot outputs in ascending expert order into
    zeros of ``x.dtype``: bf16 runs repeat bit for bit, and equal the
    sequential sum written out by hand."""
    _, tcfg = _cfgs()
    tcfg = dataclasses.replace(tcfg, dtype="bfloat16")
    gen = torch.Generator().manual_seed(3)
    tp = TM.init_moe(gen, tcfg, "cpu")
    tp.pop("shared")
    x = torch.randn(2, 16, tcfg.d_model, generator=gen).to(torch.bfloat16)
    a, _ = TM.apply_moe(tp, x, tcfg)
    b, _ = TM.apply_moe(tp, x, tcfg)
    assert torch.equal(a, b)
    r = TM.route(tp, x.reshape(1, 32, -1), tcfg)
    xt = x.reshape(32, -1)
    want = torch.zeros_like(xt)
    for t in range(32):
        for k in torch.argsort(r["expert_idx"][0, t]).tolist():
            e = int(r["expert_idx"][0, t, k])
            if not r["kept"][0, t, k]:
                continue
            h = torch.nn.functional.silu(xt[t] @ tp["w_gate"][e]) * (xt[t] @ tp["w_up"][e])
            want[t] = want[t] + (h @ tp["w_down"][e]) * r["gates"][0, t, k].to(torch.bfloat16)
    assert torch.equal(a.reshape(32, -1), want)


def _slot_axes(cache):
    """The reference engine's per-leaf batch axis: 1 under stacked blocks."""
    return jax.tree_util.tree_map_with_path(
        lambda p, _: 1 if "blocks" in [getattr(k, "key", None) for k in p] else 0, cache)


def test_decode_routes_each_slot_as_the_reference_engine(monkeypatch):
    """Twelve slots decode in one batched step.  Routed as one group of 12
    tokens, the MoE layer's capacity (8) drops assignments at this seed;
    the reference engine decodes each slot in its own vmap lane (T = 1,
    nothing dropped), and the port's per-row routing equals it."""
    jcfg, tcfg = _cfgs()
    jp = JT.init_model(jax.random.PRNGKey(1), jcfg)
    tp = TT.params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    B, S = 12, 9
    toks = np.random.default_rng(7).integers(0, 512, (B, S)).astype(np.int32)
    jl, jc = JT.prefill(jp, {"tokens": jnp.asarray(toks)}, jcfg, 16)
    tl, tc = TT.prefill(tp, {"tokens": torch.from_numpy(toks)}, tcfg, 16)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4)
    tok = np.asarray(jnp.argmax(jl[:, -1:], -1)).astype(np.int32)

    axes = _slot_axes(jc)

    def decode_one(params, t, cache_slot, pos):
        cache_b = jax.tree.map(lambda leaf, ax: jnp.expand_dims(leaf, ax), cache_slot, axes)
        logits, new = JT.decode_step(params, t[None, None], cache_b, pos, jcfg)
        return logits[0, 0], jax.tree.map(lambda leaf, ax: jnp.squeeze(leaf, ax), new, axes)

    per_slot = jax.jit(jax.vmap(decode_one, in_axes=(None, 0, axes, 0), out_axes=(0, axes)))
    want, _ = per_slot(jp, jnp.asarray(tok[:, 0]), jc, jnp.full((B,), S, jnp.int32))
    batched, _ = JT.decode_step(jp, jnp.asarray(tok), jc, S, jcfg)

    seen = []
    real = TT.apply_moe

    def record(params, h, cfg, **kw):
        seen.append((params, h, kw))
        return real(params, h, cfg, **kw)

    monkeypatch.setattr(TT, "apply_moe", record)
    got, _ = TT.decode_step(tp, torch.from_numpy(tok), tc, S, tcfg)
    np.testing.assert_allclose(got[:, 0].numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
    # the trap: one group of B tokens would drop, and the reference's
    # unvmapped batch decode does drop and differs
    (params, h, kw), = seen
    assert kw == {"per_row": True}
    whole = TM.route(params, h.reshape(1, B, -1), tcfg)
    assert whole["capacity"] == 8 and not bool(whole["kept"].all())
    assert bool(TM.route(params, h, tcfg)["kept"].all())
    assert np.abs(np.asarray(batched[:, 0]) - np.asarray(want)).max() > 1e-3
