"""repro_torch model against the JAX model on the same weights.

Reduced qwen3 (f32, two layers); JAX-initialised weights reach the port
through ``params_from_jax``.  Tolerances: knob off on both sides, logits to
``1e-4`` (same math, other summation order); port ``attn_kernel="flash"``
against JAX ``attn_kernel=None`` to ``atol 2e-4, rtol 1e-3``, as the
reference's own kernel-flag test; int8 KV against the JAX int8 KV path to
``1e-4`` (identical quantized values, same dequant math).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import transformer as JT
from repro_torch.configs import get_config as torch_config
from repro_torch.models import transformer as TT
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

KNOB_OFF = dict(atol=1e-4, rtol=1e-4)
FLASH = dict(atol=2e-4, rtol=1e-3)
# jitted reference entry points: one compile per (config, shape)
J_PREFILL = jax.jit(JT.prefill, static_argnums=(2, 3))
J_DECODE = jax.jit(JT.decode_step, static_argnums=(4,))


def _cfgs(**kw):
    j = dataclasses.replace(jax_config("qwen3-1.7b").reduced(layers=2, d_model=64), **kw)
    t = dataclasses.replace(torch_config("qwen3-1.7b").reduced(layers=2, d_model=64), **kw)
    return j, t


@pytest.fixture(scope="module")
def weights():
    jcfg, tcfg = _cfgs()
    jp = JT.init_model(jax.random.PRNGKey(0), jcfg)
    return jp, TT.params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")


def _tokens(B, S, seed=0):
    return np.random.default_rng(seed).integers(0, 512, (B, S)).astype(np.int32)


def _greedy_both(weights, jcfg, tcfg, toks, cache_len, steps, tol):
    """Prefill + greedy decode on both sides (JAX's greedy tokens feed
    both); compare logits at every step."""
    jp, tp = weights
    jl, jc = J_PREFILL(jp, {"tokens": jnp.asarray(toks)}, jcfg, cache_len)
    tl, tc = TT.prefill(tp, {"tokens": torch.from_numpy(toks)}, tcfg, cache_len)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **tol)
    S = toks.shape[1]
    tok = np.asarray(jnp.argmax(jl[:, -1:], -1)).astype(np.int32)
    for i in range(steps):
        jl, jc = J_DECODE(jp, jnp.asarray(tok), jc, S + i, jcfg)
        tl, tc = TT.decode_step(tp, torch.from_numpy(tok), tc, S + i, tcfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **tol)
        tok = np.asarray(jnp.argmax(jl[:, -1:], -1)).astype(np.int32)
    return jc, tc


@pytest.mark.parametrize("S,cache_len", [(12, 24), (9, 16)])
def test_knob_off_matches_jax(weights, S, cache_len):
    jcfg, tcfg = _cfgs()
    _greedy_both(weights, jcfg, tcfg, _tokens(2, S), cache_len, 5, KNOB_OFF)


@pytest.mark.parametrize("S,cache_len", [(12, 24), (20, 40)])
def test_flash_knob_close_to_jax_baseline(weights, S, cache_len):
    """cache_len > long_context_window (16): prefill runs windowed, decode on
    a ring buffer that wraps during the decode."""
    jcfg, _ = _cfgs()
    _, tcfg = _cfgs(attn_kernel="flash")
    _greedy_both(weights, jcfg, tcfg, _tokens(2, S, seed=S), cache_len, 6, FLASH)


@pytest.mark.parametrize("S,cache_len", [(12, 14), (20, 40)])
def test_quantized_kv_matches_jax(weights, S, cache_len):
    jcfg, tcfg = _cfgs(quantized_kv=True)
    jc, tc = _greedy_both(weights, jcfg, tcfg, _tokens(2, S, seed=7), cache_len, 4, KNOB_OFF)
    leaf = jc["blocks"][0]["k"]  # [n_blocks, B, L, KV, hd]
    np.testing.assert_array_equal(tc[0]["k"].numpy(), np.asarray(leaf[0]))
    assert tc[0]["k"].dtype == torch.int8


def test_long_prompt_ring_prime_matches_jax(weights):
    """A prompt longer than the ring buffer: the last L keys land rolled by
    S % L, in the float and the int8 cache."""
    for kw in ({}, dict(quantized_kv=True)):
        jcfg, tcfg = _cfgs(**kw)
        jc, tc = _greedy_both(weights, jcfg, tcfg, _tokens(1, 27, seed=3), 40, 3, KNOB_OFF)
        for name in tc[1]:
            np.testing.assert_allclose(tc[1][name].float().numpy(),
                                       np.asarray(jc["blocks"][0][name][1], np.float32),
                                       atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("kw", [{}, dict(attn_kernel="flash"), dict(quantized_kv=True)])
def test_per_row_positions_match_row_by_row(weights, kw):
    """decode_step with a [B] position tensor equals the JAX model decoding
    each row alone at its scalar position (the reference engine's vmap)."""
    jp, tp = weights
    jcfg, tcfg = _cfgs(**{k: v for k, v in kw.items() if k != "attn_kernel"})
    tcfg = dataclasses.replace(tcfg, **kw)
    cache_len = 24
    lens = [5, 11, 8]
    prompts = [_tokens(1, n, seed=n) for n in lens]
    jcaches, tcaches, toks = [], [], []
    for p in prompts:
        jl, jc = J_PREFILL(jp, {"tokens": jnp.asarray(p)}, jcfg, cache_len)
        _, tc = TT.prefill(tp, {"tokens": torch.from_numpy(p)}, tcfg, cache_len)
        jcaches.append(jc)
        tcaches.append(tc)
        toks.append(int(jnp.argmax(jl[0, -1])))
    tcache = [{k: torch.cat([c[i][k] for c in tcaches]) for k in tcaches[0][i]}
              for i in range(len(tcaches[0]))]
    pos = np.array(lens)
    for step in range(4):
        tl, tcache = TT.decode_step(tp, torch.tensor(toks)[:, None], tcache,
                                    torch.from_numpy(pos), tcfg)
        for r in range(len(lens)):
            jl, jcaches[r] = J_DECODE(jp, jnp.asarray([[toks[r]]], jnp.int32), jcaches[r],
                                      int(pos[r]), jcfg)
            np.testing.assert_allclose(tl[r].numpy(), np.asarray(jl[0]), **FLASH)
            toks[r] = int(jnp.argmax(jl[0, 0]))
        pos += 1


def test_local_attn_pattern_matches_jax():
    """The local_attn mixer: a window of 8 inside a 24-slot cache."""
    kw = dict(sliding_window=8, layer_pattern=("attn", "local_attn"), long_context_window=None)
    jcfg, tcfg = _cfgs(**kw)
    jp = JT.init_model(jax.random.PRNGKey(2), jcfg)
    tp = TT.params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    _greedy_both((jp, tp), jcfg, tcfg, _tokens(2, 14, seed=1), 24, 5, KNOB_OFF)
    _greedy_both((jp, tp), jcfg, dataclasses.replace(tcfg, attn_kernel="flash"),
                 _tokens(2, 14, seed=1), 24, 5, FLASH)


def test_layernorm_gelu_bias_variant_matches_jax():
    """The dense path's other branches: layernorm, tanh-gelu MLP, biases."""
    kw = dict(norm_type="layernorm", mlp_type="gelu", use_bias=True, qk_norm=False)
    jcfg, tcfg = _cfgs(**kw)
    jp = JT.init_model(jax.random.PRNGKey(5), jcfg)
    tp = TT.params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    assert "bias" in tp["layers"][0]["norm1"] and "b1" in tp["layers"][0]["ffn"]
    _greedy_both((jp, tp), jcfg, tcfg, _tokens(2, 10, seed=5), 16, 3, KNOB_OFF)
    assert TT.param_count(tcfg) == JT.param_count(jcfg)


def test_param_count_matches_jax():
    for arch_cfg in (jax_config("qwen3-1.7b"), jax_config("qwen3-1.7b").reduced()):
        tcfg = torch_config("qwen3-1.7b")
        if arch_cfg.num_layers != tcfg.num_layers:
            tcfg = tcfg.reduced()
        assert TT.param_count(tcfg) == JT.param_count(arch_cfg)
    assert 1.70e9 < TT.param_count(torch_config("qwen3-1.7b")) < 1.75e9


def test_init_model_shapes_follow_reference_layout():
    _, tcfg = _cfgs()
    p = TT.init_model(tcfg, seed=0, device="cpu")
    d, H, KV, hd = tcfg.d_model, tcfg.num_heads, tcfg.num_kv_heads, tcfg.hd
    m = p["layers"][0]["mixer"]
    assert m["wq"].shape == (d, H, hd) and m["wo"].shape == (H, hd, d)
    assert m["wk"].shape == (d, KV, hd) and m["q_norm"].shape == (hd,)
    assert p["embed"]["table"].shape == (tcfg.vocab_size, d)
    assert sum(t.numel() for t in _leaves(p)) == TT.param_count(tcfg)
    again = TT.init_model(tcfg, seed=0, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(_leaves(p), _leaves(again)))


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


@pytest.mark.parametrize("arch,fragment", [
    ("llama4-scout-17b-a16e", "llama4-scout-17b-a16e-smoke: not yet ported"),
])
def test_unported_families_raise(arch, fragment):
    cfg = dataclasses.replace(jax_config(arch).reduced(), dtype="float32")
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    tcfg = type(torch_config("qwen3-1.7b"))(**fields)
    with pytest.raises(NotImplementedError, match=fragment):
        TT.init_model(tcfg, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        torch_config(arch)


def test_block_sparse_knob_raises(weights):
    """The knob serves prefill (test_torch_block_sparse.py) but refuses
    training: the block-sparse kernel has no backward."""
    _, tcfg = _cfgs(attn_kernel="block_sparse")
    logits, _ = TT.prefill(weights[1], {"tokens": torch.from_numpy(_tokens(1, 8))}, tcfg, 16)
    assert bool(torch.isfinite(logits).all())
    with pytest.raises(NotImplementedError, match="backward kernels"):
        TT.lm_loss(TT.init_train_params(tcfg, device="cpu"),
                   {"tokens": torch.zeros(1, 8, dtype=torch.long)}, tcfg)
