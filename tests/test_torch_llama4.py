"""llama4-scout-17b-a16e in repro_torch against the JAX package: every layer
MoE, top-1 of 16 experts plus one always-on shared expert, 40 query heads
on 8 kv heads at full width.

Reduced width (``cfg.reduced()``: 2 layers, d 256, 4 experts), f32,
JAX-initialised parameters through ``params_from_jax``, numpy tokens from a
seed; the tolerances of the other MoE config (``tests/test_torch_archs.py``,
deepseek-moe-16b): knob off on both sides, logits to ``1e-4`` (same math,
other summation order), ``attn_kernel="flash"`` against the JAX model
without a kernel to ``atol 2e-4, rtol 1e-3``, int8 KV to ``1e-3``, the
training loss to ``1e-5`` relative.  The reference decodes a batch's MoE
layer as one routing group, the port row by row (as the reference's engine
does, one slot per ``vmap`` lane), so the decode is held at batch 1, where
the two are one program.
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
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as TST
from repro_torch.models import transformer as TT
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ARCH = "llama4-scout-17b-a16e"
KNOB_OFF = dict(atol=1e-4, rtol=1e-4)
FLASH = dict(atol=2e-4, rtol=1e-3)
INT8 = dict(atol=1e-3, rtol=1e-3)
J_PREFILL = jax.jit(JT.prefill, static_argnums=(2, 3))
J_DECODE = jax.jit(JT.decode_step, static_argnums=(4,))


def _cfgs(**kw):
    return (dataclasses.replace(jax_config(ARCH).reduced(), dtype="float32", **kw),
            dataclasses.replace(torch_config(ARCH).reduced(), dtype="float32", **kw))


_WEIGHTS: dict = {}


def _weights():
    if not _WEIGHTS:
        jcfg, tcfg = _cfgs()
        jp = JT.init_model(jax.random.PRNGKey(0), jcfg)
        _WEIGHTS["jax"] = jp
        _WEIGHTS["torch"] = TT.params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return _WEIGHTS["jax"], _WEIGHTS["torch"]


def _tokens(B, S, seed=0):
    return np.random.default_rng(seed).integers(0, 512, (B, S)).astype(np.int32)


def test_config_is_the_reference_field_for_field():
    tcfg, jcfg = torch_config(ARCH), jax_config(ARCH)
    for f in dataclasses.fields(tcfg):
        want = getattr(jcfg, f.name)
        assert getattr(tcfg, f.name) == want, f.name
    assert (tcfg.num_layers, tcfg.d_model, tcfg.num_heads, tcfg.num_kv_heads, tcfg.hd) == (
        48, 5120, 40, 8, 128)
    assert (tcfg.num_experts, tcfg.experts_per_token, tcfg.num_shared_experts,
            tcfg.moe_d_ff, tcfg.vocab_size, tcfg.long_context_window) == (
        16, 1, 1, 8192, 202048, 8192)
    assert all(tcfg.ffn_is_moe(i) for i in range(tcfg.num_layers))


def test_param_count_matches_jax():
    """Full width and depth, abstract on both sides: about 106.7 B
    parameters, 17 B of them active per token (top-1 of 16 plus the shared
    expert)."""
    tcfg, jcfg = torch_config(ARCH), jax_config(ARCH)
    assert TT.param_count(tcfg) == JT.param_count(jcfg)
    assert TT.active_param_count(tcfg) == JT.active_param_count(jcfg)
    assert 106e9 < TT.param_count(tcfg) < 108e9 and 16e9 < TT.active_param_count(tcfg) < 18e9


@pytest.mark.parametrize("kw,tol", [({}, KNOB_OFF), (dict(quantized_kv=True), INT8),
                                    (dict(attn_kernel="flash"), FLASH)],
                         ids=["plain", "int8-kv", "flash"])
def test_prefill_and_four_decode_steps_match_jax(kw, tol):
    """Prefill a 20-token prompt into a 40-slot cache (batch 2, one routing
    group of 40 tokens on both sides), then 4 decode steps at batch 1
    (JAX's greedy tokens feed both)."""
    jp, tp = _weights()
    jcfg, tcfg = _cfgs(**{k: v for k, v in kw.items() if k != "attn_kernel"})
    tcfg = dataclasses.replace(tcfg, **kw)
    toks = _tokens(2, 20, seed=7)
    jl, _ = J_PREFILL(jp, {"tokens": jnp.asarray(toks)}, jcfg, 40)
    tl, _ = TT.prefill(tp, {"tokens": torch.from_numpy(toks)}, tcfg, 40)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **tol)
    one = toks[:1]
    jl, jc = J_PREFILL(jp, {"tokens": jnp.asarray(one)}, jcfg, 40)
    tl, tc = TT.prefill(tp, {"tokens": torch.from_numpy(one)}, tcfg, 40)
    tok = np.asarray(jnp.argmax(jl[:, -1:], -1)).astype(np.int32)
    for i in range(4):
        jl, jc = J_DECODE(jp, jnp.asarray(tok), jc, 20 + i, jcfg)
        tl, tc = TT.decode_step(tp, torch.from_numpy(tok), tc, 20 + i, tcfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **tol)
        tok = np.asarray(jnp.argmax(jl[:, -1:], -1)).astype(np.int32)


def test_forward_and_lm_loss_match_jax():
    """The training forward over the reference's stacked tree with its router
    aux loss, and ``lm_loss`` (aux term included) with a finite gradient on
    every leaf."""
    jp, _ = _weights()
    jcfg, tcfg = _cfgs()
    toks = _tokens(2, 32, seed=4)
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    jl, jaux = JT.forward(jp, jb, jcfg)
    with torch.no_grad():
        tl, aux = TT.forward(jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp), tb, tcfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **KNOB_OFF)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    want = float(JT.lm_loss(jp, jb, jcfg))
    tree = jax.tree.map(lambda a: torch.from_numpy(np.array(a)).requires_grad_(), jp)
    loss = TT.lm_loss(tree, tb, tcfg)
    np.testing.assert_allclose(float(loss.detach()), want, rtol=1e-5)
    loss.backward()
    leaves = jax.tree_util.tree_leaves(tree, is_leaf=lambda x: isinstance(x, torch.Tensor))
    assert all(t.grad is not None and bool(torch.isfinite(t.grad).all()) for t in leaves)


def test_trains_one_round_through_the_port():
    """One AD-GDA round of the reduced model on 2 nodes (``make_trainer``'s
    defaults, q4b gossip): each node's round-0 loss is the reference's
    ``lm_loss`` of the shared initial weights on its batch, and the new
    parameters are finite."""
    jp, _ = _weights()
    jcfg, tcfg = _cfgs()
    trainer = TST.make_trainer(tcfg, 2, device="cpu")
    state = trainer.init(jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp))
    toks = _tokens(4, 16, seed=9).reshape(2, 2, 16)
    state, aux = trainer.step(state, {"tokens": torch.from_numpy(toks)})
    for i in range(2):
        want = float(JT.lm_loss(jp, {"tokens": jnp.asarray(toks[i])}, jcfg))
        np.testing.assert_allclose(float(aux["losses"][i]), want, rtol=1e-5)
    leaves = jax.tree_util.tree_leaves(state.theta,
                                       is_leaf=lambda x: isinstance(x, torch.Tensor))
    assert all(bool(torch.isfinite(t).all()) for t in leaves)


def test_serve_cli_reduced_on_cpu():
    """``launch/serve.py --arch llama4-scout-17b-a16e --reduced --device cpu``
    in batch mode and as a 2-node fleet."""
    argv = ["--arch", ARCH, "--reduced", "--device", "cpu", "--prompt-len", "10", "--gen", "4"]
    got = tserve.main(argv + ["--batch", "2"])
    assert np.array(got["tokens"]).shape == (2, 4) and got["arch"] == f"{ARCH}-smoke"
    fleet = tserve.main(argv + ["--fleet", "2", "--requests", "8", "--rate", "0.6"])
    assert fleet["metrics"]["completed"] == fleet["offered"] >= 8
