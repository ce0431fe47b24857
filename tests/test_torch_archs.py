"""The model zoo's configs in repro_torch against the JAX package: qwen3-4b,
granite-20b (MQA, 48 query heads on one kv head), command-r-35b, the
RG-LRU hybrid recurrentgemma-2b, the MoE deepseek-moe-16b, the Mamba2 SSD
mamba2-1.3b, the VLM internvl2-2b (``patches`` spliced over the first
positions) and the encoder-decoder whisper-small (``frames`` into its
encoder).

Reduced widths (``cfg.reduced()``; the hybrid at 3 layers so that it covers
``rglru`` and ``local_attn``, as ``tests/test_archs.py``), f32,
JAX-initialised parameters through ``params_from_jax``, numpy tokens from a
seed.  Tolerances: knob off on both sides, logits to ``1e-4`` (same math,
other summation order); the port's ``attn_kernel="flash"`` against the JAX
model without a kernel to ``atol 2e-4, rtol 1e-3``, as the reference's own
kernel-flag test; int8 KV against the JAX int8 KV path to ``1e-3`` with the
caches' int8 levels equal but for at most two elements one level apart: the
two sides' f32 K/V differ in the last bits, which can move a value that sits
on a rounding boundary to the next level (one such element in the hybrid's
local cache at this seed), and one level of K moves the logits by ~1e-4.
Recurrent states and whisper's cross K/V to ``atol 1e-5, rtol 1e-4``; the
training loss to ``1e-5`` relative.  Engine tokens and tick stamps must be
equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import transformer as JT
from repro.serving import Request as JRequest
from repro.serving import ServeEngine as JEngine
from repro_torch.checkpoint import restore_jax_params
from repro_torch.configs import get_config as torch_config
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer as TT
from repro_torch.serving import Request, ServeEngine
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ZOO = ("qwen3-4b", "granite-20b", "command-r-35b", "recurrentgemma-2b", "deepseek-moe-16b",
       "mamba2-1.3b", "internvl2-2b", "whisper-small")
KNOB_OFF = dict(atol=1e-4, rtol=1e-4)
FLASH = dict(atol=2e-4, rtol=1e-3)
INT8 = dict(atol=1e-3, rtol=1e-3)
J_PREFILL = jax.jit(JT.prefill, static_argnums=(2, 3))
J_DECODE = jax.jit(JT.decode_step, static_argnums=(4,))


def _layers(arch):
    return 3 if jax_config(arch).family == "hybrid" else 2


def _cfgs(arch, layers=None, **kw):
    n = layers or _layers(arch)
    return (dataclasses.replace(jax_config(arch).reduced(layers=n), **kw),
            dataclasses.replace(torch_config(arch).reduced(layers=n), **kw))


_WEIGHTS: dict = {}


def _weights(arch):
    """JAX-initialised reduced weights and the port's copy (one per arch)."""
    if arch not in _WEIGHTS:
        jcfg, tcfg = _cfgs(arch)
        jp = JT.init_model(jax.random.PRNGKey(0), jcfg)
        _WEIGHTS[arch] = jp, TT.params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return _WEIGHTS[arch]


def _tokens(B, S, seed=0):
    return np.random.default_rng(seed).integers(0, 512, (B, S)).astype(np.int32)


def _extras(cfg, B=None, seed=0):
    """The modality stubs of ``cfg`` as numpy, N(0, 0.02²): whisper's
    ``frames``, internvl2's ``patches``; [B, n, d], or [n, d] without B."""
    rng = np.random.default_rng(100 + seed)
    lead = () if B is None else (B,)
    out = {}
    if cfg.is_encdec:
        out["frames"] = rng.standard_normal(lead + (cfg.encoder_context, cfg.d_model)) * 0.02
    if cfg.num_patches:
        out["patches"] = rng.standard_normal(lead + (cfg.num_patches, cfg.d_model)) * 0.02
    return {k: v.astype(np.float32) for k, v in out.items()}


def _batches(cfg, toks, seed=0):
    """The same batch for both sides: (JAX, torch)."""
    extra = _extras(cfg, toks.shape[0], seed)
    jb = {"tokens": jnp.asarray(toks), **{k: jnp.asarray(v) for k, v in extra.items()}}
    tb = {"tokens": torch.from_numpy(toks), **{k: torch.from_numpy(v) for k, v in extra.items()}}
    return jb, tb


@pytest.mark.parametrize("arch,kw,tol", [
    *((a, {}, KNOB_OFF) for a in ZOO),
    ("recurrentgemma-2b", dict(quantized_kv=True), INT8),
    ("granite-20b", dict(quantized_kv=True), INT8),
    ("recurrentgemma-2b", dict(attn_kernel="flash"), FLASH),
    ("granite-20b", dict(attn_kernel="flash"), FLASH),
    ("deepseek-moe-16b", dict(quantized_kv=True), INT8),
    ("deepseek-moe-16b", dict(attn_kernel="flash"), FLASH),
    ("internvl2-2b", dict(quantized_kv=True), INT8),
    ("internvl2-2b", dict(attn_kernel="flash"), FLASH),
    ("whisper-small", dict(quantized_kv=True), INT8),
    ("whisper-small", dict(attn_kernel="flash"), FLASH),
])
def test_prefill_and_decode_match_jax(arch, kw, tol):
    """Prefill a 20-token prompt into a 40-slot cache and decode 8 tokens
    (JAX's greedy tokens feed both).  The reduced hybrid's local layers keep
    a 16-row ring, so the prompt wraps it at prefill and decode wraps it
    again; granite's decode groups all query heads on one kv head; mamba2's
    20 tokens are one SSD chunk of 20; internvl2's first 8 positions are
    patches; whisper attends 32 encoder frames."""
    jp, tp = _weights(arch)
    jcfg, tcfg = _cfgs(arch, **{k: v for k, v in kw.items() if k != "attn_kernel"})
    tcfg = dataclasses.replace(tcfg, **kw)
    toks = _tokens(2, 20, seed=len(arch))
    jb, tb = _batches(jcfg, toks)
    jl, jc = J_PREFILL(jp, jb, jcfg, 40)
    tl, tc = TT.prefill(tp, tb, tcfg, 40)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **tol)
    tok = np.asarray(jnp.argmax(jl[:, -1:], -1)).astype(np.int32)
    for i in range(8):
        jl, jc = J_DECODE(jp, jnp.asarray(tok), jc, 20 + i, jcfg)
        tl, tc = TT.decode_step(tp, torch.from_numpy(tok), tc, 20 + i, tcfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **tol)
        tok = np.asarray(jnp.argmax(jl[:, -1:], -1)).astype(np.int32)
    pre = jcfg.first_dense_layers  # the stacked blocks start after the prefix
    if jcfg.quantized_kv:  # the int8 caches: equal levels, up to a rounding-boundary flip
        li = 2 if jcfg.family == "hybrid" else 0
        for name in ("k", "v"):
            diff = np.abs(tc[pre + li][name].numpy().astype(np.int32)
                          - np.asarray(jc["blocks"][li][name][0], np.int32))
            assert diff.max() <= 1 and int((diff > 0).sum()) <= 2, name
    state = {"hybrid": ("h", "conv"), "ssm": ("ssm", "conv")}.get(jcfg.family, ())
    for name in state:  # the recurrent layers' decode state
        np.testing.assert_allclose(tc[0][name].numpy(), np.asarray(jc["blocks"][0][name][0]),
                                   atol=1e-5, rtol=1e-4)
    if state:
        assert tc[0][state[0]].dtype == torch.float32 and set(tc[0]) == set(state)
    if jcfg.is_encdec:  # the encoder's K/V, computed once at prefill, never quantized
        for i, (k, v) in enumerate(jc["cross_kv"]):
            for got, want in ((tc[i]["cross_k"], k), (tc[i]["cross_v"], v)):
                assert got.dtype == torch.float32
                np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("arch", ZOO)
def test_forward_matches_jax(arch):
    """The training forward over the reference's own tree (stacked blocks),
    with its router aux loss: summed over the MoE layers, 0 without them."""
    jp, _ = _weights(arch)
    jcfg, tcfg = _cfgs(arch)
    toks = _tokens(2, 32, seed=3)
    jb, tb = _batches(jcfg, toks, seed=3)
    jl, jaux = JT.forward(jp, jb, jcfg)
    tree = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    with torch.no_grad():
        tl, aux = TT.forward(tree, tb, tcfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **KNOB_OFF)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    assert (float(aux) > 0) == (jcfg.num_experts > 0)


@pytest.mark.parametrize("arch", ZOO[4:])
def test_lm_loss_matches_jax(arch):
    """``lm_loss`` on the training tree: the router aux term (deepseek), the
    patch positions masked (internvl2), the frames through the encoder
    (whisper); and its gradient is finite on every leaf."""
    jp, _ = _weights(arch)
    jcfg, tcfg = _cfgs(arch)
    toks = _tokens(2, 32, seed=4)
    jb, tb = _batches(jcfg, toks, seed=4)
    want = float(JT.lm_loss(jp, jb, jcfg))
    tree = jax.tree.map(lambda a: torch.from_numpy(np.array(a)).requires_grad_(), jp)
    loss = TT.lm_loss(tree, tb, tcfg)
    np.testing.assert_allclose(float(loss.detach()), want, rtol=1e-5)
    loss.backward()
    leaves = jax.tree_util.tree_leaves(tree, is_leaf=lambda x: isinstance(x, torch.Tensor))
    assert all(t.grad is not None and bool(torch.isfinite(t.grad).all()) for t in leaves)


@pytest.mark.parametrize("arch", ZOO)
def test_param_count_matches_jax(arch):
    """Full width, abstract on both sides (nothing allocated); the training
    tree's shapes and dtypes are the reference's (``lamb``, the router,
    ``A_log``, ``D`` and ``dt_bias`` f32; whisper's stacked encoder)."""
    tcfg = torch_config(arch)
    assert TT.param_count(tcfg) == JT.param_count(jax_config(arch))
    assert TT.active_param_count(tcfg) == JT.active_param_count(jax_config(arch))
    jcfg = jax_config(arch).reduced(layers=5)  # 1 block + 2 suffix layers for the hybrid
    tree = TT.abstract_train_params(torch_config(arch).reduced(layers=5))
    want = jax.eval_shape(lambda k: JT.init_model(k, jcfg), jax.random.PRNGKey(0))
    got = jax.tree_util.tree_flatten_with_path(jax.tree.map(
        lambda t: (tuple(t.shape), str(t.dtype).split(".")[-1]), tree,
        is_leaf=lambda x: isinstance(x, torch.Tensor)))[0]
    ref = jax.tree_util.tree_flatten_with_path(jax.tree.map(
        lambda s: (tuple(s.shape), str(s.dtype)), want))[0]
    assert [(jax.tree_util.keystr(p), v) for p, v in got] == [
        (jax.tree_util.keystr(p), v) for p, v in ref]


def test_restore_jax_params_restores_the_hybrid(tmp_path):
    """A JAX-written hybrid checkpoint (stacked blocks plus suffix rglru
    layers, f32 ``lamb`` in a bf16 model) restores leaf for leaf, and serves
    the same logits as the tree handed over directly."""
    from repro.checkpoint import save

    jcfg, tcfg = _cfgs("recurrentgemma-2b", layers=5)
    jcfg_bf, tcfg_bf = (dataclasses.replace(c, dtype="bfloat16") for c in (jcfg, tcfg))
    jp = JT.init_model(jax.random.PRNGKey(4), jcfg_bf)
    fname = save(str(tmp_path / "hybrid"), jp, step=1)
    got = restore_jax_params(fname, tcfg_bf, device="cpu")
    direct = TT.params_from_jax(jax.tree.map(np.asarray, jp), tcfg_bf, device="cpu")
    assert [tcfg.mixer_for_layer(i) for i in range(5)] == ["rglru", "rglru", "local_attn",
                                                          "rglru", "rglru"]
    assert got["layers"][4]["mixer"]["lamb"].dtype == torch.float32
    assert got["layers"][2]["mixer"]["wq"].dtype == torch.bfloat16

    def leaves(t):
        return jax.tree_util.tree_leaves(t, is_leaf=lambda x: isinstance(x, torch.Tensor))

    assert all(torch.equal(a, b) for a, b in zip(leaves(got), leaves(direct)))
    np.testing.assert_array_equal(
        got["layers"][3]["mixer"]["w_a"].float().numpy(),
        np.asarray(jp["suffix"][0]["mixer"]["w_a"], np.float32))
    toks = torch.from_numpy(_tokens(1, 9))
    a, _ = TT.prefill(got, {"tokens": toks}, tcfg_bf, 16)
    b, _ = TT.prefill(direct, {"tokens": toks}, tcfg_bf, 16)
    assert torch.equal(a, b)


@pytest.mark.parametrize("arch,kw", [("recurrentgemma-2b", {}), ("granite-20b", {}),
                                     ("recurrentgemma-2b", dict(quantized_kv=True)),
                                     ("granite-20b", dict(quantized_kv=True)),
                                     ("deepseek-moe-16b", {}), ("mamba2-1.3b", {}),
                                     ("internvl2-2b", {}), ("whisper-small", {}),
                                     ("whisper-small", dict(quantized_kv=True))])
def test_engine_matches_jax_engine(arch, kw):
    """The port's ServeEngine against the JAX engine: the recurrent archs
    prefill at exact length (prompts of one length batch together; mamba2's
    whole chunks of 32) with their prefix cache off; the others bucket their
    prompts; internvl2 and whisper take ``extra_inputs`` (their prefix
    cache off too); deepseek's prefill routes each padded bucket batch as
    one group.  Tokens and tick stamps equal."""
    jp, tp = _weights(arch)
    jcfg, tcfg = _cfgs(arch, long_context_window=None, **kw)
    rng = np.random.default_rng(5)
    lens = (32, 64, 32, 96, 32) if jcfg.ssm_state else (5, 9, 5, 13, 7, 22, 9)
    prompts = [rng.integers(1, 512, n).tolist() for n in lens]
    extra = _extras(jcfg)
    engine_kw = dict(max_slots=3, cache_len=128 if jcfg.ssm_state else 48, prompt_bucket=8)
    jreqs = [JRequest(prompt=list(p), max_new_tokens=5) for p in prompts]
    treqs = [Request(prompt=list(p), max_new_tokens=5) for p in prompts]
    JEngine(jcfg, jp, extra_inputs={k: jnp.asarray(v) for k, v in extra.items()},
            **engine_kw).run(jreqs)
    teng = ServeEngine(tcfg, tp, device="cpu", extra_inputs=extra, **engine_kw)
    teng.run(treqs)
    for j, t in zip(jreqs, treqs):
        assert t.done and t.output == j.output
        assert (t.submit_tick, t.admit_tick, t.finish_tick) == (
            j.submit_tick, j.admit_tick, j.finish_tick)
    recurrent = jcfg.family in ("hybrid", "ssm")
    assert teng._recurrent == recurrent
    assert (teng.prefix_hits + teng.prefix_misses == 0) == (recurrent or bool(extra))


@pytest.mark.parametrize("arch", ZOO)
def test_serve_cli_reduced_on_cpu(arch):
    """``launch/serve.py --arch <name> --reduced --device cpu``, batch mode and
    ``--fleet 2`` (the --no-fastpath twin equal on the tick fields).  The
    fleet passes no extra inputs and draws prompts of any length, as the
    reference's: whisper-small (no ``frames``) and mamba2-1.3b (prompts not
    whole chunks) fail there, in the JAX engine as in the port's."""
    argv = ["--arch", arch, "--reduced", "--device", "cpu", "--prompt-len", "10", "--gen", "4"]
    got = tserve.main(argv + ["--batch", "2"])
    assert np.array(got["tokens"]).shape == (2, 4) and got["arch"] == f"{arch}-smoke"
    assert got["prompt_len"] == (32 if arch == "mamba2-1.3b" else 10)  # whole SSD chunks
    fleet = argv + ["--fleet", "2", "--requests", "8", "--rate", "0.6"]
    refusal = {"whisper-small": (KeyError, KeyError), "mamba2-1.3b": (AssertionError, ValueError)}
    if arch in refusal:
        jerr, terr = refusal[arch]
        jp, tp = _weights(arch)
        jcfg, tcfg = _cfgs(arch)
        with pytest.raises(jerr):
            JEngine(jcfg, jp, cache_len=32, prompt_bucket=8).run([JRequest(prompt=[1] * 9)])
        with pytest.raises(terr):
            ServeEngine(tcfg, tp, cache_len=32, prompt_bucket=8, device="cpu").run(
                [Request(prompt=[1] * 9)])
        with pytest.raises(terr):
            tserve.main(fleet)
        return
    fast, twin = tserve.main(fleet), tserve.main(fleet + ["--no-fastpath"])
    assert fast["metrics"]["completed"] == fast["offered"] >= 8
    for k in ("completed", "rejected", "shed", "p50_ttft_ticks", "p99_ttft_ticks",
              "slot_occupancy"):
        assert fast["metrics"][k] == twin["metrics"][k], k
    assert fast["served"] == twin["served"]


def test_unported_arch_names_the_roadmap():
    """The arch that waits (llama4-scout-17b-a16e, more than one card holds)
    fails at the registry, and its config fails in the model with the lists
    of ported and waiting archs."""
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        torch_config("llama4-scout-17b-a16e")
    cfg = jax_config("llama4-scout-17b-a16e").reduced()
    tcfg = type(torch_config("qwen3-4b"))(**{f.name: getattr(cfg, f.name)
                                             for f in dataclasses.fields(cfg)})
    with pytest.raises(NotImplementedError,
                       match="whisper-small.*not yet: llama4-scout-17b-a16e.*"):
        TT.init_model(tcfg, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        TT.abstract_train_params(tcfg)
