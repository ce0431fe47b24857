"""repro_torch serving: the port's ServeEngine against the JAX ServeEngine on
the same weights and requests, and the port's serve.py batch mode on the CPU.

Generated tokens and the admit / finish tick stamps must be equal; the
engine-side counters (prefix hits, skipped prefills) too.  Reduced qwen3 in
f32; JAX-initialised weights reach the port through ``params_from_jax``.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest

from repro.configs import get_config as jax_config
from repro.models import transformer as JT
from repro.serving import Request as JRequest
from repro.serving import ServeEngine as JEngine
from repro_torch.configs import get_config as torch_config
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer as TT
from repro_torch.serving import SEEN_SHAPES, Request, ServeEngine
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _cfgs(**kw):
    j = dataclasses.replace(jax_config("qwen3-1.7b").reduced(layers=2, d_model=64), **kw)
    t = dataclasses.replace(torch_config("qwen3-1.7b").reduced(layers=2, d_model=64), **kw)
    return j, t


@pytest.fixture(scope="module")
def weights():
    jcfg, tcfg = _cfgs()
    jp = JT.init_model(jax.random.PRNGKey(0), jcfg)
    return jp, TT.params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")


def _prompts(lens, seed):
    rng = np.random.default_rng(seed)
    pool = {}
    # equal lengths repeat the same prompt: prefix-cache hits
    return [pool.setdefault(n, rng.integers(1, 512, n).tolist()) for n in lens]


def _run_both(weights, jcfg, tcfg, prompts, max_new, **engine_kw):
    jp, tp = weights
    jreqs = [JRequest(prompt=list(p), max_new_tokens=max_new) for p in prompts]
    treqs = [Request(prompt=list(p), max_new_tokens=max_new) for p in prompts]
    jeng = JEngine(jcfg, jp, **engine_kw)
    teng = ServeEngine(tcfg, tp, device="cpu", **engine_kw)
    jeng.run(jreqs)
    teng.run(treqs)
    for j, t in zip(jreqs, treqs):
        assert t.done and t.status == "done"
        assert t.output == j.output
        assert (t.submit_tick, t.admit_tick, t.finish_tick) == (
            j.submit_tick, j.admit_tick, j.finish_tick)
    js, ts = jeng.stats(), teng.stats()
    assert set(ts) == set(js)
    for key in ("prefix_hits", "prefix_misses", "prefix_entries", "prefill_skipped",
                "cache_hit_rate"):
        assert ts[key] == js[key], key
    return jeng, teng


@pytest.mark.parametrize("kw", [{}, dict(attn_kernel="flash"), dict(quantized_kv=True)])
def test_engine_matches_jax_engine(weights, kw):
    """Prefix-cache hits, batched prefill of the tick-0 burst, and
    active-slot decode once occupancy drops below the pool size."""
    jcfg, tcfg = _cfgs(long_context_window=None,
                       **{k: v for k, v in kw.items() if k != "attn_kernel"})
    tcfg = dataclasses.replace(tcfg, **kw)
    prompts = _prompts((5, 9, 5, 13, 7, 5, 9), seed=8)
    _, teng = _run_both(weights, jcfg, tcfg, prompts, 4, max_slots=3, cache_len=48,
                        prompt_bucket=8)
    assert teng.prefix_hits > 0 and teng.prefill_skipped == teng.prefix_hits


@pytest.mark.parametrize("kw", [{}, dict(attn_kernel="flash")])
def test_engine_windowed_exact_length_bypass(weights, kw):
    """cache_len beyond the long-context window: exact-length prefill, ring
    buffers that wrap at prefill and in decode, no prefix cache."""
    jcfg, tcfg = _cfgs()
    tcfg = dataclasses.replace(tcfg, **kw)
    prompts = _prompts((7, 21, 7, 13), seed=3)
    _, teng = _run_both(weights, jcfg, tcfg, prompts, 6, max_slots=2, cache_len=48,
                        prompt_bucket=8)
    assert teng._windowed and teng.prefix_hits == 0 and teng.prefix_misses == 0


def test_engine_single_slot_eos_and_budget(weights):
    jcfg, tcfg = _cfgs(long_context_window=None)
    jp, tp = weights
    prompt = _prompts((8,), seed=2)[0]
    ref = Request(prompt=list(prompt), max_new_tokens=8)
    ServeEngine(tcfg, tp, max_slots=1, cache_len=32, prompt_bucket=8, device="cpu").run([ref])
    eos = ref.output[2]
    reqs = [Request(prompt=list(prompt), max_new_tokens=8, eos_id=eos),
            Request(prompt=list(prompt), max_new_tokens=1)]
    jreqs = [JRequest(prompt=list(prompt), max_new_tokens=8, eos_id=eos),
             JRequest(prompt=list(prompt), max_new_tokens=1)]
    ServeEngine(tcfg, tp, max_slots=1, cache_len=32, prompt_bucket=8, device="cpu").run(reqs)
    JEngine(jcfg, jp, max_slots=1, cache_len=32, prompt_bucket=8).run(jreqs)
    assert reqs[0].output[-1] == eos and len(reqs[0].output) <= 8
    assert [r.output for r in reqs] == [r.output for r in jreqs]
    assert [r.finish_tick for r in reqs] == [r.finish_tick for r in jreqs]


def test_engine_program_shapes_bounded(weights):
    """One prefill program per bucket, one decode program for a lone slot;
    a twin engine with the same shapes builds nothing new."""
    _, tcfg = _cfgs(long_context_window=None)
    tp = weights[1]
    SEEN_SHAPES.clear()
    rng = np.random.default_rng(7)
    engine = ServeEngine(tcfg, tp, max_slots=2, cache_len=48, prompt_bucket=8, device="cpu")
    for n in (3, 5, 7, 8, 11, 13, 16, 4, 9, 15):
        engine.run([Request(prompt=rng.integers(1, 512, n).tolist(), max_new_tokens=3)])
    assert engine.prefill_traces == 2 and engine.decode_traces == 1
    engine.run([Request(prompt=rng.integers(1, 512, 20).tolist(), max_new_tokens=3)])
    assert engine.prefill_traces == 3 and engine.decode_traces == 1
    twin = ServeEngine(tcfg, tp, max_slots=2, cache_len=48, prompt_bucket=8, device="cpu")
    twin.run([Request(prompt=rng.integers(1, 512, 6).tolist(), max_new_tokens=3)])
    assert twin.prefill_traces == 0 and twin.decode_traces == 0


def test_engine_hot_reload_invalidates_prefix(weights):
    _, tcfg = _cfgs(long_context_window=None)
    tp = weights[1]
    prompt = _prompts((6,), seed=4)[0]
    engine = ServeEngine(tcfg, tp, max_slots=1, cache_len=32, prompt_bucket=8, device="cpu")
    engine.run([Request(prompt=list(prompt), max_new_tokens=2)])
    engine.run([Request(prompt=list(prompt), max_new_tokens=2)])
    assert engine.prefix_hits == 1
    engine.params = tp
    assert engine.prefix_invalidations == 1 and engine.stats()["prefix_entries"] == 0.0
    # extra inputs key the forward beside the prompt: the prefix cache stands aside
    extra = ServeEngine(tcfg, tp, max_slots=1, cache_len=32, prompt_bucket=8, device="cpu",
                        extra_inputs={"frames": np.zeros(3, np.float32)})
    for _ in range(2):
        extra.run([Request(prompt=list(prompt), max_new_tokens=2)])
    assert extra.prefix_hits + extra.prefix_misses == 0 and extra.stats()["prefix_entries"] == 0


def test_serve_batch_mode_on_cpu(tmp_path):
    out = tmp_path / "metrics.json"
    argv = ["--arch", "qwen3-1.7b", "--reduced", "--batch", "2", "--prompt-len", "12",
            "--gen", "5", "--device", "cpu"]
    plain = tserve.main(argv + ["--metrics-out", str(out)])
    flash = tserve.main(argv, config_overrides={"attn_kernel": "flash"})
    assert np.array(plain["tokens"]).shape == (2, 5)
    assert flash["tokens"] == plain["tokens"]
    metrics = json.loads(out.read_text())
    assert metrics["arch"] == "qwen3-1.7b-smoke" and metrics["gen"] == 5
    # --fleet, refused before the fleet was ported, now serves
    fleet = tserve.main(argv + ["--fleet", "2", "--requests", "6"])
    assert fleet["offered"] >= 6 and fleet["metrics"]["completed"] == fleet["offered"]


def test_serve_restores_jax_checkpoint(tmp_path, capsys):
    """--restore reads a model checkpoint the JAX package wrote (resolved
    from its step-tagged prefix); a checkpoint of another width is refused."""
    from repro.checkpoint import save

    argv = ["--arch", "qwen3-1.7b", "--reduced", "--batch", "1", "--prompt-len", "6",
            "--gen", "3", "--device", "cpu", "--restore", str(tmp_path / "model")]
    jp = JT.init_model(jax.random.PRNGKey(1), jax_config("qwen3-1.7b").reduced())
    fname = save(str(tmp_path / "model"), jp, step=3)
    got = tserve.main(argv)
    assert f"restored params from {fname}" in capsys.readouterr().out
    assert len(got["tokens"][0]) == 3
    narrow = JT.init_model(jax.random.PRNGKey(1), _cfgs()[0])
    save(str(tmp_path / "model"), narrow, step=4)
    with pytest.raises(ValueError, match="embed"):
        tserve.main(argv)
