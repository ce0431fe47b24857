"""repro_torch serving fleet against the JAX package's, on the CPU.

The load generator and the metrics are numpy on both sides: the same config
must give the same request stream and the same summaries, exactly.  The
engine's fast-path knobs must leave tokens and tick stamps unchanged.  The
port's fleet reproduces suite S's tick fields (``BENCH_S.json``, reduced
qwen3-1.7b with full attention): the load generator draws no EOS, so they
depend only on the traffic.  A short JAX fleet and the port's, on weights
carried across by ``params_from_jax``, agree on tokens and tick fields.
Hot reload and ``restore_latest`` walk past a torn checkpoint; the
classifier engine and the batched probe agree with the reference's on a
logistic model (predictions equal, probe losses within 1e-6).
"""
import dataclasses
import json
import os
from collections import deque
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro.configs import get_config as jax_config
from repro.models import transformer as JT
from repro.serving import fleet as jfleet
from repro.serving import loadgen as jloadgen
from repro.serving import metrics as jmetrics
from repro.serving import ServeEngine as JEngine
from repro_torch import checkpoint as tckpt
from repro_torch.checkpoint import npz as tnpz
from repro_torch.configs import get_config as torch_config
from repro_torch.launch import serve as tserve
from repro_torch.launch import train_serve
from repro_torch.models import transformer as TT
from repro_torch.serving import fleet as tfleet
from repro_torch.serving import loadgen as tloadgen
from repro_torch.serving import metrics as tmetrics
from repro_torch.serving import Request, ServeEngine
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
TICK_FIELDS = ("requests", "completed", "rejected", "shed", "p50_ttft_ticks", "p95_ttft_ticks",
               "p99_ttft_ticks", "mean_queue_depth", "max_queue_depth", "slot_occupancy",
               "cache_hit_rate", "prefill_skipped")


# ------------------------------------------------------------------ loadgen
def _stream(gen, ticks):
    out = []
    for t in range(ticks):
        for node, r in gen.poll(t):
            out.append((t, node, list(r.prompt), r.max_new_tokens))
    return out


@pytest.mark.parametrize("mode", ["iid", "pool", "unique"])
def test_loadgen_matches_reference(mode):
    kw = dict(num_nodes=3, rate=(0.4, 1.3, 0.7), vocab_size=97, prompt_min=2, prompt_max=40,
              output_min=1, output_max=12, seed=5, prompt_mode=mode, prompt_pool=9)
    j = jloadgen.LoadGenerator(jloadgen.LoadGenConfig(**kw))
    t = tloadgen.LoadGenerator(tloadgen.LoadGenConfig(**kw))
    assert t.cfg.mean_request_tokens() == j.cfg.mean_request_tokens()
    js, ts = _stream(j, 60), _stream(t, 60)
    assert len(ts) > 50 and ts == js
    assert all(isinstance(r, Request) for _, r in t.poll(200))
    j.poll(200)
    for k, v in j.state().items():
        np.testing.assert_array_equal(t.state()[k], v)


def test_loadgen_state_round_trips_through_the_port_checkpoint(tmp_path):
    cfg = tloadgen.LoadGenConfig(num_nodes=2, rate=0.9, vocab_size=64, prompt_mode="pool",
                                 prompt_pool=7, seed=3)
    whole = tloadgen.LoadGenerator(cfg)
    resumed = tloadgen.LoadGenerator(cfg)
    assert _stream(whole, 25) == _stream(resumed, 25)
    fname = tckpt.save(str(tmp_path / "lg"), resumed.state(), step=25)
    template = {k: torch.from_numpy(np.asarray(v)) for k, v in resumed.state().items()}
    again = tloadgen.LoadGenerator(cfg)
    again.restore(tckpt.restore(fname, template, device="cpu"))
    for tick in range(25, 50):
        a = [(n, r.prompt, r.max_new_tokens) for n, r in whole.poll(tick)]
        b = [(n, r.prompt, r.max_new_tokens) for n, r in again.poll(tick)]
        assert a == b


# ------------------------------------------------------------------ metrics
def _fake_requests(seed, n=40):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        status = rng.choice(["done", "done", "done", "rejected", "shed", "active"])
        sub = float(rng.uniform(0, 10))
        out.append(SimpleNamespace(
            status=status, output=[1] * int(rng.integers(1, 9)), submit_tick=int(i),
            admit_tick=int(i + rng.integers(0, 7)), submit_wall=sub,
            first_wall=sub + float(rng.uniform(0, 0.3)),
            ttft_ticks=int(rng.integers(0, 7))))
    return out


def test_metrics_match_reference():
    reqs = [_fake_requests(s) for s in (1, 2)]
    kw = [dict(queue_samples=[0, 3, 1, 2], occupancy_samples=[1, 2, 2, 0], max_slots=2,
               wall_seconds=1.5, tokens_generated=77,
               engine_stats={"cache_hit_rate": 0.5, "prefill_skipped": 3.0,
                             "prefix_hits": 3.0, "prefix_misses": 3.0}),
          dict(queue_samples=[], occupancy_samples=[], max_slots=4, wall_seconds=0.0,
               tokens_generated=0, engine_stats=None)]
    for mod_a, mod_b in ((jmetrics, tmetrics),):
        assert mod_b.LATENCY_KEYS == mod_a.LATENCY_KEYS
        for r in reqs:
            assert mod_b.summarize_requests(r) == mod_a.summarize_requests(r)
        nodes_a = [mod_a.summarize_node(r, **k) for r, k in zip(reqs, kw)]
        nodes_b = [mod_b.summarize_node(r, **k) for r, k in zip(reqs, kw)]
        assert nodes_b == nodes_a
        pooled_a = mod_a.RequestStats.merged([mod_a._as_stats(r) for r in reqs])
        pooled_b = mod_b.RequestStats.merged([mod_b._as_stats(r) for r in reqs])
        assert mod_b.summarize_fleet(nodes_b, pooled_b) == mod_a.summarize_fleet(nodes_a,
                                                                                 pooled_a)
        assert mod_b.percentiles([]) == mod_a.percentiles([])


# ------------------------------------------------------------ engine knobs
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
    return [pool.setdefault(n, rng.integers(1, 512, n).tolist()) for n in lens]


def _serve(cfg, params, prompts, **kw):
    eng = ServeEngine(cfg, params, max_slots=3, cache_len=48, prompt_bucket=8, device="cpu",
                      **kw)
    reqs = eng.run([Request(prompt=list(p), max_new_tokens=n) for p, n in prompts])
    return eng, [(r.output, r.submit_tick, r.admit_tick, r.finish_tick) for r in reqs]


PROMPTS = list(zip(_prompts((5, 9, 5, 13, 7, 5, 9, 21), seed=8), (4, 1, 6, 3, 5, 2, 4, 3)))


@pytest.mark.parametrize("knobs", [dict(fastpath=False), dict(batched_prefill=False),
                                   dict(active_decode=False),
                                   dict(fastpath=False, batched_prefill=True)])
def test_engine_knobs_leave_tokens_and_ticks_equal(weights, knobs):
    _, tcfg = _cfgs(long_context_window=None)
    fast, want = _serve(tcfg, weights[1], PROMPTS)
    eng, got = _serve(tcfg, weights[1], PROMPTS, **knobs)
    assert got == want
    assert fast.prefix_hits > 0
    if knobs.get("fastpath") is False:
        assert eng.prefix_hits == eng.prefix_misses == 0 and eng.stats()["cache_hit_rate"] == 0
    if knobs.get("active_decode") is False or knobs.get("fastpath") is False:
        # one whole-pool decode forward per busy tick
        assert eng.decode_forwards == max(r[3] for r in want) - min(r[2] for r in want) + 1
    if knobs.get("batched_prefill") is False or knobs.get("fastpath") is False:
        assert eng.prefill_forwards == len(PROMPTS) - eng.prefill_skipped
    assert fast.prefill_forwards < eng.prefill_forwards or knobs == dict(active_decode=False)


def test_engine_pre_cache_twin_matches_reference(weights):
    """fastpath=False against the reference's own pre-cache engine: tokens,
    tick stamps and the prefix-cache counters.  ``max_prefill_programs`` is
    accepted and bounds nothing (the port compiles no programs)."""
    from repro.serving import Request as JRequest

    jcfg, tcfg = _cfgs(long_context_window=None)
    kw = dict(max_slots=3, cache_len=48, prompt_bucket=8, fastpath=False,
              max_prefill_programs=2)
    jeng = JEngine(jcfg, weights[0], **kw)
    jreqs = jeng.run([JRequest(prompt=list(p), max_new_tokens=n) for p, n in PROMPTS])
    teng, got = _serve(tcfg, weights[1], PROMPTS, fastpath=False, max_prefill_programs=2)
    assert got == [(r.output, r.submit_tick, r.admit_tick, r.finish_tick) for r in jreqs]
    js, ts = jeng.stats(), teng.stats()
    for key in ("prefix_hits", "prefix_misses", "prefill_skipped", "cache_hit_rate"):
        assert ts[key] == js[key], key
    # one batch-1 prefill per request, one whole-pool decode per busy tick
    assert teng.prefill_forwards == len(PROMPTS) and ts["prefill_evictions"] == 0
    assert teng.decode_forwards == max(r[3] for r in got) - min(r[2] for r in got) + 1


def test_engine_custom_sample_gets_the_engines_generator(weights):
    _, tcfg = _cfgs(long_context_window=None)
    seen = []

    def sample(logits, generator):
        seen.append((tuple(logits.shape), generator))
        return torch.multinomial(torch.softmax(logits, -1), 1, generator=generator)[:, 0]

    eng, got = _serve(tcfg, weights[1], PROMPTS[:4], sample=sample)
    assert seen and all(g is eng.generator for _, g in seen)
    assert all(shape[1] == tcfg.vocab_size and shape[0] in (1, 2, 3) for shape, _ in seen)
    _, again = _serve(tcfg, weights[1], PROMPTS[:4], sample=sample)
    assert again == got  # the generator is seeded
    assert [len(o) for o, *_ in got] == [n for _, n in PROMPTS[:4]]


# ------------------------------------------------------------------ suite S
def _bench_rows():
    return json.loads((ROOT / "BENCH_S.json").read_text())["rows"]


def _suite_s_row(fleet, util, prompts=None):
    (row,) = [r for r in _bench_rows() if r["kind"] == "latency" and r["fleet"] == fleet
              and r["util"] == util and r.get("prompts") == prompts and "fastpath" not in r]
    return row


def _fleet(mod, cfg, params, m, slots, rate, *, mode="iid", n=170, policy="reject",
           max_queue=None, output_max=8):
    """Suite S's fleet point (``benchmarks/bench_serving.py::_fleet_run``)."""
    lg = mod.loadgen.LoadGenConfig(num_nodes=m, rate=rate, vocab_size=cfg.vocab_size,
                                   prompt_min=4, prompt_max=24, output_min=1,
                                   output_max=output_max, seed=0, prompt_mode=mode,
                                   prompt_pool=64)
    nodes = [mod.fleet.FleetNode(
        i, mod.engine(cfg, params, max_slots=slots, cache_len=48, prompt_bucket=8),
        admission=mod.fleet.AdmissionControl(max_queue=max_queue or 6 * slots, policy=policy))
        for i in range(m)]
    fleet = mod.fleet.ServingFleet(nodes, mod.loadgen.LoadGenerator(lg))
    return fleet.run(max_requests=n, max_ticks=200_000), nodes


PORT = SimpleNamespace(loadgen=tloadgen, fleet=tfleet,
                       engine=lambda *a, **k: ServeEngine(*a, device="cpu", **k))
JAX = SimpleNamespace(loadgen=jloadgen, fleet=jfleet, engine=JEngine)


@pytest.fixture(scope="module")
def suite_s_model():
    cfg = dataclasses.replace(torch_config("qwen3-1.7b").reduced(), long_context_window=None)
    return cfg, TT.init_model(cfg, seed=0, device="cpu")


@pytest.mark.parametrize("fleet,util,prompts,mode", [
    ("m2s2", 0.4, None, "iid"), ("m2s2", 1.4, None, "iid"), ("m2s2", 0.8, "zipf", "pool"),
    ("m1s4", 0.8, None, "iid"), ("m2s2", 0.8, "unique", "unique")])
def test_fleet_reproduces_suite_s(suite_s_model, fleet, util, prompts, mode):
    row = _suite_s_row(fleet, util, prompts)
    m, slots = {"m2s2": (2, 2), "m1s4": (1, 4)}[fleet]
    rep, _ = _fleet(PORT, *suite_s_model, m, slots, row["rate"], mode=mode)
    f = rep.fleet
    got = {k: f[k] for k in ("completed", "rejected", "shed", "p50_ttft_ticks",
                             "p95_ttft_ticks", "p99_ttft_ticks", "cache_hit_rate")}
    want = {k: row[k] for k in got}
    assert (rep.offered, rep.ticks, got) == (row["requests"], row["ticks"], want)
    assert f["completed"] + f["rejected"] + f["shed"] == rep.offered
    assert f["mean_queue_depth"] == row["mean_queue_depth"]
    assert f["slot_occupancy"] == row["slot_occupancy"]


# ------------------------------------------------- JAX fleet against the port's
@pytest.mark.parametrize("policy,mode", [("reject", "pool"), ("shed_oldest", "iid")])
def test_fleet_matches_jax_fleet(weights, policy, mode):
    """~30 requests under overload (queue 2) on 2 nodes x 2 slots: equal
    tokens, tick stamps, statuses and tick fields."""
    jcfg, tcfg = _cfgs(long_context_window=None)
    jp, tp = weights
    kw = dict(mode=mode, n=30, policy=policy, max_queue=2, output_max=6)
    (jrep, jnodes), (trep, tnodes) = (_fleet(JAX, jcfg, jp, 2, 2, 1.2, **kw),
                                      _fleet(PORT, tcfg, tp, 2, 2, 1.2, **kw))
    assert (trep.offered, trep.ticks) == (jrep.offered, jrep.ticks)
    for k in TICK_FIELDS:
        assert trep.fleet[k] == jrep.fleet[k], k
    assert jrep.fleet["rejected" if policy == "reject" else "shed"] > 0
    for jn, tn in zip(jnodes, tnodes):
        assert len(tn.requests) == len(jn.requests)
        for j, t in zip(jn.requests, tn.requests):
            assert (t.status, t.output, t.prompt) == (j.status, j.output, j.prompt)
            assert (t.submit_tick, t.admit_tick, t.finish_tick) == (
                j.submit_tick, j.admit_tick, j.finish_tick)


def test_admission_control_matches_reference():
    for policy in ("reject", "shed_oldest"):
        out = []
        for mod in (jfleet, tfleet):
            eng = SimpleNamespace(pending=deque())
            eng.submit = eng.pending.append
            ac = mod.AdmissionControl(max_queue=3, policy=policy)
            reqs = [SimpleNamespace(i=i, status="queued", finish_tick=-1) for i in range(8)]
            verdicts = [ac.offer(eng, r, tick=i // 2) for i, r in enumerate(reqs)]
            if policy == "shed_oldest":
                eng.pending.popleft()  # the engine admits one; two more arrive
                verdicts += [ac.offer(eng, SimpleNamespace(i=i, status="queued"), tick=9)
                             for i in (8, 9)]
            out.append((verdicts, [(r.i, r.status, r.submit_tick, r.finish_tick)
                                   for r in reqs], [r.i for r in eng.pending]))
        assert out[1] == out[0]
    with pytest.raises(ValueError):
        tfleet.AdmissionControl(policy="lifo")


# ------------------------------------------------- hot reload and checkpoints
def _torn(path):
    with open(path, "wb") as f:
        f.write(b"PK\x03\x04 torn in flight")


def test_save_fsyncs_the_directory(tmp_path, monkeypatch):
    calls = []
    monkeypatch.setattr(tnpz, "_fsync_dir", calls.append)
    fname = tckpt.save(str(tmp_path / "sub" / "ck"), {"a": torch.ones(3)}, step=7)
    assert calls == [str(tmp_path / "sub")] and os.path.basename(fname) == "ck_00000007.npz"
    assert not [f for f in os.listdir(tmp_path / "sub") if f.endswith(".tmp")]


def test_restore_latest_and_hot_reloader_skip_a_torn_file(tmp_path):
    """The port's reloader and the reference's, on the same files (written
    by the reference's save, f32): both skip the torn newer step."""
    prefix = str(tmp_path / "consensus")
    tree = {"w": np.full((3, 2), 1.0, np.float32), "b": np.zeros(2, np.float32)}
    template = {k: torch.from_numpy(v) for k, v in tree.items()}
    jr = jfleet.HotReloader(prefix, tree, log=lambda s: None)
    tr = tfleet.HotReloader(prefix, template, log=lambda s: None)
    assert tr.poll() is None and tckpt.restore_latest(prefix, template, device="cpu") == (
        None, None)
    for step, scale in ((10, 1.0), (20, 2.0)):
        jckpt.save(prefix, {k: v * scale for k, v in tree.items()}, step=step)
    _torn(tckpt.step_path(prefix, 30))
    logs = []
    got, step = tckpt.restore_latest(prefix, template, log=logs.append, device="cpu")
    assert step == 20 and torch.equal(got["w"], torch.full((3, 2), 2.0)) and len(logs) == 1
    (jtree, jstep), (ttree, tstep) = jr.poll(), tr.poll()
    assert tstep == jstep == 20 and tr.skipped == jr.skipped == 1
    np.testing.assert_array_equal(ttree["w"].numpy(), np.asarray(jtree["w"]))
    assert tr.poll() is None and jr.poll() is None  # nothing newer that loads
    tckpt.save(prefix, {k: v * 3 for k, v in template.items()}, step=40)
    assert tr.poll()[1] == jr.poll()[1] == 40 and tr.reloads == 2
    assert tr.device == torch.device("cpu")


def test_fleet_node_hot_reload_clears_the_prefix_cache(weights, tmp_path):
    _, tcfg = _cfgs(long_context_window=None)
    tp = weights[1]
    prefix = str(tmp_path / "serve")
    node = tfleet.FleetNode(0, ServeEngine(tcfg, tp, max_slots=2, cache_len=48, prompt_bucket=8,
                                           device="cpu"),
                            reloader=tfleet.HotReloader(prefix, tp, log=lambda s: None))
    for p, n in PROMPTS[:3]:
        node.offer(Request(prompt=list(p), max_new_tokens=n), tick=0)
    while not node.drained:
        node.tick()
    assert node.engine.stats()["prefix_entries"] > 0 and node.maybe_reload() is None
    tckpt.save(prefix, tp, step=1)
    _torn(tckpt.step_path(prefix, 2))
    assert node.maybe_reload() == 1 and node.reloader.skipped == 1
    assert node.engine.params_version == 1 and node.engine.stats()["prefix_entries"] == 0
    assert node.engine.prefix_invalidations == 1
    assert torch.equal(node.engine.params["layers"][0]["mixer"]["wq"], tp["layers"][0]["mixer"]["wq"])


def test_shared_reloaders_restore_each_step_once(weights, tmp_path, monkeypatch):
    """Nodes following one prefix read each step once and serve one tree."""
    _, tcfg = _cfgs(long_context_window=None)
    tp = weights[1]
    prefix = str(tmp_path / "serve")
    reads = []
    real = tfleet.restore
    monkeypatch.setattr(tfleet, "restore", lambda *a, **k: reads.append(a[0]) or real(*a, **k))
    nodes = [tfleet.FleetNode(i, ServeEngine(tcfg, tp, max_slots=2, cache_len=48,
                                             prompt_bucket=8, device="cpu"), reloader=r)
             for i, r in enumerate(tfleet.HotReloader.for_nodes(prefix, tp, 3,
                                                                log=lambda s: None))]
    for step in (1, 2):
        tckpt.save(prefix, tp, step=step)
        _torn(tckpt.step_path(prefix, step + 10))
        assert [n.maybe_reload() for n in nodes] == [step] * 3
        assert all(n.engine.params is nodes[0].engine.params for n in nodes)
        assert nodes[0].engine.params is not tp
    # each good step read once; a torn newer step is tried by every node on
    # every poll, as the reference's (steps 11, then 12 and 11)
    good = [f for f in reads if not f.endswith(("00000011.npz", "00000012.npz"))]
    assert good == [tckpt.step_path(prefix, 1), tckpt.step_path(prefix, 2)]
    assert [n.reloader.skipped for n in nodes] == [3, 3, 3]
    with pytest.raises(ValueError):
        tfleet.HotReloader(str(tmp_path / "other"), tp, share=nodes[0].reloader)


# ---------------------------------------------- classifier engine and probe
def test_classifier_fleet_and_probe_match_reference(tmp_path):
    """A fleet of classifier engines per side following the same checkpoints
    (the reference's save): equal served predictions, probes within 1e-6,
    equal probe_forwards."""
    import jax.numpy as jnp

    from repro.data import rotated_minority_classification

    m = 3
    data = rotated_minority_classification(num_nodes=m, minority_nodes=1, seed=0)
    rng = np.random.default_rng(0)
    steps = [{"w": rng.normal(size=(data.dim, data.num_classes)).astype(np.float32),
              "b": rng.normal(size=data.num_classes).astype(np.float32)} for _ in range(3)]
    pops = {n: (x, y) for n, x, y in zip(data.val_names, data.val_x, data.val_y)}

    def jloss(params, batch, rng_):
        x, y = batch
        logits = x @ params["w"] + params["b"]
        gold = jnp.take_along_axis(logits, y[:, None], axis=-1)[:, 0]
        return (jax.nn.logsumexp(logits, axis=-1) - gold).mean()

    def build(mod, apply_fn, loss_fn, template, prefix):
        probe = mod.BatchedProbe(apply_fn, pops, loss_fn=loss_fn)

        def payload(node, rng_, plen, max_new):
            idx = int(rng_.integers(0, data.x[node].shape[0]))
            return mod.EvalRequest(features=data.x[node][idx:idx + 1],
                                   labels=data.y[node][idx:idx + 1])

        lg = jloadgen if mod is jfleet else tloadgen
        gen = lg.LoadGenerator(lg.LoadGenConfig(num_nodes=m, rate=1.5, vocab_size=16, seed=1),
                               payload=payload)
        nodes = [mod.FleetNode(i, mod.ClassifierEngine(apply_fn, template, max_slots=2),
                               admission=mod.AdmissionControl(max_queue=4),
                               reloader=mod.HotReloader(prefix, template, log=lambda s: None),
                               quality_fn=probe.quality_fn(data.val_names[i % 2]))
                 for i in range(m)]
        return mod.ServingFleet(nodes, gen, reload_every=1), nodes, probe

    prefix = str(tmp_path / "cls")
    jfl, jnodes, jprobe = build(jfleet, lambda p, x: x @ p["w"] + p["b"], jloss,
                                {k: np.zeros_like(v) for k, v in steps[0].items()}, prefix)
    tfl, tnodes, tprobe = build(tfleet, train_serve.logistic_apply, train_serve.loss_fn,
                                {k: torch.zeros(v.shape) for k, v in steps[0].items()}, prefix)
    for s, tree in enumerate(steps):
        jckpt.save(prefix, tree, step=s + 1)
        for fl in (jfl, tfl):
            fl.run(max_requests=fl.offered + 20, max_ticks=10_000)
    assert tprobe.probe_forwards == jprobe.probe_forwards == 4  # start + 3 steps
    for jn, tn in zip(jnodes, tnodes):
        assert [s for s, _ in tn.quality_timeline] == [s for s, _ in jn.quality_timeline]
        for (_, jq), (_, tq) in zip(jn.quality_timeline, tn.quality_timeline):
            assert tq["acc"] == jq["acc"]
            assert abs(tq["loss"] - jq["loss"]) <= 1e-6
        assert [(r.output, r.status, r.admit_tick) for r in tn.requests] == [
            (r.output, r.status, r.admit_tick) for r in jn.requests]
        assert tn.engine.tokens_generated == jn.engine.tokens_generated
    # the oversized-batch path (more rows than slots) predicts the same
    eng = tfleet.ClassifierEngine(train_serve.logistic_apply,
                                  {k: torch.from_numpy(v) for k, v in steps[1].items()},
                                  max_slots=2)
    x = data.val_x[0][:5]
    np.testing.assert_array_equal(eng._forward(x),
                                  np.argmax(x @ steps[1]["w"] + steps[1]["b"], axis=-1))


def test_train_serve_loop_on_the_cpu():
    rows = train_serve.run(phases=2, rounds=15, compressor="kq4b", num_nodes=4,
                           minority_nodes=1, device="cpu", log=lambda s: None)
    assert [r["algo"] for r in rows] == ["adgda", "unweighted"]
    for r in rows:
        assert r["reloads"] == 2 * 4 and r["reload_skipped"] == 0
        assert r["probe_forwards"] == 3.0  # start + one per checkpoint step
        assert r["requests"] >= 2 * 30 * 4 and r["steps"] == 30
        assert 0.0 <= r["worst_node_acc"] <= r["mean_node_acc"] <= 1.0


def _suite_s_train_serve(algo):
    (row,) = [r for r in _bench_rows() if r["kind"] == "train_serve" and r["algo"] == algo]
    return row


@pytest.mark.parametrize("compressor", ["q4b", "kq4b"])
def test_train_serve_reproduces_suite_s(compressor):
    """Suite S's quick train_serve point (m10s4, 4 phases x 100 rounds, rate
    0.8; the reference trains with q4b): the counts and accuracies of both
    ``BENCH_S.json`` rows exactly, the probe loss within 1e-4 relative (400
    rounds of f32 in another summation order), and
    AD-GDA's worst node above the unweighted twin's."""
    rows = train_serve.run(compressor=compressor, device="cpu", log=lambda s: None)
    for got in rows:
        want = _suite_s_train_serve(got["algo"])
        for k in ("fleet", "rate", "requests", "steps", "reloads", "reload_skipped",
                  "probe_forwards", "first_worst_acc", "worst_node_acc", "mean_node_acc",
                  "served_worst_acc"):
            assert got[k] == want[k], (got["algo"], k)
        assert got["worst_node_loss"] == pytest.approx(want["worst_node_loss"], rel=1e-4)
    adgda, unweighted = rows
    assert adgda["worst_node_acc"] > unweighted["worst_node_acc"]


# ---------------------------------------------------------------- the CLI
def test_serve_fleet_cli_on_cpu(tmp_path):
    argv = ["--arch", "qwen3-1.7b", "--reduced", "--device", "cpu", "--fleet", "2",
            "--rate", "0.5", "--requests", "24", "--prompt-len", "12", "--gen", "4",
            "--prompts", "zipf", "--prompt-pool", "4"]
    out = tmp_path / "fleet.json"
    fast = tserve.main(argv + ["--metrics-out", str(out)])
    saved = json.loads(out.read_text())
    assert saved["offered"] == fast["offered"] >= 24 and saved["metrics"]["completed"] > 0
    assert len(saved["nodes"]) == 2 and fast["prefill_forwards"] > 0
    twin = tserve.main(argv + ["--no-fastpath"])
    assert twin["ticks"] == fast["ticks"]
    for k in ("completed", "rejected", "shed", "p50_ttft_ticks", "p95_ttft_ticks",
              "p99_ttft_ticks"):
        assert twin["metrics"][k] == fast["metrics"][k], k
    with pytest.raises(SystemExit):
        tserve.main(argv + ["--follow"])


def test_serve_fleet_cli_follows_checkpoints(tmp_path):
    cfg = torch_config("qwen3-1.7b").reduced()
    gen = torch.Generator().manual_seed(0)
    params = TT.init_model(cfg, generator=gen, device="cpu")
    prefix = str(tmp_path / "consensus")
    tckpt.save(prefix, params, step=3)
    _torn(tckpt.step_path(prefix, 4))
    out = tserve.main(["--arch", "qwen3-1.7b", "--reduced", "--device", "cpu", "--fleet", "2",
                       "--requests", "10", "--prompt-len", "8", "--gen", "3", "--follow",
                       "--restore", prefix, "--reload-every", "4"])
    assert out["reloads"] == 2 and out["reload_steps"] == [3, 3]
