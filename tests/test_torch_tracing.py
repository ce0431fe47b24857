"""The port's spans (``repro_torch/tracing.py``) on the CPU, through
``DecentralizedTrainer.step`` on a tiny dense model (granite-20b's family,
MQA) and a tiny MoE model (deepseek-moe-16b's: a dense layer, then an
expert layer under remat).

- Under ``torch.profiler`` the fine spans nest where the work is: a node's
  ``oracle.forward`` / ``oracle.backward`` inside ``forward_backward``, the
  MoE sections inside the oracle, the dispatch gather's backward
  (``IndexBackward0``) inside ``moe.dispatch.backward``, the gossip's
  sections inside ``consensus`` on the fused ``kq4b`` path and on block
  top-k's packed path.
- Tracing changes nothing: a round under the profiler gives the bits of the
  same round without it, and without the profiler a round makes no
  profiler call.
- The recorder keeps at most its bound of rounds, flags the profiled ones,
  and nests its spans.
- On a card (marked ``cuda``): every coarse span gets its device time and
  its place on the host clock, and in the profiler's trace the device-side
  spans of ``forward_backward`` and ``consensus`` cover those of the fine
  spans inside them (the profiler gives each kernel to the innermost range
  only; the coarse spans' bracket kernels keep their spans whole).
"""
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import tracing
from repro_torch.configs import get_config
from repro_torch.kernels.ops import KernelBlockTopK
from repro_torch.launch.steps import make_trainer
from repro_torch.models import transformer as T
from repro_torch.tree import leaves
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

M, B, S = 2, 2, 16
SECTIONS = ("forward_backward", "optimizer", "dual", "consensus", "consensus_err")
MOE = ("moe.route", "moe.dispatch", "moe.experts", "moe.combine", "moe.shared")


def _compressor(kind):
    return KernelBlockTopK(0.25, 64) if kind == "btopk" else "kq4b"


def _setup(arch, kind="kq4b", device="cpu", seed=0):
    cfg = get_config(arch).reduced(layers=2, d_model=32, experts=4)
    trainer = make_trainer(cfg, M, compressor=_compressor(kind), fused_gossip=kind == "kq4b",
                           eta_theta=0.05, device=device)
    state = trainer.init(T.init_train_params(cfg, seed=seed, device=device), seed=seed + 1)
    g = torch.Generator().manual_seed(seed + 2)
    batches = [{"tokens": torch.randint(0, cfg.vocab_size, (M, B, S), generator=g).to(device)}
               for _ in range(2)]
    return trainer, state, batches


def _profiled_events(trainer, state, batch):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        state, aux = trainer.step(state, batch)
    return state, aux, [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()]


def _named(events, name):
    return [(lo, hi) for n, lo, hi in events if n == name]


def _inside(span, outer):
    return any(lo <= span[0] and span[1] <= hi for lo, hi in outer)


@pytest.fixture(scope="module")
def moe_events():
    trainer, state, batches = _setup("deepseek-moe-16b")
    state, _ = trainer.step(state, batches[0])
    return _profiled_events(trainer, state, batches[1])[2]


@pytest.mark.parametrize("arch", ["granite-20b", "deepseek-moe-16b"])
def test_oracle_spans_once_a_node_inside_forward_backward(arch, moe_events):
    if arch == "deepseek-moe-16b":
        events = moe_events
    else:
        trainer, state, batches = _setup(arch)
        events = _profiled_events(trainer, state, batches[0])[2]
    fb = _named(events, "forward_backward")
    assert len(fb) == 1
    for name in ("oracle.forward", "oracle.backward"):
        spans = _named(events, name)
        assert len(spans) == M, name
        assert all(_inside(s, fb) for s in spans), name
    for name in SECTIONS:
        assert len(_named(events, name)) == 1, name
    assert all(_inside(s, _named(events, "round")) for s in fb)


def test_moe_sections_inside_the_oracle(moe_events):
    fwd = _named(moe_events, "oracle.forward")
    bwd = _named(moe_events, "oracle.backward")
    for name in MOE:
        spans = _named(moe_events, name)
        # once a node in the forward, once more in the backward's recompute (remat)
        assert sum(_inside(s, fwd) for s in spans) == M, name
        assert sum(_inside(s, bwd) for s in spans) == M, name
        backward = _named(moe_events, f"{name}.backward")
        assert len(backward) == M and all(_inside(s, bwd) for s in backward), name


def test_dispatch_gather_backward_inside_dispatch_backward(moe_events):
    # the dispatch op's backward (kernels/moe_dispatch.py), once a node
    index_bwd = _named(moe_events, "MoEDispatchBackward")
    dispatch_bwd = _named(moe_events, "moe.dispatch.backward")
    assert len(index_bwd) == M
    assert all(_inside(s, dispatch_bwd) for s in index_bwd)
    # and outside every other section's backward
    for name in MOE:
        if name != "moe.dispatch":
            assert not any(_inside(s, _named(moe_events, f"{name}.backward"))
                           for s in index_bwd), name


@pytest.mark.parametrize("kind,sections", [
    ("kq4b", ("gossip.noise", "gossip.copy", "gossip.fused")),
    ("btopk", ("gossip.noise", "gossip.copy", "gossip.encode", "gossip.decode", "gossip.mix")),
])
def test_gossip_sections_inside_consensus(kind, sections):
    trainer, state, batches = _setup("deepseek-moe-16b", kind)
    events = _profiled_events(trainer, state, batches[0])[2]
    consensus = _named(events, "consensus")
    n_leaves = len(leaves(state.theta))
    for name in sections:
        spans = _named(events, name)
        assert len(spans) >= n_leaves * (2 if name == "gossip.copy" else 1), name
        assert all(_inside(s, consensus) for s in spans), name
    absent = {"gossip.fused"} if kind == "btopk" else {"gossip.encode", "gossip.decode",
                                                      "gossip.mix"}
    assert not any(n in absent for n, _, _ in events)


def _snapshot(state, aux):
    return ([x.clone() for x in leaves(state.theta)]
            + [x.clone() for x in leaves(state.consensus.theta_hat)]
            + [x.clone() for x in leaves(state.consensus.s)]
            + [state.lam.clone(), aux["losses"].clone()])


@pytest.mark.parametrize("kind", ["kq4b", "btopk"])
def test_profiled_round_is_bit_identical(kind):
    out = []
    for traced in (False, True):
        trainer, state, batches = _setup("deepseek-moe-16b", kind)
        state, _ = trainer.step(state, batches[0])
        if traced:
            state, aux, _ = _profiled_events(trainer, state, batches[1])
        else:
            state, aux = trainer.step(state, batches[1])
        out.append(_snapshot(state, aux))
    for a, b in zip(*out):
        assert torch.equal(a, b)


def test_untraced_round_enters_no_record_function(monkeypatch):
    trainer, state, batches = _setup("deepseek-moe-16b", "btopk")
    enter = torch.ops.profiler._record_function_enter_new
    calls = []

    def counted(*args):
        calls.append(args[0])
        return enter(*args)

    monkeypatch.setattr(torch.ops.profiler, "_record_function_enter_new", counted)
    state, _ = trainer.step(state, batches[0])
    assert calls == []
    with torch.profiler.record_function("probe"):  # the count sees a range
        pass
    assert calls == ["probe"]


def test_ring_keeps_its_bound_flags_profiled_rounds_and_nests(monkeypatch):
    monkeypatch.setattr(tracing, "recorder", tracing.Recorder(bound=3))
    trainer, state, batches = _setup("granite-20b")
    for r in range(5):
        if r == 3:
            state, _, _ = _profiled_events(trainer, state, batches[r % 2])
        else:
            state, _ = trainer.step(state, batches[r % 2])
    rounds = tracing.rounds()
    assert len(rounds) == 3
    assert [r.profiled for r in rounds] == [False, True, False]
    for r in rounds:
        assert [s.name for s in r.spans] == ["round", *SECTIONS]
        top = r.spans[0]
        assert top.parent is None and top.host_start_ns < top.host_end_ns
        for s in r.spans[1:]:
            assert s.parent == 0
            assert top.host_start_ns <= s.host_start_ns < s.host_end_ns <= top.host_end_ns
            assert s.device_ms is None and s.device_end_ns is None  # no card
        starts = [s.host_start_ns for s in r.spans[1:]]
        assert starts == sorted(starts)


def test_recorder_off_records_nothing(monkeypatch):
    monkeypatch.setattr(tracing, "recorder", tracing.Recorder())
    monkeypatch.setattr(tracing, "enabled", False)
    trainer, state, batches = _setup("granite-20b")
    trainer.step(state, batches[0])
    assert tracing.rounds() == []


def test_sections_outside_a_round_are_not_recorded(monkeypatch):
    monkeypatch.setattr(tracing, "recorder", tracing.Recorder())
    with tracing.span("consensus"):
        pass
    with tracing.span("round"):
        with tracing.span("dual"):
            with tracing.span("gossip.mix"):  # a fine span: not recorded
                pass
    rounds = tracing.rounds()
    assert len(rounds) == 1 and [s.name for s in rounds[0].spans] == ["round", "dual"]


@pytest.mark.cuda
def test_coarse_spans_carry_device_times_on_the_card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    monkeypatch.setattr(tracing, "recorder", tracing.Recorder())
    trainer, state, batches = _setup("deepseek-moe-16b", "kq4b", device="cuda")
    for r in range(3):
        state, _ = trainer.step(state, batches[r % 2])
    torch.cuda.synchronize()
    rounds = tracing.rounds()
    assert len(rounds) == 3
    for r in rounds:
        top = r.spans[0]
        for s in r.spans:
            assert s.device_ms is not None and s.device_ms >= 0
            assert s.device_start_ns <= s.device_end_ns
            # an event runs after the host records it (a few us of clock
            # placement allowed)
            assert s.device_end_ns >= s.host_end_ns - 100_000
        for s in r.spans[1:]:
            assert top.device_start_ns <= s.device_start_ns + 1000
            assert s.device_end_ns <= top.device_end_ns + 1000


def _gpu_ranges(prof, path):
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())
    events = events["traceEvents"] if isinstance(events, dict) else events
    out = {}
    for e in events:
        if e.get("cat") == "gpu_user_annotation" and "dur" in e:
            out.setdefault(e["name"], []).append((float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    return out


@pytest.mark.cuda
def test_coarse_device_spans_cover_their_fine_spans_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    trainer, state, batches = _setup("deepseek-moe-16b", "kq4b", device="cuda")
    state, _ = trainer.step(state, batches[0])
    for _ in range(3):  # the profiler now and then hands back no device event
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            state, _ = trainer.step(state, batches[1])
            torch.cuda.synchronize()
        gpu = _gpu_ranges(prof, tmp_path / "trace.json")
        if gpu:
            break
    for coarse, fine in (("forward_backward", ("oracle.forward", "moe.dispatch")),
                         ("consensus", ("gossip.noise", "gossip.copy", "gossip.fused"))):
        (outer,) = gpu[coarse]
        for name in fine:
            assert gpu[name] and all(_inside(s, [outer]) for s in gpu[name]), name
    assert len(gpu["moe.dispatch.backward"]) == M
