"""The readers of the program's spans: the window's ``forward_backward``
from the program's recorder (``fwd_bwd_untraced_ms``, ``fwd_bwd_host_ms``,
``fwd_bwd_lag_ms``) and the profiled rounds' ``moe.dispatch`` and
``gossip.copy`` ranges (``moe_dispatch_ms``, ``gossip_copy_ms``).

The recorder's device times need a card: here the rounds run on the CPU
and each recorded span is then given a pair of stub events whose device
clock is the host's shifted by a known lag, so every reading is known by
hand."""
import statistics
import sys

import pytest
import torch

from conftest import small_model
from portbench import harness, spec, trace
from portbench.metrics import reader
from repro_torch import tracing

RECORDER = ("fwd_bwd_untraced_ms", "fwd_bwd_host_ms", "fwd_bwd_lag_ms")
TRACE = ("moe_dispatch_ms", "gossip_copy_ms")
CHECKED, WINDOW = 3, 4


def _traced(on_card=True, window_rounds=WINDOW, tr=None):
    return harness.Traced(tr, 2, 1.0, window_rounds, 1.0, 0.0, None, on_card)


@pytest.mark.parametrize("name", RECORDER + TRACE)
def test_nothing_to_read_gives_none(name, monkeypatch):
    monkeypatch.setattr(tracing, "recorder", tracing.Recorder())  # no round recorded
    read = reader(name)
    assert read(harness.Traced(None, 2, 0.0, 0, 0.0, 0.0, None, False)) is None
    assert read(_traced(on_card=False)) is None  # off the card
    assert read(_traced(tr=trace.Trace([], [], []))) is None  # a trace without the ranges


class _Event:
    """A completed timing event at ``t`` ms of a device clock."""

    def __init__(self, t):
        self.t = t

    def query(self):
        return True

    def elapsed_time(self, other):
        return other.t - self.t


ANCHOR_NS, ANCHOR_MS = 1_000, 5.0  # the device clock reads 5 ms at host ns 1000


def _device_clock(ns, lag_ms):
    return ANCHOR_MS + (ns - ANCHOR_NS) / 1e6 + lag_ms


@pytest.fixture()
def recorded(monkeypatch):
    """CPU rounds: ``CHECKED`` before the window, ``WINDOW`` in it, one under
    the profiler after it; round ``k``'s spans start ``2k`` ms late on the
    device and run ``k`` ms longer there.  Returns the window's rounds."""
    rec = tracing.Recorder()
    monkeypatch.setattr(tracing, "recorder", rec)
    from repro_torch.launch.steps import make_trainer
    from repro_torch.models import transformer as T

    cfg = spec.model_config({"model": small_model("granite-20b", dtype="float32")})
    trainer = make_trainer(cfg, 2, compressor="kq4b", device="cpu")
    state = trainer.init(T.init_train_params(cfg, seed=0, device="cpu"), seed=1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 2, 8),
                                     generator=torch.Generator().manual_seed(2))}
    for _ in range(CHECKED + WINDOW):
        state, _ = trainer.step(state, batch)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        trainer.step(state, batch)
    rec._anchors[0] = (_Event(ANCHOR_MS), ANCHOR_NS)
    for k, (_, entries) in enumerate(rec.ring):
        for e in entries:
            e.dev = 0
            e.ev0 = _Event(_device_clock(e.t0, 2 * k))
            e.ev1 = _Event(_device_clock(e.t1, 3 * k))
    rounds = tracing.rounds()
    assert [r.profiled for r in rounds] == [False] * (CHECKED + WINDOW) + [True]
    return [(k, r) for k, r in enumerate(rounds)][CHECKED:CHECKED + WINDOW]


def _fwd_bwd(r):
    (s,) = [s for s in r.spans if s.name == "forward_backward"]
    return s


def test_recorder_readers_read_the_window(recorded):
    host = [(_fwd_bwd(r).host_end_ns - _fwd_bwd(r).host_start_ns) / 1e6 for _, r in recorded]
    want = {"fwd_bwd_host_ms": statistics.median(host),
            "fwd_bwd_untraced_ms": statistics.median(h + k for h, (k, _) in zip(host, recorded)),
            "fwd_bwd_lag_ms": statistics.median(3 * k for k, _ in recorded)}
    for name, value in want.items():
        assert reader(name)(_traced()) == pytest.approx(value, abs=1e-5), name
        assert reader(f"{name}.s128")(_traced()) == pytest.approx(value, abs=1e-5), name
    # a shorter window reads only its own last rounds
    last = recorded[-1][0]
    assert reader("fwd_bwd_lag_ms")(_traced(window_rounds=1)) == pytest.approx(3 * last)


def test_recorder_readers_skip_pending_events(recorded, monkeypatch):
    pending = _Event(0.0)
    monkeypatch.setattr(pending, "query", lambda: False)
    for _, entries in tracing.recorder.ring:
        for e in entries:
            e.ev1 = pending
    assert reader("fwd_bwd_untraced_ms")(_traced()) is None
    assert reader("fwd_bwd_lag_ms")(_traced()) is None
    assert reader("fwd_bwd_host_ms")(_traced()) is not None


@pytest.mark.parametrize("name", RECORDER)
def test_a_program_without_the_recorder_gives_none(name, monkeypatch):
    import repro_torch

    monkeypatch.delattr(repro_torch, "tracing")
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)  # its import fails
    assert reader(name)(_traced()) is None


def test_trace_readers_sum_their_ranges_a_round():
    ms = 1_000_000
    tr = trace.Trace(
        device=[("k", 0, ms)],
        gpu_ranges=[("moe.dispatch", 0, 2 * ms), ("moe.dispatch.backward", 5 * ms, 9 * ms),
                    ("moe.dispatch", 10 * ms, 13 * ms), ("moe.combine", 20 * ms, 40 * ms),
                    ("gossip.copy", 50 * ms, 51 * ms), ("gossip.copy", 60 * ms, 63 * ms),
                    ("consensus", 45 * ms, 70 * ms)],
        host_ranges=[])
    run = _traced(tr=tr)  # two profiled rounds
    assert reader("moe_dispatch_ms")(run) == pytest.approx((2 + 4 + 3) / 2)
    assert reader("moe_dispatch_ms.s128")(run) == pytest.approx((2 + 4 + 3) / 2)
    assert reader("gossip_copy_ms")(run) == pytest.approx((1 + 3) / 2)
    assert reader("gossip_copy_ms.s128")(run) == pytest.approx((1 + 3) / 2)
