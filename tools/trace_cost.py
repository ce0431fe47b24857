"""What the port's spans cost on the card, in one cell of ``BENCHMARK.json``:

    python3 tools/trace_cost.py --workload <cell> --seed <n>

from the root of a checkout, on a machine with a CUDA card.  The cell's
trainer and batches are made as ``portbench/harness.py`` makes them, and its
checked rounds run first.  Then:

0. the kernels' launches in one round (``kernels.launch_counts``, the
   wrappers that launched);
1. the recorder alone: the host time of a round's six coarse spans with
   nothing inside them, the recorder on and off (``tracing.enabled``);
2. rounds with the recorder on and off, in alternating blocks of
   ``BLOCK_S`` seconds (``BLOCKS`` each) ending at a ``synchronize``: the
   host clock's time a round, and over the recorded rounds each section's
   median device ms, host ms and lag (how far the device trails the host at
   the section's end, ms);
3. the profiled rounds (two a take, as the harness's) with the fine spans
   and without them (``tracing.span`` made to give every fine name the
   profiler-off span), alternating: their wall time;
4. the device clock's placement on the host clock after all that: an event
   recorded right after a ``synchronize``, placed through the recorder's
   anchor, less the host time it was recorded at.

Prints one JSON line.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

SECTIONS = ("forward_backward", "optimizer", "dual", "consensus", "consensus_err")
BLOCKS, BLOCK_S = 4, 8.0


def _empty_rounds(tracing, dev, n: int) -> float:
    """Host us a round of the six coarse spans with nothing inside."""
    t0 = time.perf_counter_ns()
    for _ in range(n):
        with tracing.span("round", device=dev):
            for name in SECTIONS:
                with tracing.span(name):
                    pass
    return (time.perf_counter_ns() - t0) / n / 1e3


def _section(spans, name: str) -> dict:
    """Median device ms, host ms and lag (ms) of the recorded spans ``name``."""
    spans = [s for s in spans if s.name == name]

    def median(f):
        return statistics.median(f(s) for s in spans)

    return {"device_ms": median(lambda s: s.device_ms),
            "host_ms": median(lambda s: (s.host_end_ns - s.host_start_ns) / 1e6),
            "lag_ms": median(lambda s: (s.device_end_ns - s.host_end_ns) / 1e6)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from portbench import data, harness, spec
    from portbench.reference import seeds
    from repro_torch import kernels, tracing

    if not torch.cuda.is_available():
        print("trace_cost: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    sync = lambda: torch.cuda.synchronize(dev)  # noqa: E731
    torch.set_num_threads(1)
    cell = spec.find_cell(spec.load_benchmark(), args.workload)
    model = spec.load_config(cell["config"])["model"]
    wl = spec.load_workload(cell["traffic"])
    trainer, state = harness.build(model, wl, args.seed, dev)
    checked, pool = data.batches(wl, model["vocab_size"], seeds(args.seed)["data"])
    pool = [{"tokens": torch.from_numpy(b).to(dev)} for b in checked + pool]
    for b in pool[:3]:
        state, _ = trainer.step(state, b)
    sync()
    out = {"workload": args.workload, "card": torch.cuda.get_device_name(dev)}

    # 0. the kernels' launches in one round
    kernels.reset_launch_counts()
    state, _ = trainer.step(state, pool[3])
    sync()
    out["launches_a_round"] = {name: n for name, n in kernels.launch_counts().items() if n}

    # 1. the recorder alone
    empty = {"on": [], "off": []}
    for _ in range(5):
        for key in ("on", "off"):
            tracing.enabled = key == "on"
            empty[key].append(_empty_rounds(tracing, dev, 2000))
    tracing.enabled = True
    sync()
    out["empty_round_us"] = {k: statistics.median(v) for k, v in empty.items()}
    out["recorder_us_a_round"] = out["empty_round_us"]["on"] - out["empty_round_us"]["off"]

    # 2. rounds, the recorder on and off
    rounds = {"on": [], "off": []}
    k = n_on = 0
    for block in range(2 * BLOCKS):
        key = ("on", "off")[block % 2]
        tracing.enabled = key == "on"
        sync()
        t0, n = time.perf_counter(), 0
        while time.perf_counter() - t0 < BLOCK_S:
            state, _ = trainer.step(state, pool[k % len(pool)])
            k, n = k + 1, n + 1
        sync()
        rounds[key].append((time.perf_counter() - t0) / n * 1e3)
        n_on += n if key == "on" else 0
    tracing.enabled = True
    out["round_ms"] = rounds
    out["round_ms_median"] = {key: statistics.median(v) for key, v in rounds.items()}
    recorded = [s for r in tracing.rounds()[-n_on:] for s in r.spans]
    out["sections"] = {name: _section(recorded, name) for name in ("round",) + SECTIONS}

    # 3. profiled rounds with and without the fine spans
    coarse_only = lambda name, device=None: (tracing._Coarse(name, device)  # noqa: E731
                                             if name in tracing.COARSE else tracing._OFF)
    span = tracing.span
    profiled = {"fine": [], "coarse": []}
    for _ in range(2):
        for key in ("fine", "coarse"):
            tracing.span = span if key == "fine" else coarse_only
            sync()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
                t0 = time.perf_counter()
                for _ in range(harness.PROFILED_ROUNDS):
                    state, _ = trainer.step(state, pool[k % len(pool)])
                    k += 1
                sync()
                profiled[key].append((time.perf_counter() - t0) / harness.PROFILED_ROUNDS * 1e3)
    tracing.span = span
    out["profiled_round_ms"] = profiled

    # 4. the anchor's placement after the run
    sync()
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    t_host = time.perf_counter_ns()
    sync()
    anchor, anchor_ns = tracing.recorder._anchors[dev.index]
    out["placement_error_ms"] = (anchor_ns + anchor.elapsed_time(ev) * 1e6 - t_host) / 1e6
    out["since_anchor_s"] = (t_host - anchor_ns) / 1e9
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
