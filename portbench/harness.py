"""One run of one cell: set-up, the measured window, the profiled rounds
(``--trace 1``), the correctness check, the result line.

Set-up makes the weights on the card from the seed (``weights.py``), builds
the trainer that ``repro_torch.launch.steps.make_trainer`` builds with the
cell's arguments, calls ``trainer.init``, makes the token batches from the
seed (``data.py``) and puts them on the card, and drives the trainer through
the checked rounds (``checked_rounds``, three) with ``trainer.step``, the
window's own call, on batches that all differ.  The program's readings are
taken after them (:func:`readings`).  The window then dispatches rounds,
cycling a pool of batches, with no host read, until ``--seconds`` have
passed on the host clock, and ends at the ``synchronize`` after the last
round.  With ``--trace 1`` two more rounds run under ``torch.profiler``.
After the window the peak memory is read, the program's state is freed, and
the plain reference (``reference/``) follows the checked rounds from the
same seed; ``correct`` holds when every gap is within the cell's limit.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import statistics
import sys
import time

import torch

from portbench import data, spec, trace, weights
from portbench.counting import flops, gossip_bytes
from portbench.metrics import reader
from portbench.reference import compare, follow, leaf_norms, seeds, start_norms

#: top-level modules the process that prints the result may not hold
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")
PROFILED_ROUNDS = 2


def parse(argv):
    ap = argparse.ArgumentParser(description="one run of one cell of BENCHMARK.json")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


@dataclasses.dataclass
class Traced:
    """What a per-layer metric's reader reads."""

    trace: trace.Trace | None
    profiled_rounds: int
    traced_s: float
    window_rounds: int
    window_s: float
    flops_per_round: float
    gossip: dict | None
    on_card: bool
    bits: float = 0.0
    peak: int = 0


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _compressor(wl: dict):
    comp = wl["compressor"]
    if "spec" in comp:
        return comp["spec"]
    if comp.get("kind") == "block_topk":
        from repro_torch.kernels.ops import KernelBlockTopK

        return KernelBlockTopK(comp["fraction"], comp["block"])
    raise ValueError(f"unknown compressor {comp!r}")


def build(model: dict, wl: dict, seed: int, dev):
    """The trainer and its initial state, the weights made from the seed."""
    from repro_torch.launch.steps import make_trainer
    from repro_torch.models import transformer as T

    cfg = spec.model_config({"model": model})
    weights.check_layout(model, T.abstract_train_params(cfg))
    trainer = make_trainer(
        cfg, wl["nodes"], topology=wl["topology"], compressor=_compressor(wl),
        alpha=wl["alpha"], eta_theta=wl["eta_theta"], eta_lambda=wl["eta_lambda"],
        fused_gossip=wl["fused_gossip"], track_average=False, device=dev)
    params = weights.make_params(model, seeds(seed)["weights"], dev)
    state = trainer.init(params, seed=seeds(seed)["gossip"])
    del params
    return trainer, state


def checked_rounds(trainer, state, batches):
    """Drive the checked rounds through ``trainer.step``; the first round's
    gradient norms are read where the optimizer gets them.  Returns (state,
    [aux per round], grad norms [leaf][node] as a device tensor)."""
    from repro_torch.optim import Optimizer

    local = trainer.local
    grab = {}

    def apply_(params, grads, opt_state, scale):
        grab["grad"] = torch.stack([torch.stack([torch.linalg.vector_norm(g, dtype=torch.float32)
                                                 for g in row]) for row in grads])
        return local.optimizer.apply_(params, grads, opt_state, scale)

    auxes = []
    for r, batch in enumerate(batches):
        trainer.local = (dataclasses.replace(local, optimizer=Optimizer(local.optimizer.init,
                                                                         apply_))
                         if r == 0 else local)
        try:
            state, aux = trainer.step(state, batch)
        finally:
            trainer.local = local
        auxes.append(aux)
    return state, auxes, grab["grad"]


def readings(model: dict, seed: int, state, auxes, grad, dev) -> dict:
    """The program's readings after the checked rounds (before the window's
    first round changes the state)."""
    from repro_torch.tree import leaves

    theta = leaves(state.theta)
    return {
        "loss": [[float(v) for v in a["losses"].float().cpu()] for a in auxes],
        "grad_norm": grad.cpu().tolist(),
        "delta_norm": start_norms(model, seed, theta, dev),
        "hat_norm": leaf_norms(leaves(state.consensus.theta_hat)),
        "s_norm": leaf_norms(leaves(state.consensus.s)),
        "cerr": [float(a["consensus_err"]) for a in auxes],
        "lam": state.lam.float().cpu().tolist(),
        "bits": [float(a["bits_realized"]) for a in auxes],
    }


def window(trainer, state, pool, seconds: float, dev):
    """Rounds until ``seconds`` have passed on the host clock, with no host
    read; ends at the synchronize after the last round.  Returns (state,
    rounds, elapsed s, [aux per round])."""
    from torch.profiler import record_function

    auxes, marks = [], []
    mark = (lambda: marks.append(torch.cuda.Event(enable_timing=True)) or marks[-1].record()
            ) if dev.type == "cuda" else (lambda: None)
    _sync(dev)
    t0 = time.perf_counter()
    mark()
    rounds = 0
    while True:
        with record_function("portbench.round"):
            state, aux = trainer.step(state, pool[rounds % len(pool)])
        mark()
        auxes.append(aux)
        rounds += 1
        if time.perf_counter() - t0 >= seconds:
            break
    _sync(dev)
    elapsed = time.perf_counter() - t0
    if marks:
        ms = sorted(a.elapsed_time(b) for a, b in zip(marks, marks[1:]))
        q = statistics.quantiles(ms, n=4) if len(ms) > 1 else ms * 3
        print(f"round ms on the device's clock: min {ms[0]:.2f}, quartiles "
              f"{', '.join(f'{x:.2f}' for x in q)}, max {ms[-1]:.2f}", file=sys.stderr)
    return state, rounds, elapsed, auxes


def profiled(trainer, state, pool, dev, tries: int = 3):
    """Two rounds under ``torch.profiler``: (state, trace, wall s).  The
    profiler now and then hands back a trace with no device event: up to
    ``tries`` traces are taken."""
    from torch.profiler import ProfilerActivity, profile, record_function

    for _ in range(tries):
        _sync(dev)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for r in range(PROFILED_ROUNDS):
                with record_function("portbench.round"):
                    state, _ = trainer.step(state, pool[r % len(pool)])
            _sync(dev)
            wall = time.perf_counter() - t0
        tr = trace.read(prof)
        if tr.device:
            return state, tr, wall
    return state, None, wall


def _device_block(dev, peak: int) -> dict:
    if dev.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": 1,
                "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": int(peak)}


def forbidden_modules() -> list[str]:
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def run(cell: dict, bench: dict, args, dev, t_start: float, data_root=None) -> dict:
    """One run; returns the result line."""
    conf = spec.load_config(cell["config"], data_root)
    wl = spec.load_workload(cell["traffic"], data_root)
    model = conf["model"]
    phases = {"start": time.perf_counter() - t_start}
    t0 = time.perf_counter()
    trainer, state = build(model, wl, args.seed, dev)
    _sync(dev)
    phases["build"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    checked_np, pool_np = data.batches(wl, model["vocab_size"], seeds(args.seed)["data"])
    to_dev = lambda b: {"tokens": torch.from_numpy(b).to(dev)}  # noqa: E731
    checked = [to_dev(b) for b in checked_np]
    pool = [to_dev(b) for b in pool_np]
    phases["batches"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    state, auxes, grad = checked_rounds(trainer, state, checked)
    _sync(dev)
    phases["checked_rounds"] = time.perf_counter() - t0
    print("set-up s: " + ", ".join(f"{k} {v:.3f}" for k, v in phases.items()), file=sys.stderr)
    t_read = time.perf_counter()
    prog = readings(model, args.seed, state, auxes, grad, dev)
    _sync(dev)
    read_s = time.perf_counter() - t_read
    setup_s = time.perf_counter() - t_start - read_s
    del auxes, grad

    state, rounds, elapsed, win = window(trainer, state, pool, args.seconds, dev)
    final = [a["losses"] for a in win]
    bits = max(float(a["bits_realized"]) for a in win)
    run_ = Traced(None, PROFILED_ROUNDS, 0.0, rounds, elapsed,
                  flops.per_round(model, wl), gossip_bytes.plan(model, wl), dev.type == "cuda")
    if args.trace:
        state, run_.trace, run_.traced_s = profiled(trainer, state, pool, dev)
    failed = sum(1 for x in final if not bool(torch.isfinite(x).all()))
    round_s = elapsed / rounds
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    run_.bits, run_.peak = bits, peak
    print(f"window: {rounds} rounds in {elapsed:.4f} s ({round_s:.4f} s a round); "
          f"last losses {[round(float(v), 4) for v in final[-1].cpu()]}; "
          f"setup {setup_s:.3f} s; readings {read_s:.3f} s", file=sys.stderr, flush=True)

    del state, trainer, pool, checked, win, final
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = follow(model, wl, args.seed, checked_np, dev)
    print(f"reference: {time.perf_counter() - t_ref:.3f} s", file=sys.stderr, flush=True)
    found = compare.gaps(prog, ref)
    correct, checks = compare.verdict(found, wl.get("limits", {}))

    tokens = rounds * wl["nodes"] * wl["batch_per_node"] * wl["seq"]
    e2e = {"train_tokens_per_s": tokens / elapsed, "setup_s": setup_s}
    metrics = {}
    kind = "per_layer" if args.trace else "end_to_end"
    for m in spec.cell_metrics(bench, cell["name"], kind):
        # a quantity split by cells (``train_tokens_per_s.s128``) is read by its base name
        value = (e2e.get(m["name"].split(".", 1)[0]) if kind == "end_to_end"
                 else reader(m["name"])(run_))
        if value is not None and math.isfinite(value):
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    line = {"correct": bool(correct and failed == 0), "attempted": rounds, "failed": failed,
            "metrics": metrics, "device": _device_block(dev, peak)}
    if args.trace and run_.trace is not None:
        line["device"].update(busy_s=run_.trace.busy_s(), window_s=run_.traced_s)
        line["breakdown"] = {"device_ops": run_.trace.top_ops(), "idle_gaps": run_.trace.idle_gaps()}
    line["checks"] = checks
    return line


def main(argv=None, *, t_start: float | None = None, device=None, bench_path=None,
         data_root=None) -> int:
    """Run one cell and print its line.  ``device`` (tests only) runs on the
    given device without looking for a card."""
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse(argv)
    bench = spec.load_benchmark(bench_path)
    cell = spec.find_cell(bench, args.workload)
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            print(f"portbench: the cell needs {cell['chips']} CUDA card(s); found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        dev = torch.device("cuda", 0)
        # one host thread for CPU ops: the round is launched from one thread,
        # and an intra-op pool's spinning workers would take its cores
        torch.set_num_threads(1)
    else:
        dev = torch.device(device)
    line = run(cell, bench, args, dev, t_start, data_root)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the process holds {bad} after the window", file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0

