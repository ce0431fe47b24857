"""The paper's small-model comparisons on the port, with the reference
benchmarks' settings (``benchmarks/bench_faults.py``,
``benchmarks/bench_comparison.py``): ten nodes, a logistic model on
``rotated_minority_classification``, ``q4b`` quantization (``kq4b``: the
same quantizer on the CUDA kernels).

* ``ft`` -- suite FT's rows: static ring, round-robin ring + torus and
  one-peer matchings, each at dropout 0, 0.1 and 0.3, and each under the
  wire faults ``drop:0.1,stale:2`` and ``corrupt:0.05,stale:2`` at dropout
  0 (400 rounds);
* ``ksweep`` -- cells of the gradient-tracking x local-steps sweep at a fixed
  budget of 800 gradient iterations (rounds = 800 / K, batch 50 K);
* ``t5`` -- Table 5 on ``rotated_minority``: AD-GDA, AD-GDA-K5,
  AD-GDA-GT-K5 and CHOCO-SGD on a torus, DR-DSGD, DRFA (600 iterations).

DRFA's result hangs on its first client samples: once lambda leaves a
node out it is never sampled again, so the minority nodes are in for the
run or out of it (worst accuracy about 0.8 or about 0.005).  A DRFA task
may therefore carry the client samples to use, one bitmask per round (the
reference's own, so the port follows its trajectory); without them the
port draws its own.

Each run is one task, ``(suite, name, seed[, samples])``; :func:`run_tasks` runs them
in this process or in a pool of worker processes (one card can hold many:
the rounds are bound by the host's per-op launches).  Each result carries
the worst-node accuracy, the final consensus error, the fault detections and
resyncs (network totals), the bits (per round, expected, realized, per
iteration, total), the seconds and the kernel launches of the run.

  PYTHONPATH=src python -m repro_torch.launch.comparisons --only ft,ksweep,t5 --device cpu
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.core import (
    ADGDAConfig,
    DRDSGDConfig,
    DRFAConfig,
    adgda_trainer,
    choco_sgd,
    drdsgd_trainer,
    drfa_trainer,
)
from repro_torch.data import rotated_minority_classification
from repro_torch.device import resolve_device
from repro_torch.tree import leaves

__all__ = ["logistic_init", "logistic_apply", "loss_fn", "make_adgda", "tasks", "run_task",
           "run_tasks", "FT_SCHEDULES", "FT_DROPOUTS", "FT_FAULTS", "KSWEEP_CELLS", "T5_ALGOS"]

M = 10
FT_SCHEDULES = {"static-ring": {"topology": "ring"},
                "rr-ring-torus": {"topology_schedule": "roundrobin:ring,torus"},
                "matching": {"topology_schedule": "matching:8"}}
FT_DROPOUTS = (0.0, 0.1, 0.3)
# the wire-fault sweep runs on the full graph, so each faulted row has a
# fault-free twin (same schedule, dropout 0) to be held against
FT_FAULTS = ("drop:0.1,stale:2", "corrupt:0.05,stale:2")
KSWEEP_CELLS = {"choco@8": ("choco", 8), "choco@16": ("choco", 16), "gt@16": ("gt", 16)}
# name -> (robust, local steps, consensus) for the AD-GDA family
T5_ALGOS = {"AD-GDA": (True, 1, "choco"), "AD-GDA-K5": (True, 5, "choco"),
            "AD-GDA-GT-K5": (True, 5, "gt"), "CHOCO-SGD": (False, 1, "choco"),
            "DR-DSGD": None, "DRFA": None}


# ------------------------------------------------------------------- model
def logistic_init(dim: int, classes: int, device) -> dict:
    return {"w": torch.zeros(dim, classes, device=device),
            "b": torch.zeros(classes, device=device)}


def logistic_apply(params, x):
    return x @ params["w"] + params["b"]


def loss_fn(params, batch, rng):
    x, y = batch
    logits = logistic_apply(params, x)
    gold = torch.gather(logits, -1, y.long()[:, None])[:, 0]
    return (torch.logsumexp(logits, dim=-1) - gold).mean()


def worst_accuracy(params, data, device) -> float:
    accs = []
    for x, y in zip(data.val_x, data.val_y):
        pred = torch.argmax(logistic_apply(params, torch.from_numpy(x).to(device)), -1)
        accs.append(float((pred.cpu().numpy() == y).mean()))
    return min(accs)


def make_adgda(m: int, *, robust: bool = True, compressor: str = "kq4b", device="cuda",
               **kw):
    """``benchmarks.common.make_adgda``'s settings: alpha 0.05, eta 0.3 / 0.2,
    decay 0.99, chi2."""
    cfg = ADGDAConfig(num_nodes=m, compressor=compressor, alpha=0.05, eta_theta=0.3,
                      eta_lambda=0.2, lr_decay=0.99, robust=robust, **kw)
    return (adgda_trainer if robust else choco_sgd)(cfg, loss_fn, device=device)


def _fault_telemetry(cons) -> tuple[float, float]:
    """Network totals of (digest detections, dense resyncs) over every
    lane's fault state; 0.0 without faults."""
    lanes = (cons.model, cons.tracker) if hasattr(cons, "tracker") else (cons,)
    det = res = 0.0
    for lane in lanes:
        fault = getattr(lane, "fault", None)
        if hasattr(fault, "detected"):
            det += float(fault.detected.sum())
            res += float(fault.resyncs.sum())
    return det, res


def _consensus_err(theta) -> float:
    """sum_i ||theta_i - theta_bar||^2 over the leaves, in f32 on the host
    (the reference benchmark's own reduction)."""
    err = 0.0
    for leaf in leaves(theta):
        x = leaf.detach().cpu().numpy().astype(np.float32)
        err += float(((x - x.mean(0)) ** 2).sum())
    return err


def _train(trainer, data, rounds: int, batch: int, seed: int, device, stacked_k=None,
           samples=None):
    """``rounds`` rounds from zeros (``samples``: DRFA's client bitmask of
    each round); returns (worst accuracy, bits and fault info)."""
    state = trainer.init(logistic_init(data.dim, data.num_classes, device), seed=seed)
    gen = data.batches(batch, seed=seed)
    bits = float(trainer.bits_per_round(state))
    realized = 0.0
    for r in range(rounds):
        xb, yb = next(gen)
        if stacked_k:  # DRFA: [m, K, b, ...]
            xb = xb.reshape(data.num_nodes, stacked_k, -1, data.dim)
            yb = yb.reshape(data.num_nodes, stacked_k, -1)
        sampled = (None if samples is None else
                   [float(samples[r] >> i & 1) for i in range(data.num_nodes)])
        state, aux = trainer.step(state, (torch.from_numpy(xb).to(device),
                                          torch.from_numpy(yb).to(device)), sampled=sampled)
        realized += aux["bits_realized"]
    detected, resyncs = _fault_telemetry(state.consensus)
    info = {"consensus_err": (_consensus_err(state.theta) if not trainer.federated
                              else 0.0),
            "faults_detected": detected, "resyncs": resyncs, "bits_per_round": bits,
            "bits_per_round_expected": float(trainer.bits_per_round(state, mode="expected")),
            "bits_per_iteration": float(trainer.bits_per_round(state, per_iteration=True)),
            "bits_per_round_realized": realized / rounds, "bits_realized_total": realized}
    return worst_accuracy(trainer.network_mean(state), data, device), info


# ------------------------------------------------------------------- tasks
def tasks(suites=("ft", "ksweep", "t5"), seeds=(0, 1)) -> list[tuple]:
    out = []
    for seed in seeds:
        if "ft" in suites:
            out += [("ft", f"{s}|{d:g}", seed) for s in FT_SCHEDULES for d in FT_DROPOUTS]
            out += [("ft", f"{s}|0|{f}", seed) for s in FT_SCHEDULES for f in FT_FAULTS]
        if "ksweep" in suites:
            out += [("ksweep", name, seed) for name in KSWEEP_CELLS]
        if "t5" in suites:
            out += [("t5", name, seed) for name in T5_ALGOS]
    return out


def run_task(task, device="cuda") -> dict:
    """One run; the result holds the task, its worst accuracy, bits,
    seconds and the CUDA kernels' launches during it."""
    from repro_torch.kernels import _build

    suite, name, seed = task[:3]
    samples = task[3] if len(task) > 3 else None
    dev = resolve_device(device)
    data = rotated_minority_classification(num_nodes=M, seed=seed)
    before = _build.launch_counts()
    t0 = time.perf_counter()
    if suite == "ft":
        sched, dropout, *fault = name.split("|")
        trainer = make_adgda(M, dropout=float(dropout), device=dev,
                             fault_spec=fault[0] if fault else None, **FT_SCHEDULES[sched])
        worst, info = _train(trainer, data, 400, 50, seed, dev)
    elif suite == "ksweep":
        consensus, k = KSWEEP_CELLS[name]
        trainer = make_adgda(M, consensus=consensus, local_steps=k, device=dev)
        worst, info = _train(trainer, data, max(1, 800 // k), 50 * k, seed, dev)
    elif name == "DR-DSGD":
        trainer = drdsgd_trainer(DRDSGDConfig(num_nodes=M, topology="torus", alpha=6.0,
                                              eta_theta=0.3, lr_decay=0.99), loss_fn,
                                 device=dev)
        worst, info = _train(trainer, data, 600, 50, seed, dev)
    elif name == "DRFA":
        k = 10
        trainer = drfa_trainer(DRFAConfig(num_nodes=M, participation=0.5, local_steps=k,
                                          eta_theta=0.3, eta_lambda=0.1, lr_decay=0.99),
                               loss_fn, device=dev)
        worst, info = _train(trainer, data, 600 // k, 50 * k, seed, dev, stacked_k=k,
                             samples=samples)
    else:
        robust, k, consensus = T5_ALGOS[name]
        trainer = make_adgda(M, robust=robust, topology="torus", local_steps=k,
                             consensus=consensus, device=dev)
        worst, info = _train(trainer, data, 600 // k, 50 * k, seed, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return {"suite": suite, "name": name, "seed": seed, "worst_acc": worst, **info,
            "samples": "own" if samples is None else "given",
            "seconds": time.perf_counter() - t0,
            "launches": {k: v - before.get(k, 0) for k, v in _build.launch_counts().items()
                         if v != before.get(k, 0)}}


def _worker_init() -> None:
    torch.set_num_threads(1)


def run_tasks(task_list, device="cuda", workers: int = 0) -> list[dict]:
    """Every task's result, in order; ``workers > 0`` spreads them over that
    many spawned processes (the pool is shut down before returning)."""
    if workers <= 0:
        return [run_task(t, device) for t in task_list]
    import concurrent.futures as cf
    import multiprocessing as mp

    with cf.ProcessPoolExecutor(workers, mp_context=mp.get_context("spawn"),
                                initializer=_worker_init) as pool:
        return list(pool.map(run_task, task_list, [str(device)] * len(task_list)))


def summarize(results: list[dict]) -> dict:
    """{(suite, name): the mean over seeds of every numeric field}."""
    rows: dict = {}
    for r in results:
        rows.setdefault((r["suite"], r["name"]), []).append(r)
    keys = ("worst_acc", "consensus_err", "faults_detected", "resyncs", "bits_per_round",
            "bits_per_round_expected", "bits_per_iteration", "bits_per_round_realized",
            "bits_realized_total", "seconds")
    return {k: {f: float(np.mean([r[f] for r in rs])) for f in keys}
            for k, rs in rows.items()}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--only", default="ft,ksweep,t5")
    ap.add_argument("--seeds", default="0,1")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--workers", type=int, default=0)
    args = ap.parse_args(argv)
    results = run_tasks(tasks(tuple(args.only.split(",")),
                              tuple(int(s) for s in args.seeds.split(","))),
                        args.device, args.workers)
    rows = summarize(results)
    for (suite, name), row in rows.items():
        print(json.dumps({"suite": suite, "name": name, **row}))
    return rows


if __name__ == "__main__":
    main()
