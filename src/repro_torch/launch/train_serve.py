"""Train and serve: the DRO guarantee as a per-node serving-quality number
(the ``train_serve`` rows of the reference's suite S,
``benchmarks/bench_serving.py``, on the port).

A decentralized training run -- AD-GDA, then its unweighted twin
(CHOCO-SGD: ``robust=False``, same seed, topology and compression) --
checkpoints the consensus model after every phase through the atomic
``repro_torch.checkpoint.save``.  A fleet of one :class:`ClassifierEngine`
per node hot-reloads each checkpoint (``HotReloader``: a torn file is never
served) while serving Poisson traffic drawn from each node's LOCAL data;
one :class:`BatchedProbe` forward per checkpoint step scores the majority
and minority populations.

  PYTHONPATH=src python -m repro_torch.launch.train_serve              # card, kq4b fused
  PYTHONPATH=src python -m repro_torch.launch.train_serve --device cpu --phases 2 --rounds 20

Each row: ``worst_node_acc`` / ``worst_node_loss`` (the worst node
population's probe after the final reload), ``served_worst_acc`` (the worst
per-node accuracy on requests served in the final window),
``first_worst_acc`` (the probe after the first reload), reloads and
``probe_forwards``.  AD-GDA's ``worst_node_acc`` should beat the unweighted
run's.  A kernel compressor (``kq*b``) gossips on the fused round.
"""
from __future__ import annotations

import argparse
import tempfile

import numpy as np
import torch

from repro_torch.checkpoint import save
from repro_torch.core import ADGDAConfig, adgda_trainer, choco_sgd
from repro_torch.data import rotated_minority_classification
from repro_torch.device import resolve_device
from repro_torch.serving import (
    AdmissionControl,
    BatchedProbe,
    ClassifierEngine,
    EvalRequest,
    FleetNode,
    HotReloader,
    LoadGenConfig,
    LoadGenerator,
    ServingFleet,
)

__all__ = ["logistic_apply", "loss_fn", "run"]


def logistic_apply(params, x):
    return x @ params["w"] + params["b"]


def loss_fn(params, batch, rng):
    x, y = batch
    logits = logistic_apply(params, x)
    gold = torch.gather(logits, -1, y.long()[:, None])[:, 0]
    return (torch.logsumexp(logits, dim=-1) - gold).mean()


class _NodePayload:
    """Each node's requests are single examples of its own training data."""

    def __init__(self, data):
        self.data = data

    def __call__(self, node, rng, plen, max_new):
        x, y = self.data.x[node], self.data.y[node]
        idx = int(rng.integers(0, x.shape[0]))
        return EvalRequest(features=x[idx:idx + 1], labels=y[idx:idx + 1])


RATE, SLOTS = 0.8, 4  # per-node offered requests per tick; slots per engine


def run(*, phases: int = 4, rounds: int = 100, compressor: str = "kq4b", num_nodes: int = 10,
        minority_nodes: int = 2, device="cuda", log=print) -> list[dict]:
    """Train AD-GDA and its unweighted twin for ``phases`` x ``rounds``
    rounds each, serving between phases; returns one row per algorithm."""
    dev = resolve_device(device)
    m = num_nodes
    serve_chunk = 30 * m  # requests per serving window, fleet-wide
    rows = []
    for algo, robust in (("adgda", True), ("unweighted", False)):
        data = rotated_minority_classification(num_nodes=m, minority_nodes=minority_nodes,
                                               seed=0)
        config = ADGDAConfig(
            num_nodes=m, topology="ring", compressor=compressor,
            fused_gossip=compressor.startswith("kq"), alpha=0.05, eta_theta=0.3,
            eta_lambda=0.2, lr_decay=0.99, regularizer="chi2", robust=robust,
        )
        trainer = (adgda_trainer if robust else choco_sgd)(config, loss_fn, device=dev)
        params0 = {"w": torch.zeros(data.dim, data.num_classes, device=dev),
                   "b": torch.zeros(data.num_classes, device=dev)}
        state = trainer.init(params0, seed=0)
        batches = data.batches(50, seed=0)
        idx = {n: i for i, n in enumerate(data.val_names)}
        probe = BatchedProbe(
            logistic_apply,
            {n: (data.val_x[idx[n]], data.val_y[idx[n]]) for n in ("majority", "minority")},
            loss_fn=loss_fn,
        )
        with tempfile.TemporaryDirectory() as tmp:
            prefix = f"{tmp}/consensus_{algo}"
            gen = LoadGenerator(LoadGenConfig(num_nodes=m, rate=RATE, vocab_size=16, seed=1),
                                payload=_NodePayload(data))
            reloaders = HotReloader.for_nodes(prefix, params0, m, log=lambda s: None)
            nodes = [
                FleetNode(
                    i,
                    ClassifierEngine(logistic_apply, params0, max_slots=SLOTS),
                    admission=AdmissionControl(max_queue=24),
                    reloader=reloaders[i],
                    # the rotated nodes' latent population is the minority
                    quality_fn=probe.quality_fn("minority" if i < minority_nodes
                                                else "majority"),
                )
                for i in range(m)
            ]
            fleet = ServingFleet(nodes, gen, reload_every=1)
            # interleave: train a phase, checkpoint the consensus, serve a
            # window of traffic against the fresh weights
            first_probe, marks = None, []
            for phase in range(phases):
                for _ in range(rounds):
                    xb, yb = next(batches)
                    state, _ = trainer.step(state, (torch.from_numpy(xb).to(dev),
                                                    torch.from_numpy(yb).to(dev)))
                save(prefix, trainer.network_mean(state), step=(phase + 1) * rounds)
                marks = [len(n.requests) for n in nodes]
                fleet.run(max_requests=fleet.offered + serve_chunk, max_ticks=500_000)
                if first_probe is None:
                    first_probe = [n.quality_timeline[-1][1] for n in nodes]
                log(f"train_serve {algo}: phase {phase + 1}/{phases}, "
                    f"{(phase + 1) * rounds} rounds, worst probe accuracy "
                    f"{min(n.quality_timeline[-1][1]['acc'] for n in nodes):.4f}")
        final_probe = [n.quality_timeline[-1][1] for n in nodes]
        served_acc = []
        for node, mark in zip(nodes, marks):
            ok = [int(r.output[0]) == int(r.labels[0])
                  for r in node.requests[mark:] if r.status == "done"]
            served_acc.append(float(np.mean(ok)) if ok else 0.0)
        rows.append({
            "table": "S",
            "kind": "train_serve",
            "fleet": f"m{m}s{SLOTS}",
            "algo": algo,
            "compressor": compressor,
            "rate": RATE,
            "requests": fleet.offered,
            "steps": phases * rounds,
            "reloads": sum(n.reloader.reloads for n in nodes),
            "reload_skipped": sum(n.reloader.skipped for n in nodes),
            "first_worst_acc": min(q["acc"] for q in first_probe),
            "worst_node_acc": min(q["acc"] for q in final_probe),
            "mean_node_acc": float(np.mean([q["acc"] for q in final_probe])),
            "worst_node_loss": max(q["loss"] for q in final_probe),
            "served_worst_acc": min(served_acc),
            "probe_forwards": float(probe.probe_forwards),
        })
    return rows


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--phases", type=int, default=4, help="train / checkpoint / serve phases")
    ap.add_argument("--rounds", type=int, default=100, help="training rounds per phase")
    ap.add_argument("--compressor", default="kq4b")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rows = run(phases=args.phases, rounds=args.rounds, compressor=args.compressor,
               device=args.device)
    for r in rows:
        print(f"{r['algo']:10s} worst_node_acc {r['worst_node_acc']:.4f}  served_worst_acc "
              f"{r['served_worst_acc']:.4f}  mean_node_acc {r['mean_node_acc']:.4f}  "
              f"reloads {r['reloads']}  probe_forwards {r['probe_forwards']:.0f}")
    return rows


if __name__ == "__main__":
    main()
