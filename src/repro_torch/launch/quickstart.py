"""Quickstart: distributionally robust decentralized learning at laptop scale
(the experiment of the reference's ``examples/quickstart.py``, as a
function of the port).

Ten nodes hold heterogeneous data (two of them see a rotated feature
space).  The same logistic model is trained twice over the same compressed
ring gossip -- with CHOCO-SGD (average risk) and with AD-GDA (the DRO
objective) -- and each network mean is scored on the majority and the
minority distribution.  AD-GDA's worst accuracy should not fall below
CHOCO-SGD's.

  PYTHONPATH=src python -m repro_torch.launch.quickstart                 # card, kq4b fused
  PYTHONPATH=src python -m repro_torch.launch.quickstart --device cpu --compressor q4b
  PYTHONPATH=src python -m repro_torch.launch.quickstart --device cpu --compressor top10

A kernel compressor (``kq*b``) gossips on the fused round, any other
(``q4b``, the reference quickstart's own setting, or ``top10`` / ``btop10``,
Table 2's sparsifiers) on the packed path.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.core import ADGDAConfig, adgda_trainer, choco_sgd
from repro_torch.data import rotated_minority_classification
from repro_torch.device import resolve_device


def loss_fn(params, batch, rng):
    x, y = batch
    logits = x @ params["w"] + params["b"]
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, y.long()[:, None])[:, 0]
    return (logz - gold).mean()


def run(steps: int = 600, *, compressor: str = "kq4b", device="cuda") -> dict:
    """Train AD-GDA and CHOCO-SGD; returns {algorithm: {"majority",
    "minority", "worst", "megabytes"}} (megabytes sent per node)."""
    dev = resolve_device(device)
    data = rotated_minority_classification(num_nodes=10, minority_nodes=2, seed=1)
    config = ADGDAConfig(
        num_nodes=10, topology="ring", compressor=compressor,
        fused_gossip=compressor.startswith("kq"),
        alpha=0.05, eta_theta=0.3, eta_lambda=0.2, lr_decay=0.99,
    )

    def train(trainer):
        params = {"w": torch.zeros(data.dim, data.num_classes, device=dev),
                  "b": torch.zeros(data.num_classes, device=dev)}
        state = trainer.init(params, seed=0)
        gen = data.batches(50, seed=0)
        for _ in range(steps):
            xb, yb = next(gen)
            batch = (torch.from_numpy(xb).to(dev), torch.from_numpy(yb).to(dev))
            state, _ = trainer.step(state, batch)
        return trainer.network_mean(state), trainer.bits_per_round(state) * steps

    out = {}
    for name, factory in (("AD-GDA", adgda_trainer), ("CHOCO-SGD", choco_sgd)):
        params, bits = train(factory(config, loss_fn, device=dev))
        acc = {}
        for vname, x, y in zip(data.val_names, data.val_x, data.val_y):
            pred = torch.argmax(torch.from_numpy(x).to(dev) @ params["w"] + params["b"], -1)
            acc[vname] = float((pred.cpu().numpy() == y).mean())
        out[name] = {**acc, "worst": min(acc.values()), "megabytes": bits / 8e6}
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--steps", type=int, default=600, help="training rounds per trainer")
    ap.add_argument("--compressor", default="kq4b")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    res = run(args.steps, compressor=args.compressor, device=args.device)
    print(f"transmitted per node: {res['AD-GDA']['megabytes']:.1f} MB ({args.compressor} ring gossip)")
    print(f"{'':12s} {'majority':>9s} {'minority':>9s} {'worst':>9s}")
    for name, acc in res.items():
        print(f"{name:12s} {acc['majority']:9.3f} {acc['minority']:9.3f} {acc['worst']:9.3f}")
    return res


if __name__ == "__main__":
    main()
