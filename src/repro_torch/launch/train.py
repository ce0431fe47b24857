"""End-to-end AD-GDA training CLI (PyTorch port of
``repro.launch.train``): the paper's Algorithm 1 on the model zoo with the
synthetic heterogeneous LM stream, all nodes stacked on one card.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
      --nodes 4 --compressor kq4b [--fused-gossip]          # on the card
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
      --reduced --steps 3 --device cpu                      # plain CPU path

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
      --reduced --steps 3 --compressor top10 --device cpu   # top-k gossip

The flags and the log line are the reference's.  ``kq*b`` compressors run
the gossip through the quantize / dequantize CUDA kernels, and
``--fused-gossip`` through the fused CHOCO kernels; ``topK`` / ``btopK``
(global / blockwise top-K%) gossip values and indices on the packed path.
Not yet ported (they raise, see ROADMAP.md): ``--topology-schedule``, ``--dropout``,
``--fault-spec``, ``--consensus gt``, ``--gossip-backend ppermute``,
``--local-steps > 1`` and ``--checkpoint`` / ``--resume``.

Programmatic callers get the run's metrics from :func:`main`, and may pass
``wrap_step(step, run)`` to run one round inside their own context (a
profiler, say): it must call ``run()`` and return its result; and
``compressor=`` a :class:`~repro_torch.core.compression.Compressor` object in
place of the ``--compressor`` spec (``KernelBlockTopK(0.25, 1024)``, say:
block top-k on its CUDA kernel, which no spec names).
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.data import node_token_stream
from repro_torch.device import resolve_device
from repro_torch.launch import steps as st
from repro_torch.models import transformer as T
from repro_torch.tree import leaves


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true", help="2-layer smoke-scale variant (CPU)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--nodes", type=int, default=4)
    ap.add_argument("--batch-per-node", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--topology", default="ring")
    ap.add_argument("--topology-schedule", default=None, help="not yet ported")
    ap.add_argument("--dropout", type=float, default=0.0, help="not yet ported")
    ap.add_argument("--topology-p", type=float, default=None,
                    help="edge probability for --topology erdos_renyi")
    ap.add_argument("--topology-seed", type=int, default=0,
                    help="graph-sampling seed (erdos_renyi)")
    ap.add_argument("--fault-spec", default=None, help="not yet ported")
    ap.add_argument("--compressor", default="q4b",
                    help="none | qXb | kqXb (CUDA kernels, packed wire, fused round) | "
                         "topK | btopK (top-K%% values + indices)")
    ap.add_argument("--alpha", type=float, default=0.01)
    ap.add_argument("--eta-theta", type=float, default=0.05)
    ap.add_argument("--eta-lambda", type=float, default=0.01)
    ap.add_argument("--optimizer", choices=("sgd", "adam"), default="sgd")
    ap.add_argument("--schedule", choices=("const", "exp", "cosine"), default="exp")
    ap.add_argument("--lr-decay", type=float, default=1.0,
                    help="per-round decay factor for --schedule exp")
    ap.add_argument("--warmup", type=int, default=0, help="linear LR warmup rounds")
    ap.add_argument("--momentum", type=float, default=0.0, help="SGD momentum")
    ap.add_argument("--nesterov", action="store_true", help="Nesterov momentum (sgd)")
    ap.add_argument("--local-steps", type=int, default=1, help="> 1 not yet ported")
    ap.add_argument("--consensus", choices=("choco", "gt"), default="choco",
                    help="'gt' not yet ported")
    ap.add_argument("--tracker-compressor", default=None, help="gt only (not yet ported)")
    ap.add_argument("--tracker-gamma", type=float, default=None, help="gt only (not yet ported)")
    ap.add_argument("--fused-gossip", action="store_true",
                    help="single-pass fused CUDA gossip (requires a kq* compressor)")
    ap.add_argument("--gossip-backend", choices=("rolled", "ppermute"), default="rolled",
                    help="'ppermute' not yet ported")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--checkpoint", default=None, help="not yet ported")
    ap.add_argument("--checkpoint-every", type=int, default=100)
    ap.add_argument("--resume", action="store_true", help="not yet ported")
    ap.add_argument("--metrics-out", default=None,
                    help="write final losses/consensus_err to this JSON file")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None, *, wrap_step=None, compressor=None) -> dict:
    args = _parser().parse_args(argv)
    comp_name = args.compressor if compressor is None else repr(compressor)
    if args.checkpoint or args.resume:
        raise NotImplementedError(
            "--checkpoint / --resume (trainer-state checkpoints) are not yet ported to "
            "repro_torch; see ROADMAP.md")
    dev = resolve_device(args.device)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    seq = args.seq
    if cfg.ssm_state:
        seq = max(seq, cfg.ssm_chunk)
        seq -= seq % cfg.ssm_chunk

    trainer = st.make_trainer(
        cfg,
        args.nodes,
        topology=args.topology,
        topology_schedule=args.topology_schedule,
        dropout=args.dropout,
        topology_p=args.topology_p,
        topology_seed=args.topology_seed,
        fault_spec=args.fault_spec,
        compressor=args.compressor if compressor is None else compressor,
        alpha=args.alpha,
        eta_theta=args.eta_theta,
        eta_lambda=args.eta_lambda,
        optimizer=args.optimizer,
        schedule=args.schedule,
        lr_decay=args.lr_decay,
        warmup=args.warmup,
        total_steps=args.steps,
        momentum=args.momentum,
        nesterov=args.nesterov,
        local_steps=args.local_steps,
        consensus=args.consensus,
        tracker_gamma=args.tracker_gamma,
        tracker_compressor=args.tracker_compressor,
        fused_gossip=args.fused_gossip,
        gossip_backend=args.gossip_backend,
        track_average=False,
        device=dev,
    )

    params = T.init_train_params(cfg, seed=args.seed, device=dev)
    n_params = sum(p.numel() for p in leaves(params))
    print(f"arch={cfg.name} params={n_params:,} nodes={args.nodes} "
          f"compressor={comp_name} topology={args.topology}", flush=True)
    state = trainer.init(params, seed=args.seed + 1)
    del params

    stream = node_token_stream(args.nodes, args.batch_per_node, seq, cfg.vocab_size,
                               seed=args.seed)
    history, seconds = [], []
    aux = None
    t0 = time.time()
    for step in range(args.steps):
        batch = {"tokens": torch.from_numpy(next(stream)).to(dev)}
        t_step = time.perf_counter()
        run = lambda state=state, batch=batch: trainer.step(state, batch)
        state, aux = run() if wrap_step is None else wrap_step(step, run)
        _sync(dev)
        seconds.append(time.perf_counter() - t_step)
        history.append({"losses": aux["losses"].tolist(),
                        "consensus_err": float(aux["consensus_err"]),
                        "lambda_max": float(aux["lambda_mean"].max())})
        if step % args.log_every == 0 or step == args.steps - 1:
            losses = np.asarray(history[-1]["losses"])
            print(
                f"step {step:5d}  worst={losses.max():.4f}  mean={losses.mean():.4f}  "
                f"consensus={history[-1]['consensus_err']:.3e}  "
                f"lambda_max={history[-1]['lambda_max']:.3f}  "
                f"bits/round={trainer.bits_per_round(state):.3e}  "
                f"({(time.time() - t0) / (step + 1):.2f}s/step)", flush=True
            )
    if dev.type == "cuda":
        print(f"peak device memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB",
              flush=True)

    metrics = {}
    if aux is not None:
        metrics = {
            "final_step": args.steps,
            "losses": history[-1]["losses"],
            "worst_loss": float(max(history[-1]["losses"])),
            "consensus_err": history[-1]["consensus_err"],
        }
        if args.metrics_out:
            with open(args.metrics_out, "w") as f:
                json.dump(metrics, f, indent=2)
            print(f"wrote metrics to {args.metrics_out}")
    return {**metrics, "history": history, "step_seconds": seconds,
            "bits_per_round": trainer.bits_per_round(state), "gamma": trainer.gamma}


if __name__ == "__main__":
    main()
