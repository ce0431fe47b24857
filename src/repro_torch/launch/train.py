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

Time-varying and long runs, as the reference's:

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b --reduced \
      --steps 20 --topology-schedule roundrobin:ring,torus --dropout 0.2 \
      --checkpoint ckpt/run --checkpoint-every 5 --resume --device cpu

``--topology-schedule`` (``roundrobin:a,b`` | ``matching[:P]`` | a name) and
``--dropout`` run the masked CHOCO round (no fused form: with
``--fused-gossip`` they raise); ``--local-steps K`` takes K x the batch per
round; ``--consensus gt`` adds gradient tracking's second lane
(``--tracker-compressor``, ``--tracker-gamma``).  ``--checkpoint`` saves the
whole trainer state (theta, lambda, optimizer moments, the CHOCO or GT
trackers, the step and every generator's state) every
``--checkpoint-every`` rounds and at the end, and the network mean to
``<checkpoint>_model.npz``; ``--resume`` restores the newest loadable state
and fast-forwards the token stream, so the run continues as if it had not
stopped.  Not yet ported (they raise, see ROADMAP.md): ``--fault-spec`` and
``--gossip-backend ppermute``.

Programmatic callers get the run's metrics from :func:`main`, and may pass
``wrap_step(step, run, state)`` to run one round inside their own context (a
profiler, say): it must call ``run()`` and return its result, the round's
``(state, aux)`` (``state`` is the round's input state, which ``run``
updates in place); and
``compressor=`` a :class:`~repro_torch.core.compression.Compressor` object in
place of the ``--compressor`` spec (``KernelBlockTopK(0.25, 1024)``, say:
block top-k on its CUDA kernel, which no spec names).
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from repro_torch.checkpoint import all_steps, restore_state, save, save_state, step_path
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
    ap.add_argument("--topology-schedule", default=None,
                    help="time-varying wire: 'roundrobin:ring,torus', 'matching[:P]', "
                         "or a static topology name")
    ap.add_argument("--dropout", type=float, default=0.0,
                    help="per-round Bernoulli node-dropout probability")
    ap.add_argument("--topology-p", type=float, default=None,
                    help="edge probability for --topology erdos_renyi")
    ap.add_argument("--topology-seed", type=int, default=0,
                    help="graph-sampling seed (erdos_renyi, matching schedules)")
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
    ap.add_argument("--local-steps", type=int, default=1,
                    help="K local optimizer steps between gossip rounds (needs K x batch)")
    ap.add_argument("--consensus", choices=("choco", "gt"), default="choco",
                    help="'choco' = compressed gossip; 'gt' = gradient tracking: a second "
                         "compressed tracker lane in the same round (2x the bits)")
    ap.add_argument("--tracker-compressor", default=None,
                    help="compressor of the gt tracker lane only (default: --compressor)")
    ap.add_argument("--tracker-gamma", type=float, default=None,
                    help="consensus step size of the gt tracker lane")
    ap.add_argument("--fused-gossip", action="store_true",
                    help="single-pass fused CUDA gossip (requires a kq* compressor)")
    ap.add_argument("--gossip-backend", choices=("rolled", "ppermute"), default="rolled",
                    help="'ppermute' not yet ported")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--checkpoint", default=None, help="path prefix for npz checkpoints")
    ap.add_argument("--checkpoint-every", type=int, default=100,
                    help="save the full trainer state every N completed rounds")
    ap.add_argument("--resume", action="store_true",
                    help="restore the full trainer state from the newest loadable "
                         "--checkpoint file and continue")
    ap.add_argument("--metrics-out", default=None,
                    help="write final losses/consensus_err to this JSON file")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _resume(trainer, params, args):
    """(state, start step): the newest loadable checkpoint under
    ``--checkpoint``, walking past unreadable files; a fresh state if none."""
    state = trainer.init(params, seed=args.seed + 1)
    steps = all_steps(args.checkpoint)
    for step in reversed(steps):
        fname = step_path(args.checkpoint, step)
        try:
            t0 = time.perf_counter()
            state = restore_state(fname, state)
        except Exception as e:  # BadZipFile / KeyError / ValueError / OSError
            print(f"checkpoint {fname} is unreadable ({type(e).__name__}: {e}); "
                  f"falling back to the previous complete checkpoint", flush=True)
            continue
        print(f"resumed full trainer state from step {step} "
              f"({time.perf_counter() - t0:.2f} s)", flush=True)
        return state, step, time.perf_counter() - t0
    print(f"--resume: no loadable checkpoint under {args.checkpoint!r}; starting fresh",
          flush=True)
    if steps:  # a failed restore may have written into the state: free it, start anew
        del state
        state = trainer.init(params, seed=args.seed + 1)
    return state, 0, None


def main(argv=None, *, wrap_step=None, compressor=None) -> dict:
    args = _parser().parse_args(argv)
    comp_name = args.compressor if compressor is None else repr(compressor)
    if args.resume and not args.checkpoint:
        raise SystemExit("--resume requires --checkpoint")
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
    wire = args.topology_schedule or args.topology
    if args.dropout:
        wire += f"+drop{args.dropout:g}"
    if args.consensus == "gt":
        wire += f"+gt[{trainer.consensus.wire_format}]"
    print(f"arch={cfg.name} params={n_params:,} nodes={args.nodes} "
          f"compressor={comp_name} topology={wire}", flush=True)
    io = {"save_seconds": [], "save_bytes": [], "restore_seconds": None}
    start_step = 0
    if args.resume:
        state, start_step, io["restore_seconds"] = _resume(trainer, params, args)
    else:
        state = trainer.init(params, seed=args.seed + 1)
    del params

    def checkpoint(fn, *a, **kw):
        t0 = time.perf_counter()
        fname = fn(*a, **kw)
        io["save_seconds"].append(time.perf_counter() - t0)
        io["save_bytes"].append(os.path.getsize(fname))
        return fname

    # one round takes local_steps x the per-node batch (K local updates)
    round_batch = args.batch_per_node * args.local_steps
    stream = node_token_stream(args.nodes, round_batch, seq, cfg.vocab_size, seed=args.seed)
    for _ in range(start_step):  # deterministic stream: fast-forward to the resume point
        next(stream)
    history, seconds = [], []
    aux = None
    t0 = time.time()
    for step in range(start_step, args.steps):
        batch = {"tokens": torch.from_numpy(next(stream)).to(dev)}
        t_step = time.perf_counter()
        run = lambda state=state, batch=batch: trainer.step(state, batch)
        state, aux = run() if wrap_step is None else wrap_step(step, run, state)
        _sync(dev)
        seconds.append(time.perf_counter() - t_step)
        history.append({"losses": aux["losses"].tolist(),
                        "consensus_err": float(aux["consensus_err"]),
                        "lambda_max": float(aux["lambda_mean"].max()),
                        "bits_realized": aux["bits_realized"]})
        if "participation" in aux:
            history[-1]["participation"] = aux["participation"].tolist()
        if step % args.log_every == 0 or step == args.steps - 1:
            losses = np.asarray(history[-1]["losses"])
            alive = (f"alive={int(sum(history[-1]['participation']))}/{args.nodes}  "
                     if "participation" in history[-1] else "")
            print(
                f"step {step:5d}  worst={losses.max():.4f}  mean={losses.mean():.4f}  "
                f"consensus={history[-1]['consensus_err']:.3e}  {alive}"
                f"lambda_max={history[-1]['lambda_max']:.3f}  "
                f"bits/round={trainer.bits_per_round(state):.3e}  "
                f"({(time.time() - t0) / (step - start_step + 1):.2f}s/step)", flush=True
            )
        done = step + 1
        if args.checkpoint and done % args.checkpoint_every == 0 and done < args.steps:
            fname = checkpoint(save_state, args.checkpoint, state, step=done)
            print(f"checkpointed full trainer state to {fname}", flush=True)
    if dev.type == "cuda":
        print(f"peak device memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB",
              flush=True)

    if args.checkpoint:
        fname = checkpoint(save_state, args.checkpoint, state, step=args.steps)
        base = args.checkpoint[:-4] if args.checkpoint.endswith(".npz") else args.checkpoint
        model_file = checkpoint(save, base + "_model", trainer.network_mean(state))
        print(f"saved final state to {fname}, consensus model to {model_file}", flush=True)

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
    return {**metrics, "history": history, "step_seconds": seconds, "start_step": start_step,
            "bits_per_round": trainer.bits_per_round(state), "gamma": trainer.gamma,
            "checkpoint_io": io}


if __name__ == "__main__":
    main()
