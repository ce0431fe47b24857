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
stopped.

Wire faults, as the reference's:

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b --nodes 3 \
      --topology ring --compressor kq4b --fault-spec drop:0.2,corrupt:0.1,stale:0 \
      [--fused-gossip]

``--fault-spec`` drops, garbles, duplicates or delays each message of the
cached union wire (mirrors of every in-neighbour's ``theta_hat``, digests,
staleness-bounded mixing, dense resyncs with backoff); each round logs its
detections, resyncs and realized bits.  With ``--fused-gossip`` the encode
runs on the fused kernel's digest variant.

The multi-process wire, one block of the nodes per ``torch.distributed``
rank, only compressed payloads between neighbours:

  python -m torch.distributed.run --standalone --nproc-per-node 2 \
      -m repro_torch.launch.train --arch qwen3-1.7b --nodes 4 --topology ring \
      --compressor kq4b --gossip-backend ppermute [--fused-gossip]

Rank r trains nodes ``[r * block, (r + 1) * block)`` on its rows of the
node-stacked batch stream; rank 0 prints the log and writes
``--metrics-out``; every rank prints its mesh line, its bytes on the wire
and its peak memory.  Without a launcher ``ppermute`` runs on a one-rank
mesh (the reference's degenerate mesh).

Checkpoints on the ranks are the one-process run's files:

  python -m torch.distributed.run --standalone --nproc-per-node 2 \
      -m repro_torch.launch.train --arch qwen3-1.7b --nodes 4 --steps 4 \
      --compressor kq4b --gossip-backend ppermute --checkpoint ckpt/run [--resume]

``--checkpoint`` writes one state file per save, from rank 0, which
gathers every rank's rows of each node-stacked leaf as it writes it
(``checkpoint.save_state(..., mesh=)``); every rank takes the network mean
and rank 0 writes ``<checkpoint>_model.npz``.  ``--resume`` reads each
rank's rows: every rank tries the newest file, and a file counts only if it
loaded on every rank, so all ranks resume at one step (or all start fresh)
and fast-forward the token stream alike.  A state file from either backend,
or the JAX package's ``TrainerState``, resumes on either.

The batch is the reference's (:func:`make_batch`): the tokens, and for the
encoder-decoder (whisper-small) all-zero ``frames``, for the VLM
(internvl2-2b) all-zero ``patches`` over the first ``num_patches``
positions, which must fit in ``--seq`` (internvl2-2b's 256 patches need
``--seq 512`` for 256 positions of text).  Zero inputs are the reference's
stub, and they do not train.  A norm over a constant row divides by
``sqrt(eps)``: the encoder's LayerNorm of every zero frame (whisper), and
the RMSNorm of the zero patch rows that the text positions attend to
(internvl2).  Each layer then multiplies the gradient by up to ``1/sqrt(eps)
= 1e3``.  At reduced width whisper's gradients pass 1e8 and the consensus
error is ~1e20 after one round; at full width the reference CLI's whisper
run is NaN after round 0.  internvl2's gradient is not finite at its 24
layers, at reduced width too (``tests/test_torch_zoo_train.py`` holds the
port and the reference to both).  The CLI copies the zeros, for parity.  A caller who wants a run that trains
replaces :func:`make_batch` with seeded N(0, 0.02²) stubs
(``launch/serve.py::stub_inputs``), as ``chip_smoke.py`` phase 19 does.

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

from repro_torch.checkpoint import (
    all_steps,
    gather_bytes_sent,
    restore_state,
    save,
    save_state,
    step_path,
)
from repro_torch.configs import get_config
from repro_torch.core import exchange
from repro_torch.data import node_token_stream
from repro_torch.device import resolve_device
from repro_torch.launch import steps as st
from repro_torch.launch.mesh import make_node_mesh
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
    ap.add_argument("--fault-spec", default=None,
                    help="wire faults, e.g. 'drop:0.05,corrupt:0.01,stale:2': per-edge "
                         "drop / corrupt / dup / delay with digest detection and "
                         "staleness-bounded resync")
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
                    help="'ppermute': each torch.distributed rank trains a block of the nodes "
                         "and only compressed payloads travel between neighbours")
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


def make_batch(tokens: torch.Tensor, cfg, round_batch: int, device) -> dict:
    """One round's batch, as the reference CLI builds it: ``tokens`` [m,
    round_batch, S] (this process's rows of the node axis) and, over the
    same rows, all-zero f32 ``frames`` [m, round_batch, encoder_context, d]
    for the encoder-decoder and ``patches`` [m, round_batch, num_patches, d]
    for the VLM."""
    batch = {"tokens": tokens.to(device)}
    lead = (tokens.shape[0], round_batch)
    if cfg.is_encdec:
        batch["frames"] = torch.zeros(lead + (cfg.encoder_context, cfg.d_model),
                                      dtype=torch.float32, device=device)
    if cfg.num_patches > 0:
        batch["patches"] = torch.zeros(lead + (cfg.num_patches, cfg.d_model),
                                       dtype=torch.float32, device=device)
    return batch


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _fault_totals(cons, mesh=None) -> dict | None:
    """Cumulative detections and resyncs over every lane's fault state, and
    the busiest node's delivered bits of the last round (None without a
    per-edge fault state); over every rank's nodes on a mesh."""
    lanes = [cons.model, cons.tracker] if hasattr(cons, "tracker") else [cons]
    states = [lane.fault for lane in lanes if hasattr(getattr(lane, "fault", None), "detected")]
    if not states:
        return None
    counts = torch.tensor([sum(int(f.detected.sum()) for f in states),
                           sum(int(f.resyncs.sum()) for f in states)], dtype=torch.int64)
    top = sum(f.bits for f in states).max().reshape(1).float().cpu()
    if mesh is not None and mesh.size > 1:
        import torch.distributed as dist

        dist.all_reduce(counts, group=mesh.group)
        dist.all_reduce(top, op=dist.ReduceOp.MAX, group=mesh.group)
    return {"detected": int(counts[0]), "resyncs": int(counts[1]), "bits_max": float(top[0])}


def _agree(ok: bool, mesh) -> bool:
    """Whether ``ok`` holds on every rank (an all-reduce MIN on a mesh)."""
    if mesh is None or mesh.size == 1:
        return ok
    import torch.distributed as dist

    flag = torch.tensor([int(ok)], dtype=torch.int32)
    dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=mesh.group)
    return bool(flag)


def _resume(trainer, params, args, mesh=None):
    """(state, start step, seconds): the newest checkpoint under
    ``--checkpoint`` that loads, walking past unreadable files; a fresh
    state if none.  On a mesh every rank walks rank 0's list of steps and
    takes a file only if it loaded on every rank, so all resume at one step
    (or all start fresh)."""
    lead = mesh is None or mesh.rank == 0
    state = trainer.init(params, seed=args.seed + 1)
    steps = all_steps(args.checkpoint)
    if mesh is not None and mesh.size > 1:
        import torch.distributed as dist

        box = [steps]
        dist.broadcast_object_list(box, src=0, group=mesh.group)
        steps = box[0]
    for step in reversed(steps):
        fname = step_path(args.checkpoint, step)
        t0 = time.perf_counter()
        err = None
        try:
            state = restore_state(fname, state, mesh=mesh, federated=trainer.federated)
        except Exception as e:  # BadZipFile / KeyError / ValueError / OSError
            err = e
        if not _agree(err is None, mesh):
            if lead:
                why = f"{type(err).__name__}: {err}" if err is not None else "on another rank"
                print(f"checkpoint {fname} is unreadable ({why}); falling back to the previous "
                      f"complete checkpoint", flush=True)
            continue
        seconds = time.perf_counter() - t0
        if lead:
            print(f"resumed full trainer state from step {step} ({seconds:.2f} s)", flush=True)
        return state, step, seconds
    if lead:
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
    mesh, own_group = None, False
    if args.gossip_backend == "ppermute":
        import torch.distributed as dist

        own_group = not dist.is_initialized()
        mesh = make_node_mesh(args.nodes, device=args.device)
        own_group &= dist.is_initialized()
        dev = mesh.device
    lead = mesh is None or mesh.rank == 0  # the process that logs

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
        mesh=mesh,
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
    if trainer.consensus.faults is not None:
        wire += f"+faults[{trainer.consensus.faults}]"
    if lead:
        print(f"arch={cfg.name} params={n_params:,} nodes={args.nodes} "
              f"compressor={comp_name} topology={wire}", flush=True)
    io = {"save_seconds": [], "save_bytes": [], "gather_bytes": [], "restore_seconds": None}
    start_step = 0
    if args.resume:
        state, start_step, io["restore_seconds"] = _resume(trainer, params, args, mesh)
    else:
        state = trainer.init(params, seed=args.seed + 1)
    del params

    def checkpoint(fn, *a, **kw):
        """Save on every rank (rank 0 writes); the seconds, the file's bytes
        and the bytes this rank sent to rank 0."""
        t0, sent0 = time.perf_counter(), gather_bytes_sent.count
        fname = fn(*a, mesh=mesh, **kw)
        io["save_seconds"].append(time.perf_counter() - t0)
        io["save_bytes"].append(os.path.getsize(fname))
        io["gather_bytes"].append(gather_bytes_sent.count - sent0)
        return fname

    # one round takes local_steps x the per-node batch (K local updates)
    round_batch = args.batch_per_node * args.local_steps
    stream = node_token_stream(args.nodes, round_batch, seq, cfg.vocab_size, seed=args.seed)
    for _ in range(start_step):  # deterministic stream: fast-forward to the resume point
        next(stream)
    history, seconds = [], []
    aux = None
    wire_bytes = []
    t0 = time.time()
    for step in range(start_step, args.steps):
        # this process's rows of the node-stacked batch
        batch = make_batch(torch.from_numpy(next(stream)[trainer.rows]), cfg, round_batch, dev)
        sent0 = exchange.wire_bytes_sent.count
        t_step = time.perf_counter()
        run = lambda state=state, batch=batch: trainer.step(state, batch)
        state, aux = run() if wrap_step is None else wrap_step(step, run, state)
        _sync(dev)
        seconds.append(time.perf_counter() - t_step)
        wire_bytes.append(exchange.wire_bytes_sent.count - sent0)
        history.append({"losses": aux["losses"].tolist(),
                        "consensus_err": float(aux["consensus_err"]),
                        "lambda_max": float(aux["lambda_mean"].max()),
                        "bits_realized": aux["bits_realized"]})
        if "participation" in aux:
            history[-1]["participation"] = aux["participation"].tolist()
        fault_totals = _fault_totals(state.consensus, mesh)
        if fault_totals is not None:
            history[-1]["faults"] = fault_totals
        if lead and (step % args.log_every == 0 or step == args.steps - 1):
            losses = np.asarray(history[-1]["losses"])
            alive = (f"alive={int(sum(history[-1]['participation']))}/{args.nodes}  "
                     if "participation" in history[-1] else "")
            if "faults" in history[-1]:
                f = history[-1]["faults"]
                alive += (f"detected={f['detected']} resyncs={f['resyncs']} "
                          f"bits_realized={history[-1]['bits_realized']:.6e}  ")
            print(
                f"step {step:5d}  worst={losses.max():.4f}  mean={losses.mean():.4f}  "
                f"consensus={history[-1]['consensus_err']:.3e}  {alive}"
                f"lambda_max={history[-1]['lambda_max']:.3f}  "
                f"bits/round={trainer.bits_per_round(state):.3e}  "
                f"({(time.time() - t0) / (step - start_step + 1):.2f}s/step)", flush=True
            )
        done = step + 1
        if args.checkpoint and done % args.checkpoint_every == 0 and done < args.steps:
            fname = checkpoint(save_state, args.checkpoint, state, step=done,
                               federated=trainer.federated)
            if lead:
                print(f"checkpointed full trainer state to {fname}", flush=True)
    if mesh is not None:
        print(f"rank {mesh.rank}: wire bytes sent per round {wire_bytes}", flush=True)
    if dev.type == "cuda":
        rank = "" if mesh is None else f"rank {mesh.rank}: "
        print(f"{rank}peak device memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB",
              flush=True)

    if args.checkpoint:
        fname = checkpoint(save_state, args.checkpoint, state, step=args.steps,
                           federated=trainer.federated)
        base = args.checkpoint[:-4] if args.checkpoint.endswith(".npz") else args.checkpoint
        # the network mean is a collective on a mesh: every rank takes it, rank 0 writes
        model_file = checkpoint(save, base + "_model", trainer.network_mean(state))
        if lead:
            print(f"saved final state to {fname}, consensus model to {model_file}", flush=True)

    metrics = {}
    if aux is not None:
        metrics = {
            "final_step": args.steps,
            "losses": history[-1]["losses"],
            "worst_loss": float(max(history[-1]["losses"])),
            "consensus_err": history[-1]["consensus_err"],
        }
        if args.metrics_out and lead:
            with open(args.metrics_out, "w") as f:
                json.dump(metrics, f, indent=2)
            print(f"wrote metrics to {args.metrics_out}")
    out = {**metrics, "history": history, "step_seconds": seconds, "start_step": start_step,
           "bits_per_round": trainer.bits_per_round(state), "gamma": trainer.gamma,
           "checkpoint_io": io, "wire_bytes": wire_bytes}
    if own_group:
        import torch.distributed as dist

        dist.destroy_process_group()
    return out


if __name__ == "__main__":
    main()
