"""Serving entry point (port of ``repro.launch.serve``): batched autoregressive
decode on the consensus model, or a serving fleet.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
      --batch 4 --prompt-len 256 --gen 16            # on the card
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
      --reduced --device cpu                         # plain CPU path

``--arch`` takes every config of the registry (``--help`` lists them;
llama4-scout-17b-a16e, 213 GB in bf16, fits no one card at full depth).
Batch mode rounds ``--prompt-len`` to whole
chunks for mamba2-1.3b and gives whisper-small ``frames`` [B, 1500, 768]
and internvl2-2b ``patches`` [B, 256, 2048]: stubs of the modality
frontends, N(0, 0.02²) from the run's seeded generator, as the reference
CLI draws them.

``--fleet N`` serves as a fleet of N nodes (token prompts only, as the
reference's fleet: whisper-small, which needs ``frames``, and mamba2-1.3b,
whose prompts must be whole chunks, fail there as they do in the
reference): continuous-batching engines behind bounded-queue admission
control, fed by the seeded Poisson/Zipf load generator, reporting p50/p95/p99 TTFT in ticks and ms, tokens/s, queue
depth and slot occupancy.  With ``--follow`` the fleet polls ``--restore``
(a step-tagged prefix of checkpoints of the port's serving parameters,
written by ``repro_torch.checkpoint.save``) and hot-reloads each new
complete step while serving:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
      --reduced --device cpu --fleet 2 --rate 0.4 --requests 60 --prompts zipf \
      --metrics-out serve_metrics.json

Otherwise ``--restore`` loads a model parameter checkpoint written by the
JAX package (the same path spellings as the reference CLI).  Programmatic
callers can pass ``config_overrides`` to :func:`main` (for example
``{"attn_kernel": "flash"}``), as the reference's tests set such knobs on
the config; :func:`main` returns the metrics.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import torch

from repro_torch.checkpoint import latest_step, restore_jax_params, step_path
from repro_torch import configs
from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.launch import steps as st
from repro_torch.models import transformer as T


def _resolve_restore(path: str) -> str:
    """An exact file, the path without ``.npz``, or a step-tagged prefix."""
    if os.path.exists(path):
        return path
    if os.path.exists(path + ".npz"):
        return path + ".npz"
    found = latest_step(path)
    if found is None:
        raise SystemExit(
            f"--restore: no checkpoint at {path!r} (tried the exact path, "
            "with a .npz suffix, and as a step-tagged prefix)"
        )
    return step_path(path, found)


def stub_inputs(cfg, batch: int, gen: torch.Generator, dev) -> dict:
    """The modality frontends' stub outputs: whisper's ``frames`` [B,
    encoder_context, d], internvl2's ``patches`` [B, num_patches, d], each
    N(0, 0.02²) drawn from ``gen`` (frames first)."""
    out = {}
    if cfg.is_encdec:
        out["frames"] = torch.randn(batch, cfg.encoder_context, cfg.d_model, generator=gen,
                                    device=dev) * 0.02
    if cfg.num_patches > 0:
        out["patches"] = torch.randn(batch, cfg.num_patches, cfg.d_model, generator=gen,
                                     device=dev) * 0.02
    return out


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", required=True,
                    help=f"model config: {', '.join(configs.list_archs())}")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--cache-len", type=int, default=None)
    ap.add_argument("--restore", default=None,
                    help="model checkpoint written by the JAX package: an exact .npz file, "
                         "the path without .npz, or a step-tagged prefix")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--metrics-out", default=None,
                    help="write final serving metrics to this JSON file")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="run on the CUDA card (default) or the plain CPU path")
    fleet = ap.add_argument_group("fleet mode (decentralized serving)")
    fleet.add_argument("--fleet", type=int, default=0, metavar="N",
                       help="serve as a fleet of N nodes (continuous batching + admission "
                            "control + seeded load generator) instead of one fixed batch")
    fleet.add_argument("--rate", type=float, default=0.2,
                       help="offered load per node, requests/engine-tick")
    fleet.add_argument("--requests", type=int, default=64,
                       help="total requests to offer across the fleet")
    fleet.add_argument("--slots", type=int, default=2, help="continuous-batching slots per node")
    fleet.add_argument("--max-queue", type=int, default=12,
                       help="bounded pending-queue length per node")
    fleet.add_argument("--admission", choices=("reject", "shed_oldest"), default="reject",
                       help="overload policy")
    fleet.add_argument("--follow", action="store_true",
                       help="poll --restore (a step-tagged prefix) while serving and "
                            "hot-reload each new complete checkpoint (train-and-serve)")
    fleet.add_argument("--reload-every", type=int, default=16,
                       help="poll cadence in engine ticks for --follow")
    fleet.add_argument("--prompts", choices=("iid", "zipf", "unique"), default="iid",
                       help="prompt repetition: iid, zipf (a hot pool of --prompt-pool "
                            "prompts, the prefix-cache workload), unique (all distinct)")
    fleet.add_argument("--prompt-pool", type=int, default=64,
                       help="pool size for --prompts zipf")
    fleet.add_argument("--prefix-cache", type=int, default=64,
                       help="prefix KV cache entries per engine (0 disables)")
    fleet.add_argument("--no-fastpath", action="store_true",
                       help="serve with the pre-cache engine (no prefix cache, batch-1 "
                            "prefill, whole-pool decode): tick metrics are equal, only "
                            "wall time differs")
    return ap


def _run_fleet(args, cfg, params, dev) -> dict:
    """The serving fleet: N nodes, admission control, seeded Poisson/Zipf
    traffic, optional --follow hot reload from --restore.  Returns the
    metrics payload (also written to --metrics-out)."""
    from repro_torch.serving import (
        AdmissionControl,
        FleetNode,
        HotReloader,
        LoadGenConfig,
        LoadGenerator,
        ServeEngine,
        ServingFleet,
    )

    bucket = 8
    prompt_max = max(args.prompt_len, 4)
    padded = -(-prompt_max // bucket) * bucket
    cache_len = args.cache_len or (padded + args.gen)
    gen = LoadGenerator(LoadGenConfig(
        num_nodes=args.fleet, rate=args.rate, vocab_size=cfg.vocab_size,
        prompt_min=4, prompt_max=prompt_max, output_min=1, output_max=args.gen,
        seed=args.seed,
        prompt_mode={"iid": "iid", "zipf": "pool", "unique": "unique"}[args.prompts],
        prompt_pool=args.prompt_pool,
    ))
    # the nodes share one params object (no per-node copy of the weights),
    # and their reloaders restore each step once for all of them
    reloaders = (HotReloader.for_nodes(args.restore, params, args.fleet) if args.follow
                 else [None] * args.fleet)
    nodes = [
        FleetNode(
            i,
            ServeEngine(cfg, params, max_slots=args.slots, cache_len=cache_len,
                        prompt_bucket=bucket, fastpath=not args.no_fastpath,
                        prefix_cache=args.prefix_cache, device=dev),
            admission=AdmissionControl(max_queue=args.max_queue, policy=args.admission),
            reloader=reloader,
        )
        for i, reloader in enumerate(reloaders)
    ]
    if args.follow:
        for node in nodes:  # start from the newest complete checkpoint on disk
            node.maybe_reload()
    fleet = ServingFleet(nodes, gen, reload_every=args.reload_every if args.follow else 0)
    rep = fleet.run(max_requests=args.requests, max_ticks=1_000_000)

    f = rep.fleet
    reloads = sum(n.reloader.reloads for n in nodes if n.reloader)
    print(f"fleet={args.fleet}x{args.slots} rate={args.rate}/node device={dev} "
          f"offered={rep.offered} completed={f['completed']} "
          f"rejected={f['rejected']} shed={f['shed']} ticks={rep.ticks}")
    print(f"ttft ticks p50/p95/p99 = {f['p50_ttft_ticks']:.0f}/"
          f"{f['p95_ttft_ticks']:.0f}/{f['p99_ttft_ticks']:.0f}  "
          f"ttft ms p50/p99 = {f['p50_ttft_ms']:.1f}/{f['p99_ttft_ms']:.1f}  "
          f"{f['tok_per_s']:.1f} tok/s  {f['per_token_ms']:.1f} ms/token")
    print(f"queue depth mean/max = {f['mean_queue_depth']:.2f}/"
          f"{f['max_queue_depth']:.0f}  slot occupancy = {f['slot_occupancy']:.2f}"
          + (f"  reloads = {reloads}" if args.follow else ""))
    print(f"cache_hit_rate = {f['cache_hit_rate']:.3f}  "
          f"prefill_skipped = {f['prefill_skipped']:.0f}")
    payload = {
        "arch": cfg.name,
        "device": str(dev),
        "fleet": args.fleet,
        "slots": args.slots,
        "rate": args.rate,
        "offered": rep.offered,
        "ticks": rep.ticks,
        "wall_seconds": rep.wall_seconds,
        "metrics": f,
        "nodes": rep.node_summaries,
        # model forwards over the fleet (each launches one attention kernel per layer)
        "prefill_forwards": sum(n.engine.prefill_forwards for n in nodes),
        "decode_forwards": sum(n.engine.decode_forwards for n in nodes),
    }
    if args.follow:
        payload["reloads"] = reloads
        payload["reload_steps"] = [n.reloader.step for n in nodes]
    if args.metrics_out:
        with open(args.metrics_out, "w") as fh:
            json.dump(payload, fh, indent=2, default=float)
        print(f"metrics -> {args.metrics_out}")
    # what was served, for callers that check it (not written to --metrics-out)
    payload["served"] = [{"node": n.node_id, "prompt": list(r.prompt), "output": list(r.output)}
                         for n in nodes for r in n.requests if r.status == "done"]
    return payload


def main(argv=None, *, config_overrides: dict | None = None) -> dict:
    ap = _parser()
    args = ap.parse_args(argv)
    if args.follow and not (args.fleet and args.restore):
        ap.error("--follow needs --fleet N and --restore <step-tagged prefix>")
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if config_overrides:
        cfg = dataclasses.replace(cfg, **config_overrides)
    S = args.prompt_len
    if cfg.ssm_state:  # whole SSD chunks
        S = max(S, cfg.ssm_chunk)
        S -= S % cfg.ssm_chunk
    cache_len = args.cache_len or (S + args.gen)

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    if args.restore and not args.follow:
        fname = _resolve_restore(args.restore)
        params = restore_jax_params(fname, cfg, device=dev)
        print(f"restored params from {fname}")
    else:
        params = T.init_model(cfg, generator=gen, device=dev)
    if args.fleet:
        return _run_fleet(args, cfg, params, dev)
    tokens = torch.randint(0, cfg.vocab_size, (args.batch, S), generator=gen, device=dev)
    batch = {"tokens": tokens, **stub_inputs(cfg, args.batch, gen, dev)}

    prefill = st.make_prefill_step(cfg, cache_len=cache_len)
    decode = st.make_decode_step(cfg)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    sync()
    t0 = time.perf_counter()
    logits, cache = prefill(params, batch)
    sync()
    t_prefill = time.perf_counter() - t0

    tok = torch.argmax(logits[:, -1:, :], dim=-1)
    out = [tok]
    t0 = time.perf_counter()
    for i in range(args.gen - 1):
        logits, cache = decode(params, cache, tok, S + i)
        if args.temperature > 0:
            probs = torch.softmax(logits[:, -1, :].float() / args.temperature, dim=-1)
            tok = torch.multinomial(probs, 1, generator=gen)
        else:
            tok = torch.argmax(logits[:, -1:, :], dim=-1)
        out.append(tok)
    sync()
    t_decode = time.perf_counter() - t0

    generated = torch.cat(out, dim=1).cpu()
    per_token_ms = t_decode / max(args.gen - 1, 1) * 1e3
    print(f"arch={cfg.name} device={dev} prefill({args.batch}x{S})={t_prefill:.2f}s "
          f"decode {args.gen - 1} steps={t_decode:.2f}s ({per_token_ms:.1f} ms/token)")
    print("generated token ids (first row):", generated[0][:24].tolist())
    if not torch.isfinite(logits.float()).all():
        raise AssertionError("NaN in decode logits")
    metrics = {
        "arch": cfg.name,
        "device": str(dev),
        "batch": args.batch,
        "prompt_len": S,
        "gen": args.gen,
        "prefill_seconds": t_prefill,
        "decode_seconds": t_decode,
        "per_token_ms": per_token_ms,
        "tokens": generated.tolist(),
    }
    if args.metrics_out:
        with open(args.metrics_out, "w") as fh:
            json.dump({k: v for k, v in metrics.items() if k != "tokens"}, fh, indent=2)
        print(f"metrics -> {args.metrics_out}")
    return metrics


if __name__ == "__main__":
    main()
