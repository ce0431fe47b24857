"""Serving driver (port of ``repro.launch.serve``, batch mode): batched
autoregressive decode on the consensus model.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
      --batch 4 --prompt-len 256 --gen 16            # on the card
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
      --reduced --device cpu                         # plain CPU path

``--restore`` loads a model parameter checkpoint written by the JAX package
(the same path spellings as the reference CLI).  ``--fleet`` is not yet
ported (see ROADMAP.md).  Programmatic callers can pass
``config_overrides`` to :func:`main` (for example ``{"attn_kernel":
"flash"}``), as the reference's tests set such knobs on the config.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import torch

from repro_torch.checkpoint import latest_step, restore_jax_params, step_path
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


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", required=True)
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
    ap.add_argument("--fleet", type=int, default=0, metavar="N",
                    help="fleet mode: not yet ported (see ROADMAP.md)")
    return ap


def main(argv=None, *, config_overrides: dict | None = None) -> dict:
    args = _parser().parse_args(argv)
    if args.fleet:
        raise SystemExit("--fleet is not yet ported to repro_torch, see ROADMAP.md")
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if config_overrides:
        cfg = dataclasses.replace(cfg, **config_overrides)
    S = args.prompt_len
    cache_len = args.cache_len or (S + args.gen)

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    if args.restore:
        fname = _resolve_restore(args.restore)
        params = restore_jax_params(fname, cfg, device=dev)
        print(f"restored params from {fname}")
    else:
        params = T.init_model(cfg, generator=gen, device=dev)
    tokens = torch.randint(0, cfg.vocab_size, (args.batch, S), generator=gen, device=dev)

    prefill = st.make_prefill_step(cfg, cache_len=cache_len)
    decode = st.make_decode_step(cfg)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    sync()
    t0 = time.perf_counter()
    logits, cache = prefill(params, {"tokens": tokens})
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
