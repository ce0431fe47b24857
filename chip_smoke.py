#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase; needs one CUDA card

Phases (any failure exits non-zero):
  1. card, versions, and an nvcc build of every kernel from ``csrc/``;
  2. each kernel against its plain PyTorch version at the serving slice's
     shapes: max error, tolerance, kernel / plain / library ms, and bound;
  3. full-width qwen3-1.7b (random seeded weights): prefill + 16 decode steps
     with ``attn_kernel="flash"`` against ``attn_kernel=None``;
  4. ``ServeEngine`` at full width, bf16 and int8 KV caches;
  5. one long-context request through the sliding-window prefill and the
     ring-buffer decode;
  6. the port's ``launch/serve.py`` batch mode;
  7. torch.profiler over eight decode ticks: device time by kernel.
Phases 4-6 are the main path: launch counters are zeroed just before each
and read just after, and every kernel the phase runs must have launched.
The line before the last is the kernels' JSON summary; the last line is the
run's JSON status.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import random
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, f32 CUDA cores, HBM3
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
# |out - plain| <= atol + rtol * |plain| per element.  Both sides reduce in
# f32 and round once to the output type, so they differ by at most one
# rounding step: for bf16 that is 2**-7 of the value (rtol 1e-2), and atol
# covers f32 summation-order noise on outputs near zero
TOL = {"bfloat16": dict(atol=1e-4, rtol=1e-2), "float32": dict(atol=2e-5, rtol=1e-4)}
L2_BYTES = 50 * 2**20


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_name_and_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, arg_sets, reps: int) -> float:
    """Mean device ms per call, cycling through ``arg_sets`` (copies whose
    total exceeds L2, so each call finds its inputs cold)."""
    import torch

    for a in arg_sets[:2]:
        fn(*a)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(reps):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def copies_past_l2(make, nbytes: int):
    n = max(2, min(8, math.ceil(2 * L2_BYTES / max(nbytes, 1))))
    return [make() for _ in range(n)]


def bound(ops: float, nbytes: float, dtype: str) -> tuple[float, str]:
    t_ops = ops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# --------------------------------------------------------------- phase 2
def check_kernels(dev) -> dict:
    """Each kernel against its plain version; returns per-kernel records."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import decode as kd
    from repro_torch.kernels import flash_attention as kf
    from repro_torch.kernels import sliding_window as ksw
    from repro_torch.kernels.ref import quantize_kv_ref

    gen = torch.Generator(device=dev).manual_seed(0)
    records: dict[str, dict] = {}
    failures = []

    def randn(*shape, dtype):
        return torch.randn(*shape, generator=gen, device=dev, dtype=torch.float32).to(dtype)

    def compare(label, out, ref, dtype):
        out, ref = out.float(), ref.float()
        err = (out - ref).abs()
        tol = TOL[dtype]
        ok = bool(torch.isfinite(out).all()) and bool(
            (err <= tol["atol"] + tol["rtol"] * ref.abs()).all())
        mx = float(err.max())
        log(f"  {label}: max_abs_err={mx:.3e} rel_l2={float((out - ref).norm() / ref.norm()):.3e} "
            f"mean|ref|={float(ref.abs().mean()):.3e} "
            f"tol(atol={tol['atol']}, rtol={tol['rtol']}) {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(label)
        return mx

    def pairs(S, window):
        return sum(min(i + 1, window or S) for i in range(S))

    # -- flash: causal (headline), ragged, unaligned window, f32
    flash_cases = [
        ("flash causal B4 S512 H16 hd128 bf16", 4, 512, 16, 128, None, "bfloat16", True),
        ("flash causal ragged B4 S200 H16 hd128 bf16", 4, 200, 16, 128, None, "bfloat16", False),
        ("flash window=100 B4 S512 H16 hd128 bf16", 4, 512, 16, 128, 100, "bfloat16", False),
        ("flash causal B2 S256 H4 hd64 f32", 2, 256, 4, 64, None, "float32", False),
    ]
    for label, B, S, H, hd, window, dt, headline in flash_cases:
        dtype = getattr(torch, dt)
        q, k, v = (randn(B, S, H, hd, dtype=dtype) for _ in range(3))
        out = kf.flash_attention(q, k, v, causal=True, window=window)
        torch.cuda.synchronize()
        ref = kf.flash_attention_plain(q, k, v, causal=True, window=window)
        err = compare(label, out, ref, dt)
        if headline:
            nbytes = 4 * B * S * H * hd * q.element_size()
            sets = copies_past_l2(lambda: tuple(randn(B, S, H, hd, dtype=dtype) for _ in range(3)),
                                  nbytes)
            ms = time_ms(lambda a, b_, c: kf.flash_attention(a, b_, c, causal=True), sets, 20)
            plain_ms = time_ms(lambda a, b_, c: kf.flash_attention_plain(a, b_, c, causal=True),
                               sets, 5)
            tsets = [tuple(t.transpose(1, 2).contiguous() for t in s) for s in sets]
            lib_ms = time_ms(lambda a, b_, c: F.scaled_dot_product_attention(a, b_, c, is_causal=True),
                             tsets, 20)
            b_ms, b_by = bound(4 * B * H * hd * pairs(S, None), nbytes, dt)
            records["flash_attention"] = dict(
                name="flash_attention", route="cuda", source="src/repro_torch/csrc/flash_attn.cu",
                replaces="src/repro/kernels/flash_attention.py:120", max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                shape=f"B={B} S={S} H={H} hd={hd} {dt} causal")
            del sets, tsets

    # -- sliding window at the long-context prefill shape
    B, S, H, hd, W = 1, 8448, 16, 128, 8192
    q, k, v = (randn(B, S, H, hd, dtype=torch.bfloat16) for _ in range(3))
    out = ksw.sliding_window_attention(q, k, v, window=W)
    torch.cuda.synchronize()
    ref = ksw.sliding_window_attention_plain(q, k, v, window=W)
    err = compare(f"sliding window B{B} S{S} H{H} hd{hd} window={W} bf16", out, ref, "bfloat16")
    del ref
    sets = [(q, k, v)]
    ms = time_ms(lambda a, b_, c: ksw.sliding_window_attention(a, b_, c, window=W), sets, 3)
    plain_ms = time_ms(lambda a, b_, c: ksw.sliding_window_attention_plain(a, b_, c, window=W),
                       sets, 2)
    qpos = torch.arange(S, device=dev)
    band = (qpos[:, None] >= qpos[None, :]) & (qpos[:, None] - qpos[None, :] < W)
    tsets = [tuple(t.transpose(1, 2).contiguous() for t in (q, k, v))]
    lib_ms = time_ms(lambda a, b_, c: F.scaled_dot_product_attention(a, b_, c, attn_mask=band),
                     tsets, 3)
    nbytes = 4 * B * S * H * hd * 2
    b_ms, b_by = bound(4 * B * H * hd * pairs(S, W), nbytes, "bfloat16")
    records["sliding_window_attention"] = dict(
        name="sliding_window_attention", route="cuda", source="src/repro_torch/csrc/flash_attn.cu",
        replaces="src/repro/kernels/sliding_window.py:139", max_abs_err=err, ms=ms,
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
        shape=f"B={B} S={S} H={H} hd={hd} window={W} bf16")
    del q, k, v, out, tsets, sets, band

    # -- decode: partial rows, a wrapped ring buffer; bf16, int8, f32
    B, L, KV, G, hd = 4, 1024, 8, 2, 128
    idx = torch.arange(L, device=dev)
    pos = torch.tensor([300, 1500, 0, 1023], device=dev)
    slot = torch.remainder(pos, L)
    age = torch.remainder(slot[:, None] - idx[None, :], L)
    valid = age < torch.clamp(pos + 1, max=L)[:, None]
    n_valid = int(valid.sum())  # rows the result depends on; the bound counts only these

    def decode_inputs(dtype, quant):
        q = randn(B, KV, G, hd, dtype=dtype)
        k = randn(B, L, KV, hd, dtype=dtype)
        v = randn(B, L, KV, hd, dtype=dtype)
        if not quant:
            return (q, k, v, valid, None, None)
        kq, ks = quantize_kv_ref(k)
        vq, vs = quantize_kv_ref(v)
        return (q, kq, vq, valid, ks, vs)

    def run_kernel(q, k, v, vl, ks, vs):
        return kd.decode_attention(q, k, v, vl, k_scale=ks, v_scale=vs)

    def run_plain(q, k, v, vl, ks, vs):
        return kd.decode_attention_plain(q, k, v, vl, k_scale=ks, v_scale=vs)

    for name, dt, quant in (("decode_attention", "bfloat16", False),
                            ("decode_attention_int8", "bfloat16", True),
                            (None, "float32", False)):
        dtype = getattr(torch, dt)
        args = decode_inputs(dtype, quant)
        out = run_kernel(*args)
        torch.cuda.synchronize()
        label = f"decode{' int8' if quant else ''} B{B} L{L} KV{KV} G{G} hd{hd} {dt}"
        err = compare(label, out, run_plain(*args), dt)
        if name is None:
            continue
        el = 1 if quant else dtype.itemsize
        nbytes = (2 * n_valid * KV * hd * el + 2 * B * KV * G * hd * dtype.itemsize + B * L
                  + (2 * n_valid * KV * 4 if quant else 0))
        sets = copies_past_l2(lambda: decode_inputs(dtype, quant), nbytes)
        ms = time_ms(run_kernel, sets, 50)
        plain_ms = time_ms(run_plain, sets, 20)
        lib_ms = None
        if not quant:
            tsets = [(a[0].reshape(B, KV * G, 1, hd), a[1].transpose(1, 2).contiguous(),
                      a[2].transpose(1, 2).contiguous(), a[3][:, None, None, :]) for a in sets]
            lib_ms = time_ms(lambda q_, k_, v_, m_: F.scaled_dot_product_attention(
                q_, k_, v_, attn_mask=m_, enable_gqa=True), tsets, 50)
            del tsets
        b_ms, b_by = bound(4 * n_valid * KV * G * hd, nbytes, dt)
        records[name] = dict(
            name=name, route="cuda", source="src/repro_torch/csrc/decode_attn.cu",
            replaces="src/repro/kernels/decode.py:125", max_abs_err=err, ms=ms,
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
            shape=f"B={B} L={L} KV={KV} G={G} hd={hd} {'int8 KV' if quant else dt}, "
                  f"{n_valid} valid rows")
        del sets
    torch.cuda.synchronize()
    for r in records.values():
        log(f"  time {r['name']} [{r['shape']}]: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library "
            f"{'n/a' if r['library_ms'] is None else format(r['library_ms'], '.4f') + ' ms'}, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    if failures:
        raise AssertionError(f"kernels disagree with their plain versions: {failures}")
    return records


# ------------------------------------------------------------ phases 3-6
QWEN = "qwen3-1.7b"
# phase 3 bounds (bf16 at full width, random weights, 28 layers): the
# kernels accumulate in f32 where the plain path rounds scores and
# probabilities to bf16, so logits differ by bf16 noise, not by algorithm
LOGIT_REL_BOUND = 0.05
GREEDY_AGREE_BOUND = 0.75


def model_vs_plain(dev) -> None:
    """Full-width qwen3-1.7b: prefill + 16 decode steps with the kernels
    against the plain attention path, teacher-forced on the kernel path's
    greedy tokens."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    cfg = get_config(QWEN)
    params = T.init_model(cfg, seed=0, device=dev)
    log(f"[3] {QWEN}: {T.param_count(cfg) / 1e9:.3f} B parameters in {cfg.dtype}, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    gen = torch.Generator(device=dev).manual_seed(1)
    B, S, steps, cache_len = 4, 200, 16, 256
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device=dev)
    runs = {}
    for knob in ("flash", None):
        c = dataclasses.replace(cfg, attn_kernel=knob)
        logits, cache = T.prefill(params, {"tokens": tokens}, c, cache_len)
        outs = [logits[:, -1].float()]
        feed = runs["flash"]["greedy"] if knob is None else None
        greedy = [torch.argmax(outs[-1], -1)]
        for i in range(steps):
            tok = (feed[i] if feed is not None else greedy[-1])[:, None]
            logits, cache = T.decode_step(params, tok, cache, S + i, c)
            outs.append(logits[:, 0].float())
            greedy.append(torch.argmax(outs[-1], -1))
        torch.cuda.synchronize()
        runs[knob] = {"logits": torch.stack(outs), "greedy": greedy}
        del cache
    a, b = runs["flash"]["logits"], runs[None]["logits"]
    if not bool(torch.isfinite(a).all()):
        raise AssertionError("non-finite logits on the kernel path")
    rel = float((a - b).norm() / b.norm())
    agree = float((a.argmax(-1) == b.argmax(-1)).float().mean())
    log(f"[3] prefill {B}x{S} + {steps} decode steps: logits rel L2 error kernel vs plain "
        f"{rel:.3e} (bound {LOGIT_REL_BOUND}), greedy agreement {agree:.3f} "
        f"(bound >= {GREEDY_AGREE_BOUND})")
    if rel > LOGIT_REL_BOUND or agree < GREEDY_AGREE_BOUND:
        raise AssertionError("kernel path disagrees with the plain path at full width")
    del params, runs, a, b
    torch.cuda.empty_cache()


def run_engine(label, cfg, params, dev, prompts, new_tokens, **engine_kw):
    """Serve ``prompts`` through ServeEngine; returns (requests, seconds, ticks)."""
    import torch

    from repro_torch.serving import Request, ServeEngine

    engine = ServeEngine(cfg, params, device=dev, **engine_kw)
    reqs = [Request(prompt=p, max_new_tokens=new_tokens) for p in prompts]
    for r in reqs:
        engine.submit(r)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ticks = 0
    while engine.pending or engine.active:
        engine.step()
        ticks += 1
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    done = sum(r.done for r in reqs)
    toks = sum(len(r.output) for r in reqs)
    bad = [t for r in reqs for t in r.output if not 0 <= t < cfg.vocab_size]
    log(f"  {label}: {done}/{len(reqs)} requests done, {toks} tokens in {ticks} ticks, "
        f"{secs:.3f} s: {toks / secs:.1f} tokens/s, {secs / ticks * 1e3:.2f} ms/tick, "
        f"{secs / toks * 1e3:.2f} ms/token; stats {engine.stats()}")
    if done != len(reqs) or any(len(r.output) != new_tokens for r in reqs) or bad:
        raise AssertionError(f"{label}: not every request completed with valid tokens")
    return reqs, secs, ticks


def main_path(dev) -> dict[str, int]:
    """Phases 4-6: the port's serving entry points at full width.  Returns
    the kernels' launch counts summed over the three phases."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T

    total = {name: 0 for name in _build.COUNTERS}

    def counted(phase, expect, fn):
        _build.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        counts = _build.launch_counts()
        log(f"[{phase}] launches: {counts}")
        missing = [k for k in expect if counts[k] == 0]
        if missing:
            raise AssertionError(f"phase {phase}: kernels never launched: {missing}")
        for k, v in counts.items():
            total[k] += v
        return out

    cfg = dataclasses.replace(get_config(QWEN), attn_kernel="flash")
    params = T.init_model(cfg, seed=0, device=dev)
    rng = random.Random(0)
    lens = [17, 600, 130, 333, 17, 480, 64, 251]
    pool = {}
    prompts = [pool.setdefault(n, [rng.randrange(cfg.vocab_size) for _ in range(n)])
               for n in lens]  # the repeated 17-token prompt hits the prefix cache
    engine_kw = dict(max_slots=4, cache_len=1024, prompt_bucket=32)

    log("[4] ServeEngine at full width: 8 requests, prompts 17-600 tokens, 16 new tokens each")
    plain, _, _ = run_engine("plain attention (reference)", dataclasses.replace(cfg, attn_kernel=None),
                             params, dev, prompts, 16, **engine_kw)
    kern, _, _ = counted(4, ("flash_attention", "decode_attention"), lambda: run_engine(
        "kernels, bf16 KV", cfg, params, dev, prompts, 16, **engine_kw))
    firsts = sum(a.output[0] == b.output[0] for a, b in zip(kern, plain))
    same = sum(a.output == b.output for a, b in zip(kern, plain))
    log(f"[4] first tokens equal to the plain engine's: {firsts}/8; whole outputs: {same}/8 "
        f"(bound: first tokens >= 6/8)")
    if firsts < 6:
        raise AssertionError("kernel engine disagrees with the plain engine")
    qcfg = dataclasses.replace(cfg, quantized_kv=True)
    qreqs, _, _ = counted(4, ("flash_attention", "decode_attention_int8"), lambda: run_engine(
        "kernels, int8 KV", qcfg, params, dev, prompts, 16, **engine_kw))
    log(f"[4] int8-KV first tokens equal to bf16-KV's: "
        f"{sum(a.output[0] == b.output[0] for a, b in zip(qreqs, kern))}/8")
    torch.cuda.empty_cache()

    log("[5] one long-context request: 8448-token prompt, cache_len 8480 (ring of 8192)")
    long_prompt = [rng.randrange(cfg.vocab_size) for _ in range(8448)]
    counted(5, ("sliding_window_attention", "decode_attention"), lambda: run_engine(
        "long context", cfg, params, dev, [long_prompt], 16, max_slots=1, cache_len=8480,
        prompt_bucket=32))
    del params
    torch.cuda.empty_cache()

    log("[6] launch/serve.py --arch qwen3-1.7b --batch 4 --prompt-len 256 --gen 16")
    metrics = counted(6, ("flash_attention", "decode_attention"), lambda: serve.main(
        ["--arch", QWEN, "--batch", "4", "--prompt-len", "256", "--gen", "16"],
        config_overrides={"attn_kernel": "flash"}))
    log(f"[6] per-token {metrics['per_token_ms']:.2f} ms, prefill {metrics['prefill_seconds']:.3f} s")
    log(f"[4-6] peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return total


def profile_decode(dev) -> None:
    """Phase 7: device time by kernel over 8 decode ticks (B=4, 256-token
    context, kernels on), beside the host clock, from torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(get_config(QWEN), attn_kernel="flash")
    params = T.init_model(cfg, seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    B, S, steps = 4, 256, 8
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device=dev)
    logits, cache = T.prefill(params, {"tokens": tokens}, cfg, S + 2 * steps + 4)
    tok = torch.argmax(logits[:, -1:], -1)
    pos = S
    for _ in range(2):  # warm
        logits, cache = T.decode_step(params, tok, cache, pos, cfg)
        pos += 1
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        logits, cache = T.decode_step(params, tok, cache, pos, cfg)
        tok = torch.argmax(logits[:, -1:], -1)
        pos += 1
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            logits, cache = T.decode_step(params, tok, cache, pos, cfg)
            tok = torch.argmax(logits[:, -1:], -1)
            pos += 1
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # kernels only: CPU-side ops also carry the device time of what they launch
    rows = [(e.self_device_time_total, e.key, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(r[0] for r in rows) / 1e3
    log(f"[7] decode B={B} context {S}: {plain_wall / steps * 1e3:.2f} ms/tick on the host "
        f"clock ({wall / steps * 1e3:.2f} under the profiler); device busy "
        f"{busy_ms / steps:.2f} ms/tick, {busy_ms / (wall * 1e3):.1%} of the profiled wall"
        if rows else "[7] device time: not measured (the profiler returned no device events)")
    for dev_us, key, count in sorted(rows, reverse=True)[:10]:
        log(f"[7]   {dev_us / 1e3 / steps:8.3f} ms/tick {dev_us / 1e3 / busy_ms:6.1%} "
            f"x{count / steps:<5g} {key[:90]}")
    del params, cache
    torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--phases", default="1,2,3,4,5,6,7",
                    help="comma-separated phases to run (default: all)")
    args = ap.parse_args(argv)
    phases = {int(p) for p in args.phases.split(",")}

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA card",
              file=sys.stderr)
        return 2
    from repro_torch import resolve_device
    from repro_torch.kernels import _build

    dev = resolve_device("cuda")
    # the card's name and power limit, as nvidia-smi gives them
    print(gpu_name_and_limit(), flush=True)
    log(f"[1] python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    secs = _build.build()
    log(f"[1] nvcc build of {sorted(secs)} in {time.perf_counter() - t0:.1f} s "
        f"({', '.join(f'{k} {v:.1f} s' for k, v in sorted(secs.items()))})")
    for name, text in sorted(_build.BUILD_LOG.items()):
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                log(f"[1]   {name}: {line.strip()}")

    records = {}
    if 2 in phases:
        log("[2] kernels against their plain versions")
        records = check_kernels(dev)
    if 3 in phases:
        model_vs_plain(dev)
    launches = {}  # from the main path's own run only; null when it did not run
    if phases & {4, 5, 6}:
        launches = main_path(dev)
    if 7 in phases:
        profile_decode(dev)

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    summary = [{k: ({**r, "launches": launches.get(r["name"])})[k] for k in keys}
               for r in records.values()]
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
