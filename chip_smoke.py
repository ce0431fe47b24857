#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase; needs one CUDA card

    python3 chip_smoke.py --phases 1,2,8,9   # kernels, one round, the trainer
    python3 chip_smoke.py --phases 11,12     # the serving fleet, train and serve
    python3 chip_smoke.py --phases 2,13      # kernels, then the model zoo at full width
    python3 chip_smoke.py --phases 2,14      # kernels, then MoE / SSM / VLM / enc-dec configs
    python3 chip_smoke.py --phases 1,2,15    # kernels, then the trainer's breadth (15a-15d)
    python3 chip_smoke.py --phases 1,2,16    # kernels, then the faulted wire (16a, 16b)
    python3 chip_smoke.py --phases 1,9,16,17 # the trainer, the faulted wire, then both on
                                             # rank processes (17a, 17b), and a run
                                             # checkpointed and resumed on them (17c)
    python3 chip_smoke.py --phases 1,2,18    # kernels, then llama4-scout-17b-a16e and the
                                             # dry run against the card (18a, 18b)
    python3 chip_smoke.py --phases 1,19      # the zoo's other families trained at full width
    python3 chip_smoke.py --turns PARENT     # attention and decode rows, PARENT's tree
                                             # and this one in turns (no phases)

Phases (any failure exits non-zero):
  1. card, versions, and an nvcc build of every kernel from ``csrc/``, with
     ptxas registers / spills and the SASS of the attention and decode
     libraries (the bf16 attention variants and the decode kernel's
     tensor-core body must hold tensor-core instructions and spill nothing;
     hd 256 must have its two-warpgroup variant);
  2. each kernel against its plain PyTorch version at the main paths'
     shapes: max error, tolerance, kernel / plain / library ms, bound, and
     for the attention rows achieved TFLOP/s and share of the bound
     (attention, block-sparse attention included, at the serving shapes;
     quantize, dequantize, fused encode (and its digest variant at the
     faulted round's 3 nodes), fused mix and block top-k at qwen3-1.7b's
     largest gossip chunk, outputs exactly equal; the MoE dispatch and its
     backward at deepseek-moe-16b's B4 x S2048 node, exactly equal, with
     the gradient's gap to autograd's gather they replace);
  3. full-width qwen3-1.7b (random seeded weights): prefill + 16 decode steps
     with ``attn_kernel="flash"`` and ``"block_sparse"`` against
     ``attn_kernel=None``;
  4. ``ServeEngine`` at full width: flash prefill with bf16 and int8 KV
     caches, block-sparse prefill with bf16 KV;
  5. one long-context request through the sliding-window prefill, then
     through the windowed block-sparse prefill (its logits against the
     plain path's), and the ring-buffer decode;
  6. the port's ``launch/serve.py`` batch mode, flash then block-sparse;
  7. torch.profiler over eight decode ticks: device time by kernel;
  8. one CHOCO round on the largest chunk at full width, packed path
     (quantize / dequantize kernels) against fused path (fused kernels);
  9. the port's ``launch/train.py``: 3 AD-GDA rounds of full-width
     qwen3-1.7b on 4 nodes with ``kq4b`` ring gossip, packed then fused,
     then with ``KernelBlockTopK(0.25, 1024)`` (block top-k on its kernel),
     with one round under torch.profiler each;
 10. the quickstart experiment (10 nodes, AD-GDA against CHOCO-SGD, 600
     rounds) with ``kq4b`` fused gossip and with ``top10``: AD-GDA's worst
     accuracy must not fall below CHOCO-SGD's, and under ``top10`` (which
     draws no noise) both must equal the reference's within 0.01;
 11. ``launch/serve.py --fleet 2`` at full width, on CUT_LAYERS = 7 of
     qwen3-1.7b's 28 layers (4 slots per node, a zipf
     pool of 64 prompts of 4-512 tokens, 1-32 new tokens, 96 requests) with
     flash, int8-KV decode and block-sparse attention, the --no-fastpath
     twin (its tick fields must equal the fast run's), an overload run
     (admission control must reject), and a hot reload mid-run through the
     fleet's API (a saved step is served, a torn newer file skipped);
 12. train and serve: AD-GDA and its unweighted twin on 10 nodes with
     ``kq4b`` fused gossip, the consensus checkpointed each phase and served
     by classifier engines that hot-reload it; AD-GDA's worst-node accuracy
     must be above the twin's;
 13. the model zoo at full width, one model on the card at a time:
     granite-20b (MQA, 48 query heads on one kv head) and recurrentgemma-2b
     (RG-LRU + local attention at hd 256), each on 7 of its layers, through
     prefill + decode against
     the plain path, ``ServeEngine`` with flash, flash + int8 KV and
     block-sparse prefill, and ``serve.py --fleet 2`` with its --no-fastpath
     twin (recurrentgemma-2b also one 4096-token request that wraps its
     2048-row rings); qwen3-4b and command-r-35b (30.3 B parameters) through
     ``serve.py`` batch mode against the plain path; peak memory per model;
 14. the MoE, SSM, VLM and encoder-decoder configs at full width, one on the
     card at a time: deepseek-moe-16b on 7 of its 28 layers (prefill + decode
     with flash and
     block-sparse against the plain path, its routing pinned; the engine at
     12 slots with flash, int8 KV and block-sparse; ``serve.py --fleet 2``
     and its twin), mamba2-1.3b (the decode continuing one chunked scan,
     held in f32 and read in bf16 beside the model's own noise floor; the
     engine; ``serve.py``), internvl2-2b with ``patches`` and whisper-small
     with ``frames`` (prefill + decode with flash and int8 KV against the
     plain path, the engine, ``serve.py``); peak memory and ms/token;
 15. the trainer's breadth at full width (on CUT_LAYERS = 7 of the 28
     layers): (a) ``launch/train.py`` on 4 nodes for 3 rounds with 25% dropout over round-robin ring + torus and over one-peer
     matchings (``kq4b``, the masked round on the quantize / dequantize
     kernels), then round-robin with block top-k, then 2 nodes with SGD
     momentum 0.9: each round's mask logged, a dropped node's theta,
     theta_hat, s and momentum equal bit for bit to a host copy taken
     before its round, launches = the chunk plan, bits = payload_bits at
     the schedule's max degree + the dual, one round profiled; (b) gradient tracking with 4 local steps on 2 nodes,
     fused then packed (launches = 2 lanes x the chunk plan, step-0 losses
     equal, later steps within 1e-3), peak memory; (c) resume: run A 4
     rounds, run B 2 rounds with ``--checkpoint``, run C ``--resume`` to 4:
     C's losses and final theta equal A's (else within two A runs' gap),
     the checkpoints' seconds and bytes (about 19 GB of free disk needed
     under the temp directory or the checkout, checked first); (d) the
     paper's small-model comparisons with the reference's settings in 7
     processes on the card, beside (a)-(c): FT's nine fault-free rows (bits exact against
     ``BENCH_FT.json``, worst accuracy within 0.05 below), the ksweep anchors
     (gt@16 above choco@8 and choco@16, its bits within 1.05 x choco@8's),
     Table 5 on rotated_minority (bits per iteration exact, the reference's
     worst-accuracy order held, DRFA on the reference's client samples);
 16. the fault-tolerant wire at full width (16a on 7 of the 28 layers):
     (a) ``launch/train.py`` on 3
     nodes, static ring, ``kq4b``, ``--fault-spec drop:0.2,corrupt:0.1,stale:0``,
     P16_ROUNDS rounds packed, then the same rounds ``--fused-gossip`` (the
     fused encode's digest variant) on the same seeds: the drawn events
     cover a drop, a corrupt, a verified and a failed resync; after every
     round every synced mirror equals its sender's theta_hat bit for bit
     and every unsynced one differs in a chunk digest; the realized bits
     equal the host's formula from the round's events; launches = the
     formula; fused = packed bit for bit (theta, theta_hat, s, both
     mirrors, the fault state, the meter); (b) FT's six faulted rows (run
     in 15d's pool, or alone without phase 15) held by the reference's FT
     rules: consensus error <= 2x the fault-free twin's, detections and
     resyncs > 0, drop rows' worst accuracy >= the twin's - 0.05, worst
     accuracy >= the reference's - 0.05, bits exact, detections and
     resyncs within 20% of the reference's.
 17. the multi-process wire, on 7 of the 28 layers: ``launch/train.py
     --gossip-backend ppermute`` on rank processes that share the card
     (gloo through page-locked host buffers, the env a launcher sets): (a)
     4 nodes on 2 ranks, ``kq4b``, 3 rounds packed then fused; (b) 3 nodes
     on 3 ranks, ``kq4b`` fused, ``--fault-spec drop:0.2,corrupt:0.1,stale:0``,
     4 rounds.  Each rank
     records per round the chunk digests of its rows of theta, theta_hat, s
     (and the mirrors), which must equal the one-process run's (17a's own,
     16a's or, without phase 16, one of its own) round by round, with the losses, the
     consensus error (1e-6), the fault state and the meter; launches per
     rank = its block's share of the chunk plan; the bytes each rank sends
     a round = the formula (PERF.md); seconds, wire seconds and peak memory
     per rank, one 17a fused round profiled on each rank; (c) resume on
     the ranks: 2 nodes on 2 ranks, ``kq4b`` fused, run A 4 rounds, run B 2
     rounds with ``--checkpoint`` (rank 0 writes the one state file,
     gathering the other rank's rows), run C ``--resume`` to 4 on the
     ranks, run D ``--resume`` to 4 in one process on the rolled backend
     from B's file: C's and D's losses of rounds 2-3 and chunk digests
     after round 4 equal A's bit for bit, B's file has the one-process
     file's leaves (names, shapes, dtypes; whole [2, ...]), the fused
     kernels launch the chunk plan once a round in every run; each save's
     and restore's seconds and GB and the bytes each rank sent to rank 0
     (about 19 GB of free disk needed, checked first).
 18. llama4-scout-17b-a16e (16 experts top-1 + shared, 40 query heads on
     8) at full width and the depth its dry run picks (the deepest whose
     predicted peak on a one-device mesh is at most 70 GiB, at least 8 of
     48 layers): (b) the dry run (``launch/dryrun.py``) of the plain prefill
     B4 S200 and the decode step after it against the card: argument bytes
     exactly the arguments', predicted peak within 5% of
     ``max_memory_allocated()``, then one production pair (``decode_32k`` on
     the fake 16x16 mesh) in its own process, its row and seconds; (a)
     prefill + 16 decode steps with flash and block-sparse against the
     plain path (routing pinned), the engine at 12 slots with flash, int8
     KV and block-sparse (first tokens >= 9/12, launches exact); peak
     memory and ms/token.
 19. the zoo trained through ``launch/train.py`` at full width with
     ``kq4b`` fused gossip, one model on the card at a time (P19_RUNS:
     whisper-small, internvl2-2b, mamba2-1.3b, recurrentgemma-2b and
     qwen3-4b at full depth, deepseek-moe-16b on 6 of its 28 layers,
     granite-20b on 7 of 52, command-r-35b on 2 of 40,
     llama4-scout-17b-a16e on 1 of 48), 2 rounds on a ring; whisper's
     ``frames`` and internvl2's ``patches`` seeded N(0, 0.02²) stubs
     (``serve.stub_inputs``: the reference's zeros do not train);
     deepseek-moe-16b, mamba2-1.3b and llama4 also packed (quantize /
     dequantize), step-0 losses equal to the fused run's and step 1 within
     1e-3 (the MoE routing pinned to the fused run's); per run launches =
     the chunk plan x the rounds, bits = ``payload_bits`` + the dual's,
     finite losses and consensus error, peak memory at most 70 GiB; round 1
     of the fused run profiled for deepseek-moe-16b, mamba2-1.3b,
     recurrentgemma-2b, command-r-35b and llama4 (kernel ms by section).
Phases 4-6, 9 and 11-19 are the main paths: launch counters are zeroed
just before each run and read just after, and every kernel the run goes
through must have launched (in phases 11, 13, 14 and 18, once per attention
layer and model forward).  Phase 2 also checks and times the attention and
decode kernels at the zoo's shapes (hd 256 and 64, 40 heads; decode at G 48,
G 10 with hd 256, G 4, G 8, G 5, G 1 on 16 kv heads and G 1 with hd 64), and
the decode kernel's split body against its wide body where both apply; the
zoo rows' launches come from phases 13, 14 and 18.  The line before the
last is the kernels' JSON summary; the last line is the run's JSON status.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib
import json
import math
import os
import random
import re
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
# covers f32 summation-order noise on outputs near zero.  The bf16 flash,
# sliding-window and block-sparse kernels also round P to bf16 before the PV
# product, which adds at most 2**-8 * (plain attention of |v|) per element
# (ref.p_rounding_bound, passed as ``slack``)
TOL = {"bfloat16": dict(atol=1e-4, rtol=1e-2), "float32": dict(atol=2e-5, rtol=1e-4)}
L2_BYTES = 50 * 2**20
# kernels by main path: the serving phases (4-6) and the trainer (9)
SERVING_KERNELS = ("flash_attention", "sliding_window_attention", "decode_attention",
                   "decode_attention_int8", "block_sparse_attention")
GOSSIP_KERNELS = ("quantize", "dequantize", "fused_encode", "fused_encode_digest", "fused_mix",
                  "block_topk")


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


def device_ms(fn, arg_sets, reps: int) -> float:
    """Device ms per call of the kernels ``fn`` launches (torch.profiler: their
    self device time summed over ``reps`` calls), without the host's launch
    time that ``time_ms`` counts when a call's kernels are shorter."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for a in arg_sets[:2]:
        fn(*a)
    torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    # the profiler now and then hands back a trace without device events:
    # trace again, and fail if it never records any
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(reps):
                fn(*arg_sets[i % len(arg_sets)])
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == cuda)
        if total > 0:
            return total / reps / 1e3
        log("  device_ms: the profiler recorded no device time; tracing again")
    raise AssertionError("device_ms: the profiler recorded no device time in three traces")


def copies_past_l2(make, nbytes: int):
    n = max(2, min(8, math.ceil(2 * L2_BYTES / max(nbytes, 1))))
    return [make() for _ in range(n)]


def within_tol(label, out, ref, dtype: str, failures: list, slack=None) -> float:
    """Log and check ``|out - ref| <= atol + rtol * |ref| (+ slack)`` per
    element (TOL[dtype]; ``slack`` a tensor like ``ref``); returns the max abs
    error, appends ``label`` on failure."""
    import torch

    out, ref = out.float(), ref.float()
    err = (out - ref).abs()
    tol = TOL[dtype]
    limit = tol["atol"] + tol["rtol"] * ref.abs() + (0.0 if slack is None else slack)
    ok = bool(torch.isfinite(out).all()) and bool((err <= limit).all())
    mx = float(err.max())
    extra = "" if slack is None else f" + 2^-8*plain(|v|) (max {float(slack.max()):.2e})"
    log(f"  {label}: max_abs_err={mx:.3e} rel_l2={float((out - ref).norm() / ref.norm()):.3e} "
        f"mean|ref|={float(ref.abs().mean()):.3e} max err/limit={float((err / limit).max()):.3f} "
        f"tol(atol={tol['atol']}, rtol={tol['rtol']}{extra}) {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(label)
    return mx


def bound(ops: float, nbytes: float, dtype: str) -> tuple[float, str]:
    t_ops = ops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# kernel ms per call of these attention rows when both kernels multiplied in
# f32 on the CUDA cores, before the tensor-core mainloop (NVIDIA H100 80GB
# HBM3, 700 W), printed beside today's
CUDA_CORE_MS = {"flash causal B4 S512": 0.2704, "sliding window S8448": 11.3479,
                "block_sparse causal S512": 0.3022, "block_sparse windowed S8448": 11.7953}


def attention_rate(tag: str, flops: float, ms: float, b_ms: float, fn, lib, sets, tsets,
                   reps: int) -> None:
    """Log a redesigned attention row: per-call ms (``time_ms``) and device ms
    of the kernel and of the library call, achieved TFLOP/s and share of the
    bound on each, and the ratio to the CUDA-core design's reading."""
    dev, lib_dev = device_ms(fn, sets, reps), device_ms(lib, tsets, reps)
    log(f"  rate {tag}: per call {ms:.4f} ms ({flops / (ms * 1e-3) / 1e12:.1f} TFLOP/s, "
        f"{b_ms / ms:.1%} of the bound); device {dev:.4f} ms ({flops / (dev * 1e-3) / 1e12:.1f} "
        f"TFLOP/s, {b_ms / dev:.1%} of the bound); library device {lib_dev:.4f} ms; "
        f"the CUDA-core design's {CUDA_CORE_MS[tag]:.4f} ms is {CUDA_CORE_MS[tag] / ms:.1f}x "
        f"the per-call time")


# ------------------------------------------------------------------ phase 1
SASS_OPS = ("HGMMA", "UTMALDG", "HMMA", "LDGSTS")
# kernel variants that must hold tensor-core instructions and spill nothing:
# every bf16 attention variant, and the decode library's tensor-core body
TENSOR_CORE_VARIANTS = re.compile(r"attn_fwd_bf16|decode_mma_kernel")


def ptxas_report() -> dict[str, tuple[int, int]]:
    """(registers, spill bytes: stores + loads) per kernel from this run's
    ptxas reports (empty for a library that was already built)."""
    from repro_torch.kernels import _build

    report = {}
    for text in _build.BUILD_LOG.values():
        fn, spill = None, 0
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                fn, spill = m.group(1), 0
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                spill = int(m.group(1)) + int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m and fn is not None:
                report[fn] = (int(m.group(1)), spill)
    return report


def attention_sass() -> None:
    """Count tensor-core (HGMMA: wgmma, HMMA: mma.sync) and copy (UTMALDG:
    TMA, LDGSTS: cp.async) instructions in the attention and decode
    libraries' SASS, per kernel variant; fail if a bf16 attention variant or
    a tensor-core decode variant has no tensor-core instruction or spills,
    or if hd 256 has no two-warpgroup (384-thread) bf16 variant."""
    from repro_torch.kernels import _build

    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    ptxas = ptxas_report()
    bad = []
    for name in ("flash_attn", "block_sparse_attn", "decode_attn"):
        sass = subprocess.run([str(cuobjdump), "--dump-sass", str(_build.lib_path(name))],
                              capture_output=True, text=True, timeout=300, check=True).stdout
        counts: dict[str, dict[str, int]] = {}
        fn = None
        for line in sass.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                fn = m.group(1)
                counts[fn] = dict.fromkeys(SASS_OPS, 0)
            elif fn is not None:
                for op in SASS_OPS:
                    if re.search(rf"\b{op}\b", line):
                        counts[fn][op] += 1
        for fn, c in sorted(counts.items()):
            variant = ("bf16" if "attn_fwd_bf16" in fn else "f32" if "attn_fwd_f32" in fn
                       else "tensor-core" if "decode_mma_kernel" in fn
                       else "split" if "decode_split_kernel" in fn
                       else "CUDA-core wide" if "decode_wide_kernel" in fn else "?")
            m = re.search(r"attn_fwd_bf16ILi(\d+)ELi(\d)E", fn)
            shape = f" hd {m.group(1)}, {128 * (int(m.group(2)) + 1)} threads" if m else ""
            log(f"[1]   {name} SASS {variant}{shape} {fn[:60]}: "
                + ", ".join(f"{op} {n}" for op, n in c.items())
                + ("" if fn not in ptxas else
                   f"; {ptxas[fn][0]} registers, {ptxas[fn][1]} spill bytes"))
            if TENSOR_CORE_VARIANTS.search(fn) and (c["HGMMA"] + c["HMMA"] == 0
                                                    or ptxas.get(fn, (0, 0))[1] > 0):
                bad.append(fn)
        if name != "decode_attn" and not any("attn_fwd_bf16ILi256ELi2E" in fn for fn in counts):
            bad.append(f"{name}: no two-warpgroup bf16 variant at hd 256")
        if not any(TENSOR_CORE_VARIANTS.search(fn) for fn in counts):
            bad.append(f"{name}: no tensor-core variant")
    if bad:
        raise AssertionError(f"tensor-core kernels without tensor-core instructions, or "
                             f"spilling: {bad}")


# --------------------------------------------------------------- phase 2
def decode_row(name, B, L, KV, G, hd, valid, quant, make, failures: list) -> dict:
    """One bf16 decode row (int8 K/V with ``quant``): the kernel against its
    plain version, then per-call, device and plain ms, SDPA's (bf16 only),
    and the bound over the live rows; ``make()`` draws fresh inputs
    ``(q, k, v, valid, k_scale, v_scale)``.  Returns the row's record."""
    import torch.nn.functional as F

    from repro_torch.kernels import decode as kd

    def run_kernel(q, k, v, vl, ks, vs):
        return kd.decode_attention(q, k, v, vl, k_scale=ks, v_scale=vs)

    def run_plain(q, k, v, vl, ks, vs):
        return kd.decode_attention_plain(q, k, v, vl, k_scale=ks, v_scale=vs)

    def sdpa(q, k, v, m):
        return F.scaled_dot_product_attention(q, k, v, attn_mask=m, enable_gqa=True)

    n_valid = int(valid.sum())  # rows the result depends on; the bound counts only these
    shape = f"B={B} L={L} KV={KV} G={G} hd={hd} {'int8 KV' if quant else 'bfloat16'}"
    args = make()
    err = within_tol(f"decode{' int8' if quant else ''} B{B} L{L} KV{KV} G{G} hd{hd} bfloat16",
                     run_kernel(*args), run_plain(*args), "bfloat16", failures)
    nbytes = (2 * n_valid * KV * hd * (1 if quant else 2) + 2 * B * KV * G * hd * 2 + B * L
              + (2 * n_valid * KV * 4 if quant else 0))
    sets = copies_past_l2(make, nbytes)
    ms, plain_ms = time_ms(run_kernel, sets, 50), time_ms(run_plain, sets, 20)
    dev_ms = device_ms(run_kernel, sets, 50)
    lib_ms = lib_dev = None
    if not quant:
        tsets = [(a[0].reshape(B, KV * G, 1, hd), a[1].transpose(1, 2).contiguous(),
                  a[2].transpose(1, 2).contiguous(), a[3][:, None, None, :]) for a in sets]
        lib_ms, lib_dev = time_ms(sdpa, tsets, 50), device_ms(sdpa, tsets, 50)
        del tsets
    b_ms, b_by = bound(4 * n_valid * KV * G * hd, nbytes, "bfloat16")
    lib_txt = ("none" if quant else f"per call {lib_ms:.4f} ms, device {lib_dev:.4f} ms "
               f"({b_ms / lib_dev:.1%} of the bound)")
    log(f"  rate {name} [{shape}]: per call {ms:.4f} ms ({b_ms / ms:.1%} of the bound), device "
        f"{dev_ms:.4f} ms ({b_ms / dev_ms:.1%} of the bound); plain {plain_ms:.4f} ms; library "
        f"(SDPA) {lib_txt}; bound {b_ms:.4f} ms ({b_by})")
    return dict(name=name, route="cuda", source="src/repro_torch/csrc/decode_attn.cu",
                replaces="src/repro/kernels/decode.py:125", max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                device_ms=dev_ms, shape=f"{shape}, {n_valid} valid rows")


def decode_bodies(label, make, failures: list) -> None:
    """The decode kernel's split body (what runs at G <= 2, hd 64 / 128)
    against its wide body forced on the same inputs, bf16 and int8 KV: the
    wide body checked against the plain version, then the device ms of both
    in turns (split, wide, wide, split).  ``make(quant)`` draws inputs."""
    from repro_torch.kernels import decode as kd

    def split(q, k, v, vl, ks, vs):
        return kd.decode_attention(q, k, v, vl, k_scale=ks, v_scale=vs)

    def wide(q, k, v, vl, ks, vs):
        return kd.decode_attention_wide_body(q, k, v, vl, k_scale=ks, v_scale=vs)

    for quant in (False, True):
        sets = [make(quant) for _ in range(4)]
        q, k, v, vl, ks, vs = sets[0]
        within_tol(f"decode wide body forced {label}{' int8' if quant else ''}", wide(*sets[0]),
                   kd.decode_attention_plain(q, k, v, vl, k_scale=ks, v_scale=vs), "bfloat16",
                   failures)
        turns = [device_ms(fn, sets, 50) for fn in (split, wide, wide, split)]
        log(f"  decode bodies {label}{' int8 KV' if quant else ' bf16'}: device ms split "
            f"{turns[0]:.4f} / {turns[3]:.4f}, wide {turns[1]:.4f} / {turns[2]:.4f} (wide / split "
            f"{(turns[1] + turns[2]) / (turns[0] + turns[3]):.2f}x)")


def check_kernels(dev) -> dict:
    """Each kernel against its plain version; returns per-kernel records."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import decode as kd
    from repro_torch.kernels import sliding_window as ksw
    from repro_torch.kernels.ref import p_rounding_bound, quantize_kv_ref
    kf = importlib.import_module("repro_torch.kernels.flash_attention")  # not the wrapper

    gen = torch.Generator(device=dev).manual_seed(0)
    records: dict[str, dict] = {}
    failures = []

    def randn(*shape, dtype):
        return torch.randn(*shape, generator=gen, device=dev, dtype=torch.float32).to(dtype)

    def compare(label, out, ref, dtype, slack=None):
        return within_tol(label, out, ref, dtype, failures, slack)

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
        slack = None if dt == "float32" else p_rounding_bound(
            lambda v_: kf.flash_attention_plain(q, k, v_, causal=True, window=window), v)
        err = compare(label, out, ref, dt, slack)
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
            attention_rate("flash causal B4 S512", 4 * B * H * hd * pairs(S, None), ms, b_ms,
                           lambda a, b_, c: kf.flash_attention(a, b_, c, causal=True),
                           lambda a, b_, c: F.scaled_dot_product_attention(a, b_, c,
                                                                           is_causal=True),
                           sets, tsets, 20)
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
    slack = p_rounding_bound(lambda v_: ksw.sliding_window_attention_plain(q, k, v_, window=W), v)
    err = compare(f"sliding window B{B} S{S} H{H} hd{hd} window={W} bf16", out, ref, "bfloat16",
                  slack)
    del ref, slack
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
    attention_rate("sliding window S8448", 4 * B * H * hd * pairs(S, W), ms, b_ms,
                   lambda a, b_, c: ksw.sliding_window_attention(a, b_, c, window=W),
                   lambda a, b_, c: F.scaled_dot_product_attention(a, b_, c, attn_mask=band),
                   sets, tsets, 3)
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

    def decode_inputs(dtype, quant):
        q = randn(B, KV, G, hd, dtype=dtype)
        k = randn(B, L, KV, hd, dtype=dtype)
        v = randn(B, L, KV, hd, dtype=dtype)
        if not quant:
            return (q, k, v, valid, None, None)
        kq, ks = quantize_kv_ref(k)
        vq, vs = quantize_kv_ref(v)
        return (q, kq, vq, valid, ks, vs)

    for name, quant in (("decode_attention", False), ("decode_attention_int8", True)):
        rec = decode_row(name, B, L, KV, G, hd, valid, quant,
                         lambda: decode_inputs(torch.bfloat16, quant), failures)
        log(f"  the unsplit design's {UNSPLIT_DECODE_MS[name]:.4f} ms is "
            f"{UNSPLIT_DECODE_MS[name] / rec['ms']:.1f}x the per-call time")
        records[name] = rec
    decode_bodies(f"qwen3-1.7b G{G} hd{hd}", lambda quant: decode_inputs(torch.bfloat16, quant),
                  failures)
    q, k, v, vl, _, _ = decode_inputs(torch.float32, False)
    compare(f"decode B{B} L{L} KV{KV} G{G} hd{hd} float32", kd.decode_attention(q, k, v, vl),
            kd.decode_attention_plain(q, k, v, vl), "float32")
    decode_edge_cases(dev, gen, failures)
    decode_workspace_cost(dev)
    torch.cuda.synchronize()
    for r in records.values():
        log(f"  time {r['name']} [{r['shape']}]: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library "
            f"{'n/a' if r['library_ms'] is None else format(r['library_ms'], '.4f') + ' ms'}, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    if failures:
        raise AssertionError(f"kernels disagree with their plain versions: {failures}")
    return records


# kernel ms per call of the decode rows before split-L (one block per (kv head,
# batch row) walking all L; NVIDIA H100 80GB HBM3, 700 W), printed beside today's
UNSPLIT_DECODE_MS = {"decode_attention": 0.1735, "decode_attention_int8": 0.1972}


def decode_edge_cases(dev, gen, failures: list) -> None:
    """The decode kernel against its plain version where its split plan has
    edges: a batch row with no live position (the uniform mean of V), L below
    one 64-row tile, L not a multiple of it, G = 1 and G = 8 (the split and
    the wide body); each for bf16, f32 and int8 KV."""
    import torch

    from repro_torch.kernels import decode as kd
    from repro_torch.kernels.ref import quantize_kv_ref

    cases = {"all-masked row": (3, 200, 2, 2, 128), "L=37": (3, 37, 2, 2, 64),
             "L=1000": (3, 1000, 8, 2, 128), "G=1": (3, 300, 4, 1, 128),
             "G=8": (3, 500, 2, 8, 64)}
    for case, (B, L, KV, G, hd) in cases.items():
        pos = torch.tensor([17, 3 * L + 5, L // 2], device=dev)  # linear, wrapped ring, linear
        slot = torch.remainder(pos, L)
        age = torch.remainder(slot[:, None] - torch.arange(L, device=dev)[None], L)
        valid = age < torch.clamp(pos + 1, max=L)[:, None]
        if case == "all-masked row":
            valid[1] = False
        for dt in ("bfloat16", "float32", "int8"):
            ftype = torch.float32 if dt == "int8" else getattr(torch, dt)
            q, k, v = (torch.randn(*s, generator=gen, device=dev).to(ftype)
                       for s in ((B, KV, G, hd), (B, L, KV, hd), (B, L, KV, hd)))
            kw = {}
            if dt == "int8":
                (k, ks), (v, vs) = quantize_kv_ref(k), quantize_kv_ref(v)
                kw = dict(k_scale=ks, v_scale=vs)
            out = kd.decode_attention(q, k, v, valid, **kw)
            torch.cuda.synchronize()
            within_tol(f"decode split {case} B{B} L{L} KV{KV} G{G} hd{hd} {dt} "
                       f"(chunks of {kd.split_plan(B, KV, L, G)[0]})", out,
                       kd.decode_attention_plain(q, k, v, valid, **kw),
                       "float32" if ftype == torch.float32 else dt, failures)


def decode_workspace_cost(dev) -> None:
    """Host microseconds per call of the two ways to get the decode kernel's
    scratch (partials and zeroed completion counts): fresh tensors from the
    caching allocator (``torch.empty`` and ``torch.zeros``, which launches a
    fill) against the wrapper's per-(device, stream) pair."""
    import torch

    from repro_torch.kernels import decode as kd

    n, rows = 4 * 8 * 16 * 2 * (128 + 2), 4 * 8  # B4 KV8, 16 chunks, G2, hd 128
    stream = torch.cuda.current_stream(dev).cuda_stream
    reps = 20000
    cost = {}
    for label, fn in (("torch.empty + torch.zeros",
                       lambda: (torch.empty(n, dtype=torch.float32, device=dev),
                                torch.zeros(rows, dtype=torch.int32, device=dev))),
                      ("cached pair", lambda: kd._workspace(dev, stream, n, rows))):
        best = math.inf
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            best = min(best, (time.perf_counter() - t0) / reps * 1e6)
        cost[label] = best
    torch.cuda.synchronize()
    log("  decode scratch, host us per call (best of 3 x 20000): "
        + ", ".join(f"{k} {v:.3f}" for k, v in cost.items()))


def check_block_sparse(dev) -> dict:
    """Block-sparse attention against its plain version: the engine's
    prefill (B4 S512, causal, block 128), the long request's (B1 S8448,
    window 8192, block 128), a strided pattern, and f32 at block 16."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import block_sparse as kbs
    from repro_torch.kernels.flash_attention import tile_q
    from repro_torch.kernels.ref import block_sparse_mask, p_rounding_bound

    P = kbs.BlockSparsePattern
    gen = torch.Generator(device=dev).manual_seed(13)
    failures: list[str] = []
    records: dict[str, dict] = {}
    cases = [  # label, B, H, hd, dtype, pattern, timed as
        ("causal B4 S512 H16 hd128 block 128 bf16", 4, 16, 128, "bfloat16",
         P.causal_pattern(512, 512, 128, 128), "record"),
        ("windowed 8192 B1 S8448 H16 hd128 block 128 bf16", 1, 16, 128, "bfloat16",
         P.windowed(8448, 8448, 8192, 128, 128), "log"),
        ("strided local 2 stride 3 B4 S512 H16 hd128 block 64 bf16", 4, 16, 128, "bfloat16",
         P.strided(512, 512, local_blocks=2, stride=3, block_q=64, block_k=64), None),
        ("windowed 40 B2 S256 H4 hd64 block 16 f32", 2, 4, 64, "float32",
         P.windowed(256, 256, 40, 16, 16), None),
    ]
    for desc, B, H, hd, dt, pattern, timed in cases:
        dtype = getattr(torch, dt)
        S = pattern.seq_q

        def make():
            return tuple(torch.randn(B, S, H, hd, generator=gen, device=dev).to(dtype)
                         for _ in range(3))

        q, k, v = make()
        out = kbs.block_sparse_attention(q, k, v, pattern)
        torch.cuda.synchronize()
        label = f"block_sparse {desc} (density {pattern.density():.3f})"
        slack = None if dt == "float32" else p_rounding_bound(
            lambda v_: kbs.block_sparse_attention_plain(q, k, v_, pattern), v)
        err = within_tol(label, out, kbs.block_sparse_attention_plain(q, k, v, pattern), dt,
                         failures, slack)
        del slack
        if timed is None:
            continue
        mask = block_sparse_mask(pattern, dev)
        pairs = int(mask.sum())  # the live (q, k) pairs this pattern needs
        # q, k, v, o once, and the kernel's tile lists and the block bitmap
        entries, counts, _ = pattern.kernel_tiles(tile_q(S))
        nbytes = (4 * B * S * H * hd * dtype.itemsize
                  + 4 * (entries.size + counts.size + pattern.bitmap.size))
        sets = copies_past_l2(make, nbytes) if timed == "record" else [(q, k, v)]
        reps = 20 if timed == "record" else 3
        ms = time_ms(lambda a, b_, c: kbs.block_sparse_attention(a, b_, c, pattern), sets, reps)
        plain_ms = time_ms(lambda a, b_, c: kbs.block_sparse_attention_plain(a, b_, c, pattern),
                           sets, max(2, reps // 4))
        tsets = [tuple(t.transpose(1, 2).contiguous() for t in s_) for s_ in sets]
        lib_ms = time_ms(lambda a, b_, c: F.scaled_dot_product_attention(a, b_, c, attn_mask=mask),
                         tsets, reps)
        b_ms, b_by = bound(4 * B * H * hd * pairs, nbytes, dt)
        rec = dict(name="block_sparse_attention", route="cuda",
                   source="src/repro_torch/csrc/block_sparse_attn.cu",
                   replaces="src/repro/kernels/block_sparse.py:214", max_abs_err=err, ms=ms,
                   plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                   shape=desc)
        log(f"  time block_sparse_attention [{rec['shape']}]: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, library (SDPA with the pattern's mask) {lib_ms:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by}; {pairs} live pairs per head), {b_ms / ms:.1%} of the bound")
        attention_rate("block_sparse causal S512" if timed == "record"
                       else "block_sparse windowed S8448", 4 * B * H * hd * pairs, ms, b_ms,
                       lambda a, b_, c: kbs.block_sparse_attention(a, b_, c, pattern),
                       lambda a, b_, c: F.scaled_dot_product_attention(a, b_, c, attn_mask=mask),
                       sets, tsets, reps)
        if timed == "record":
            records["block_sparse_attention"] = rec
        del sets, tsets, mask
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError(f"block-sparse kernel disagrees with its plain version: {failures}")
    return records


# the model zoo's shapes beyond qwen3-1.7b's: recurrentgemma-2b's local
# attention (hd 256, 10 heads on one kv head, window 2048) and decode over its
# 2048-row ring; granite-20b's decode (48 query heads on one kv head), both
# with bf16 and int8 KV as phase 13's engines serve them; qwen3-4b's (G 4)
# and command-r-35b's (G 8) decode over the 272-row linear caches of their
# serve.py batches, bf16 as served (int8 KV checked, not a row: no main path
# runs it at these shapes); phase 14's: deepseek-moe-16b's engine (12 slots
# of a 1024-row linear cache, one query head on each of 16 kv heads) and
# whisper-small's (hd 64, 12 kv heads, a 256-row cache), bf16 and int8 KV,
# positions mid-decode (``pos``: the rows written so far, less one)
RG_ATTN = dict(B=1, S=8448, H=10, hd=256, window=2048)
ZOO_DECODE = {
    "G48 hd128": dict(B=4, L=1024, KV=1, G=48, hd=128, arch="granite-20b", int8_row=True),
    "G10 hd256": dict(B=4, L=2048, KV=1, G=10, hd=256, arch="recurrentgemma-2b", int8_row=True),
    "G4 hd128": dict(B=4, L=272, KV=8, G=4, hd=128, arch="qwen3-4b", int8_row=False),
    "G8 hd128": dict(B=2, L=272, KV=8, G=8, hd=128, arch="command-r-35b", int8_row=False),
    "G1 KV16 hd128": dict(B=12, L=1024, KV=16, G=1, hd=128, arch="deepseek-moe-16b",
                          int8_row=True, pos=(25, 608, 138, 341, 25, 488, 72, 259, 608, 104,
                                              208, 53)),
    "G1 hd64": dict(B=4, L=256, KV=12, G=1, hd=64, arch="whisper-small", int8_row=True,
                    pos=(15, 47, 127, 24)),
    # phase 18: llama4-scout-17b-a16e's engine (12 slots of a 1024-row
    # linear cache, 40 query heads on 8 kv heads)
    "G5 hd128": dict(B=12, L=1024, KV=8, G=5, hd=128, arch="llama4-scout-17b-a16e",
                     int8_row=True, pos=(25, 608, 138, 341, 25, 488, 72, 259, 608, 104, 208,
                                         53)),
}
# whisper-small's decoder self-attention prefill (12 heads of 64, causal)
WHISPER_ATTN = dict(B=4, S=200, H=12, hd=64)
# llama4-scout-17b-a16e's prefill (phase 18): 40 query heads (8 kv heads
# repeated), hd 128, causal
LLAMA4_ATTN = dict(B=4, S=200, H=40, hd=128)


def check_wide_shapes(dev) -> dict:
    """Phase 2's rows for the model zoo's shapes: flash and the sliding
    window at hd 256 (recurrentgemma-2b's prefill, short and at S 8448 with
    its 2048 window), block-sparse at the same shape, f32 bodies at hd 256,
    and decode at G 48 / hd 128 and G 10 / hd 256 (bf16 and int8 KV, a
    wrapped ring) and at qwen3-4b's G 4 and command-r-35b's G 8 (hd 128,
    272-row caches); for phase 14, flash at whisper-small's hd 64 (12
    heads) and decode at deepseek-moe-16b's G 1 on 16 kv heads and
    whisper-small's G 1 at hd 64 (bf16 and int8 KV); for phase 18 flash at
    llama4-scout-17b-a16e's 40 heads and decode at its G 5 (bf16 and int8
    KV); each against its plain version and timed; then the decode edge
    cases at the new G and hd.  Each record names the counter and the arch
    whose phase-13, 14 or 18 runs give its launches."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import block_sparse as kbs
    from repro_torch.kernels import decode as kd
    from repro_torch.kernels import sliding_window as ksw
    from repro_torch.kernels.flash_attention import tile_q
    from repro_torch.kernels.ref import block_sparse_mask, p_rounding_bound, quantize_kv_ref
    kf = importlib.import_module("repro_torch.kernels.flash_attention")  # not the wrapper

    gen = torch.Generator(device=dev).manual_seed(17)
    failures: list[str] = []
    records: dict[str, dict] = {}
    rg = "recurrentgemma-2b"

    def randn(*shape, dtype):
        return torch.randn(*shape, generator=gen, device=dev, dtype=torch.float32).to(dtype)

    def pairs(S, window):
        return sum(min(i + 1, window or S) for i in range(S))

    def attention_row(name, label, fn, plain, lib, q, k, v, dt, live_pairs, reps, sets=None):
        """Check ``fn`` against ``plain`` (with the P-rounding slack for bf16),
        time both and the library call, log the device rates; the record."""
        out = fn(q, k, v)
        torch.cuda.synchronize()
        ref = plain(q, k, v)
        slack = None if dt == "float32" else p_rounding_bound(lambda v_: plain(q, k, v_), v)
        err = within_tol(label, out, ref, dt, failures, slack)
        del out, ref, slack
        B, S, H, hd = q.shape
        nbytes = 4 * B * S * H * hd * q.element_size()
        sets = sets or [(q, k, v)]
        ms = time_ms(fn, sets, reps)
        plain_ms = time_ms(plain, sets, max(2, reps // 4))
        tsets = [tuple(t.transpose(1, 2).contiguous() for t in s_) for s_ in sets]
        lib_ms = time_ms(lib, tsets, reps)
        flops = 4 * B * H * hd * live_pairs
        b_ms, b_by = bound(flops, nbytes, dt)
        dev_ms, lib_dev = device_ms(fn, sets, reps), device_ms(lib, tsets, reps)
        log(f"  time {name} [{label}]: per call {ms:.4f} ms ({flops / (ms * 1e-3) / 1e12:.1f} "
            f"TFLOP/s, {b_ms / ms:.1%} of the bound), device {dev_ms:.4f} ms "
            f"({b_ms / dev_ms:.1%}); plain {plain_ms:.4f} ms; library (SDPA) per call "
            f"{lib_ms:.4f} ms, device {lib_dev:.4f} ms; bound {b_ms:.4f} ms ({b_by})")
        counter = name.split(" ")[0]
        return dict(name=name, route="cuda", max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms, device_ms=dev_ms,
                    counter=counter, arch=rg, shape=label)

    # -- sliding window and block-sparse at recurrentgemma-2b's long prefill
    B, S, H, hd, W = (RG_ATTN[k] for k in ("B", "S", "H", "hd", "window"))
    q, k, v = (randn(B, S, H, hd, dtype=torch.bfloat16) for _ in range(3))
    qpos = torch.arange(S, device=dev)
    band = (qpos[:, None] >= qpos[None, :]) & (qpos[:, None] - qpos[None, :] < W)
    rec = attention_row(
        "sliding_window_attention hd256", f"B{B} S{S} H{H} hd{hd} window={W} bf16",
        lambda a, b_, c: ksw.sliding_window_attention(a, b_, c, window=W),
        lambda a, b_, c: ksw.sliding_window_attention_plain(a, b_, c, window=W),
        lambda a, b_, c: F.scaled_dot_product_attention(a, b_, c, attn_mask=band),
        q, k, v, "bfloat16", pairs(S, W), 5)
    records[rec["name"]] = dict(rec, source="src/repro_torch/csrc/flash_attn.cu",
                                replaces="src/repro/kernels/sliding_window.py:139")
    pattern = kbs.BlockSparsePattern.windowed(S, S, W, 128, 128)
    mask = block_sparse_mask(pattern, dev)
    rec = attention_row(
        "block_sparse_attention hd256", f"windowed {W} B{B} S{S} H{H} hd{hd} block 128 bf16 "
        f"(density {pattern.density():.3f})",
        lambda a, b_, c: kbs.block_sparse_attention(a, b_, c, pattern),
        lambda a, b_, c: kbs.block_sparse_attention_plain(a, b_, c, pattern),
        lambda a, b_, c: F.scaled_dot_product_attention(a, b_, c, attn_mask=mask),
        q, k, v, "bfloat16", int(mask.sum()), 5)
    entries, counts, _ = pattern.kernel_tiles(tile_q(S))
    rec["bound_ms"] = max(rec["bound_ms"], 4 * (entries.size + counts.size + pattern.bitmap.size)
                          / PEAK_BYTES * 1e3)
    records[rec["name"]] = dict(rec, source="src/repro_torch/csrc/block_sparse_attn.cu",
                                replaces="src/repro/kernels/block_sparse.py:214")
    del q, k, v, band, mask

    # -- flash at hd 256, a short prefill (S < 256 takes flash with the window)
    B, S = 4, 200
    sets = copies_past_l2(lambda: tuple(randn(B, S, H, hd, dtype=torch.bfloat16)
                                        for _ in range(3)), 4 * B * S * H * hd * 2)
    rec = attention_row(
        "flash_attention hd256", f"causal B{B} S{S} H{H} hd{hd} bf16",
        lambda a, b_, c: kf.flash_attention(a, b_, c, causal=True, window=W),
        lambda a, b_, c: kf.flash_attention_plain(a, b_, c, causal=True, window=W),
        lambda a, b_, c: F.scaled_dot_product_attention(a, b_, c, is_causal=True),
        *sets[0], "bfloat16", pairs(S, W), 20, sets=sets)
    records[rec["name"]] = dict(rec, source="src/repro_torch/csrc/flash_attn.cu",
                                replaces="src/repro/kernels/flash_attention.py:120")
    del sets

    # -- flash at hd 64 (whisper-small's decoder self-attention, phase 14)
    B, S, H, hd = (WHISPER_ATTN[k] for k in ("B", "S", "H", "hd"))
    sets = copies_past_l2(lambda: tuple(randn(B, S, H, hd, dtype=torch.bfloat16)
                                        for _ in range(3)), 4 * B * S * H * hd * 2)
    rec = attention_row(
        "flash_attention hd64", f"causal B{B} S{S} H{H} hd{hd} bf16",
        lambda a, b_, c: kf.flash_attention(a, b_, c, causal=True),
        lambda a, b_, c: kf.flash_attention_plain(a, b_, c, causal=True),
        lambda a, b_, c: F.scaled_dot_product_attention(a, b_, c, is_causal=True),
        *sets[0], "bfloat16", pairs(S, None), 20, sets=sets)
    records[rec["name"]] = dict(rec, arch="whisper-small",
                                source="src/repro_torch/csrc/flash_attn.cu",
                                replaces="src/repro/kernels/flash_attention.py:120")
    del sets

    # -- flash at 40 query heads (llama4-scout-17b-a16e's prefill, phase 18)
    B, S, H, hd = (LLAMA4_ATTN[k] for k in ("B", "S", "H", "hd"))
    sets = copies_past_l2(lambda: tuple(randn(B, S, H, hd, dtype=torch.bfloat16)
                                        for _ in range(3)), 4 * B * S * H * hd * 2)
    rec = attention_row(
        "flash_attention H40", f"causal B{B} S{S} H{H} (8 kv heads) hd{hd} bf16",
        lambda a, b_, c: kf.flash_attention(a, b_, c, causal=True),
        lambda a, b_, c: kf.flash_attention_plain(a, b_, c, causal=True),
        lambda a, b_, c: F.scaled_dot_product_attention(a, b_, c, is_causal=True),
        *sets[0], "bfloat16", pairs(S, None), 20, sets=sets)
    records[rec["name"]] = dict(rec, arch=LLAMA4, source="src/repro_torch/csrc/flash_attn.cu",
                                replaces="src/repro/kernels/flash_attention.py:120")
    del sets

    # -- hd 256 corners: ragged lengths, windows, a strided pattern; f32 bodies
    for dt in ("bfloat16", "float32"):
        dtype = getattr(torch, dt)
        for S, window in ((300, None), (333, 50), (64, None)):
            q, k, v = (randn(2, S, 3, 256, dtype=dtype) for _ in range(3))
            out = kf.flash_attention(q, k, v, causal=True, window=window)
            torch.cuda.synchronize()
            slack = None if dt == "float32" else p_rounding_bound(
                lambda v_: kf.flash_attention_plain(q, k, v_, causal=True, window=window), v)
            within_tol(f"flash hd256 B2 S{S} H3 window={window} {dt}", out,
                       kf.flash_attention_plain(q, k, v, causal=True, window=window), dt,
                       failures, slack)
        for pattern in (kbs.BlockSparsePattern.windowed(256, 256, 40, 16, 16),
                        kbs.BlockSparsePattern.strided(512, 512, local_blocks=2, stride=3,
                                                       block_q=64, block_k=64)):
            S = pattern.seq_q
            q, k, v = (randn(2, S, 3, 256, dtype=dtype) for _ in range(3))
            out = kbs.block_sparse_attention(q, k, v, pattern)
            torch.cuda.synchronize()
            slack = None if dt == "float32" else p_rounding_bound(
                lambda v_: kbs.block_sparse_attention_plain(q, k, v_, pattern), v)
            within_tol(f"block_sparse hd256 S{S} blocks {pattern.block_q} {dt}", out,
                       kbs.block_sparse_attention_plain(q, k, v, pattern), dt, failures, slack)

    # -- decode at the zoo's groups and head dims
    for tag, shp in ZOO_DECODE.items():
        B, L, KV, G, hd = (shp[k] for k in ("B", "L", "KV", "G", "hd"))
        idx = torch.arange(L, device=dev)
        if "pos" in shp:  # a linear cache mid-decode
            pos = torch.tensor(shp["pos"], device=dev)
        elif shp["int8_row"]:  # a ring: the second row wraps
            pos = torch.tensor([300, 3 * L + 77, 0, L - 1], device=dev)[:B]
        else:  # serve.py's batch mid-decode: 257 to 271 of 272 rows written
            pos = torch.tensor([263, 270, 256, 271], device=dev)[:B]
        slot = torch.remainder(pos, L)
        age = torch.remainder(slot[:, None] - idx[None, :], L)
        valid = age < torch.clamp(pos + 1, max=L)[:, None]

        def decode_inputs(quant):
            q_ = randn(B, KV, G, hd, dtype=torch.bfloat16)
            k_, v_ = (randn(B, L, KV, hd, dtype=torch.bfloat16) for _ in range(2))
            if not quant:
                return (q_, k_, v_, valid, None, None)
            (kq, ks), (vq, vs) = quantize_kv_ref(k_), quantize_kv_ref(v_)
            return (q_, kq, vq, valid, ks, vs)

        for counter, quant in (("decode_attention", False), ("decode_attention_int8", True)):
            rec = decode_row(f"{counter} {tag}", B, L, KV, G, hd, valid, quant,
                             lambda: decode_inputs(quant), failures)
            if shp["int8_row"] or not quant:
                records[rec["name"]] = dict(rec, counter=counter, arch=shp["arch"])

    # -- decode edge cases at the new groups and head dims
    cases = {"all-masked row": (3, 200, 1, 48, 128), "single live row": (3, 300, 1, 10, 256),
             "L=37": (3, 37, 2, 12, 64), "L=1000": (3, 1000, 1, 48, 128),
             "L=2047": (3, 2047, 1, 10, 256), "G=64": (2, 500, 2, 64, 256),
             "G=9": (3, 260, 2, 9, 128), "G=1 hd256": (3, 130, 4, 1, 256),
             "G=3": (3, 300, 2, 3, 128), "G=17 hd64": (3, 200, 2, 17, 64),
             "G=33": (2, 700, 1, 33, 256)}
    for case, (B, L, KV, G, hd) in cases.items():
        pos = torch.tensor([17, 3 * L + 5, L // 2][:B], device=dev)
        slot = torch.remainder(pos, L)
        age = torch.remainder(slot[:, None] - torch.arange(L, device=dev)[None], L)
        valid = age < torch.clamp(pos + 1, max=L)[:, None]
        if case == "all-masked row":
            valid[1] = False
        if case == "single live row":
            valid[:] = False
            valid[0, 5] = valid[1, L - 1] = valid[2, L // 2] = True
        for dt in ("bfloat16", "float32", "int8"):
            ftype = torch.float32 if dt == "int8" else getattr(torch, dt)
            q, k, v = (torch.randn(*s_, generator=gen, device=dev).to(ftype)
                       for s_ in ((B, KV, G, hd), (B, L, KV, hd), (B, L, KV, hd)))
            kw = {}
            if dt == "int8":
                (k, ks), (v, vs) = quantize_kv_ref(k), quantize_kv_ref(v)
                kw = dict(k_scale=ks, v_scale=vs)
            out = kd.decode_attention(q, k, v, valid, **kw)
            torch.cuda.synchronize()
            within_tol(f"decode wide {case} B{B} L{L} KV{KV} G{G} hd{hd} {dt} "
                       f"(chunks of {kd.split_plan(B, KV, L, G)[0]})", out,
                       kd.decode_attention_plain(q, k, v, valid, **kw),
                       "float32" if ftype == torch.float32 else dt, failures)
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError(f"kernels disagree with their plain versions at the zoo's shapes: "
                             f"{failures}")
    return records


# ------------------------------------------------------------ --turns
# the decode rows that --turns times: (B, L, KV, G, hd, positions, int8 too);
# positions -1 mean "the last slot" (a full linear cache) and a ring wraps
# past L
TURN_DECODE = {
    "G2 hd128 (qwen3-1.7b)": (4, 1024, 8, 2, 128, (300, 1500, 0, 1023), True),
    "G3 hd128": (4, 272, 8, 3, 128, (263, 270, 256, 271), False),
    "G4 hd128 (qwen3-4b)": (4, 272, 8, 4, 128, (263, 270, 256, 271), False),
    "G8 hd128 (command-r-35b)": (2, 272, 8, 8, 128, (263, 270), False),
    "G16 hd128": (4, 1024, 2, 16, 128, (300, 1500, 0, 1023), False),
    "G48 hd128 (granite-20b)": (4, 1024, 1, 48, 128, (300, 3 * 1024 + 77, 0, 1023), True),
    "G10 hd256 (recurrentgemma-2b)": (4, 2048, 1, 10, 256, (300, 3 * 2048 + 77, 0, 2047), True),
}


def time_rows(dev) -> dict[str, dict]:
    """Device ms (``torch.profiler``) and per-call ms (CUDA events) of the
    attention and decode rows of PERF.md's kernel table, on whichever tree's
    ``repro_torch`` this process imported, with SDPA's device ms beside each
    row that has one and each row's bound (no correctness check: phase 2
    makes those)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import block_sparse as kbs
    from repro_torch.kernels import decode as kd
    from repro_torch.kernels import sliding_window as ksw
    from repro_torch.kernels.ref import block_sparse_mask, quantize_kv_ref
    kf = importlib.import_module("repro_torch.kernels.flash_attention")  # not the wrapper

    gen = torch.Generator(device=dev).manual_seed(23)
    rows: dict[str, dict] = {}

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)

    def row(name, fn, lib, sets, tsets, flops, nbytes, reps):
        b_ms, by = bound(flops, nbytes, "bfloat16")
        rows[name] = dict(device_ms=device_ms(fn, sets, reps), ms=time_ms(fn, sets, reps),
                          library_device_ms=None if lib is None else device_ms(lib, tsets, reps),
                          bound_ms=b_ms, bound_by=by)
        torch.cuda.synchronize()

    def pairs(S, window):
        return sum(min(i + 1, window or S) for i in range(S))

    def heads_first(sets):
        return [tuple(t.transpose(1, 2).contiguous() for t in s_) for s_ in sets]

    for B, S, H, hd, W in ((4, 512, 16, 128, None), (4, 200, 10, 256, 2048)):
        nbytes = 4 * B * S * H * hd * 2
        sets = copies_past_l2(lambda: tuple(randn(B, S, H, hd) for _ in range(3)), nbytes)
        row(f"flash causal B{B} S{S} H{H} hd{hd}",
            lambda a, b_, c, W=W: kf.flash_attention(a, b_, c, causal=True, window=W),
            lambda a, b_, c: F.scaled_dot_product_attention(a, b_, c, is_causal=True),
            sets, heads_first(sets), 4 * B * H * hd * pairs(S, W), nbytes, 20)
    S = 8448
    for H, hd, W in ((16, 128, 8192), (10, 256, 2048)):
        sets = [tuple(randn(1, S, H, hd) for _ in range(3))]
        qpos = torch.arange(S, device=dev)
        band = (qpos[:, None] >= qpos[None, :]) & (qpos[:, None] - qpos[None, :] < W)
        row(f"sliding window B1 S{S} H{H} hd{hd} window {W}",
            lambda a, b_, c, W=W: ksw.sliding_window_attention(a, b_, c, window=W),
            lambda a, b_, c, m=band: F.scaled_dot_product_attention(a, b_, c, attn_mask=m),
            sets, heads_first(sets), 4 * H * hd * pairs(S, W), 4 * S * H * hd * 2, 5)
        pattern = kbs.BlockSparsePattern.windowed(S, S, W, 128, 128)
        mask = block_sparse_mask(pattern, dev)
        row(f"block_sparse windowed B1 S{S} H{H} hd{hd} window {W}",
            lambda a, b_, c, p=pattern: kbs.block_sparse_attention(a, b_, c, p),
            lambda a, b_, c, m=mask: F.scaled_dot_product_attention(a, b_, c, attn_mask=m),
            sets, heads_first(sets), 4 * H * hd * int(mask.sum()), 4 * S * H * hd * 2, 5)
        del sets, band, mask
    B, S, H, hd = 4, 512, 16, 128
    pattern = kbs.BlockSparsePattern.causal_pattern(S, S, 128, 128)
    mask = block_sparse_mask(pattern, dev)
    nbytes = 4 * B * S * H * hd * 2
    sets = copies_past_l2(lambda: tuple(randn(B, S, H, hd) for _ in range(3)), nbytes)
    row(f"block_sparse causal B{B} S{S} H{H} hd{hd}",
        lambda a, b_, c: kbs.block_sparse_attention(a, b_, c, pattern),
        lambda a, b_, c: F.scaled_dot_product_attention(a, b_, c, attn_mask=mask),
        sets, heads_first(sets), 4 * B * H * hd * int(mask.sum()), nbytes, 20)
    del sets, mask

    for tag, (B, L, KV, G, hd, pos, int8_too) in TURN_DECODE.items():
        slot = torch.remainder(torch.tensor(pos, device=dev), L)
        age = torch.remainder(slot[:, None] - torch.arange(L, device=dev)[None], L)
        valid = age < torch.clamp(torch.tensor(pos, device=dev) + 1, max=L)[:, None]
        n_valid = int(valid.sum())
        for quant in (False, True) if int8_too else (False,):
            def make():
                q, k, v = randn(B, KV, G, hd), randn(B, L, KV, hd), randn(B, L, KV, hd)
                if not quant:
                    return (q, k, v, valid, None, None)
                (kq, ks), (vq, vs) = quantize_kv_ref(k), quantize_kv_ref(v)
                return (q, kq, vq, valid, ks, vs)

            nbytes = (2 * n_valid * KV * hd * (1 if quant else 2) + 2 * B * KV * G * hd * 2
                      + B * L + (2 * n_valid * KV * 4 if quant else 0))
            sets = copies_past_l2(make, nbytes)
            tsets = None if quant else [
                (a[0].reshape(B, KV * G, 1, hd), a[1].transpose(1, 2).contiguous(),
                 a[2].transpose(1, 2).contiguous(), a[3][:, None, None, :]) for a in sets]
            row(f"decode {tag} {'int8' if quant else 'bf16'} B{B} L{L} KV{KV}, {n_valid} live rows",
                lambda q, k, v, vl, ks, vs: kd.decode_attention(q, k, v, vl, k_scale=ks,
                                                                  v_scale=vs),
                None if quant else lambda q, k, v, m: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=m, enable_gqa=True),
                sets, tsets, 4 * n_valid * KV * G * hd, nbytes, 50)
            del sets, tsets
    return rows


def turns(parent: Path) -> None:
    """The rows of ``time_rows`` for the tree at ``parent`` and for this one
    in turns (parent, this, this, parent), each turn a process of its own
    that imports its tree's ``repro_torch`` and builds its kernels; logs
    each row's device ms per turn, SDPA's, the bound and the share of it."""
    runs = []
    for label, root in (("parent", parent), ("change", ROOT), ("change", ROOT),
                        ("parent", parent)):
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"), "--time-rows",
                              str(Path(root).resolve() / "src")],
                             capture_output=True, text=True, timeout=1200)
        if out.returncode != 0:
            raise AssertionError(f"--time-rows on {root} failed:\n{out.stdout[-4000:]}"
                                 f"{out.stderr[-4000:]}")
        runs.append(json.loads(out.stdout.strip().splitlines()[-1]))
        log(f"[turns] {label} ({root}) took {time.perf_counter() - t0:.1f} s")
    for name in runs[0]:
        d = [r[name]["device_ms"] for r in runs]
        c = [r[name]["ms"] for r in runs]
        lib = runs[1][name]["library_device_ms"]
        b_ms = runs[1][name]["bound_ms"]
        change = (d[1] + d[2]) / 2
        log(f"[turns] {name}: device ms parent {d[0]:.4f} / {d[3]:.4f}, change {d[1]:.4f} / "
            f"{d[2]:.4f} ({b_ms / change:.1%} of the bound {b_ms:.4f} ms, "
            f"{runs[1][name]['bound_by']}); per call parent {c[0]:.4f} / {c[3]:.4f}, change "
            f"{c[1]:.4f} / {c[2]:.4f}; SDPA device "
            + ("none" if lib is None else f"{lib:.4f} / {runs[2][name]['library_device_ms']:.4f}"))


# ------------------------------------------------------------ phases 3-6
QWEN = "qwen3-1.7b"
LLAMA4 = "llama4-scout-17b-a16e"
# phase 3 bounds (bf16 at full width, random weights, 28 layers): the
# kernels accumulate in f32 where the plain path rounds scores and
# probabilities to bf16, so logits differ by bf16 noise, not by algorithm
LOGIT_REL_BOUND = 0.05
GREEDY_AGREE_BOUND = 0.75


def logits_vs_plain(label, a, b, check: bool = True) -> None:
    """Kernel-path logits ``a`` against the plain path's ``b`` (float32,
    positions along the first axes, vocab last): rel L2 and greedy agreement
    within the model bounds, or raise (``check=False``: log only)."""
    import torch

    if not bool(torch.isfinite(a).all()):
        raise AssertionError(f"{label}: non-finite logits on the kernel path")
    rel = float((a - b).norm() / b.norm())
    agree = float((a.argmax(-1) == b.argmax(-1)).float().mean())
    bounds = (f" (bound {LOGIT_REL_BOUND})", f" (bound >= {GREEDY_AGREE_BOUND})") if check else (
        " (not a check)", "")
    log(f"{label}: logits rel L2 error kernel vs plain {rel:.3e}{bounds[0]}, "
        f"greedy agreement {agree:.3f}{bounds[1]}")
    if check and (rel > LOGIT_REL_BOUND or agree < GREEDY_AGREE_BOUND):
        raise AssertionError(f"{label}: kernel path disagrees with the plain path at full width")


class RoutingPin:
    """Pins a MoE model's routing from one run to the next.  ``record()``
    keeps the expert ids each router call picks; ``replay()`` makes the
    calls of a later run, in the same order, take those ids (gates from that
    run's own probabilities, renormalised over them) and counts the tokens
    whose experts its own router would have changed.  With random weights
    many tokens' k-th and (k+1)-th experts lie within a bf16 step of each
    other, so a rounding difference between two attention paths moves
    tokens to other experts, and the logits apart by far more than the
    attention paths differ; pinned, two runs differ by their attention
    alone.  No-op for models without MoE layers."""

    def __init__(self):
        self.ids: list = []
        self.moved = self.tokens = 0

    @staticmethod
    @contextlib.contextmanager
    def _patched(select):
        from repro_torch.models import moe

        real = moe.select
        moe.select = lambda params, x, cfg: select(real, params, x, cfg)
        try:
            yield
        finally:
            moe.select = real

    def record(self):
        self.ids = []

        def select(real, params, x, cfg):
            out = real(params, x, cfg)
            self.ids.append(out[2])
            return out

        return self._patched(select)

    @contextlib.contextmanager
    def replay(self):
        import torch

        calls = iter(self.ids)
        self.moved = self.tokens = 0

        def select(real, params, x, cfg):
            probs, _, own = real(params, x, cfg)
            idx = next(calls, None)
            if idx is None or idx.shape != own.shape:
                raise AssertionError("routing pin: the runs' router calls differ")
            self.moved += int((idx.sort(-1).values != own.sort(-1).values).any(-1).sum())
            self.tokens += own.shape[0] * own.shape[1]
            gates = torch.gather(probs, -1, idx)
            return probs, gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9), idx

        with self._patched(select):
            yield
        if next(calls, None) is not None:
            raise AssertionError("routing pin: the replayed run made fewer router calls")

    def note(self) -> str:
        return (f" (MoE routing pinned to the first run's: its own router would have moved "
                f"{self.moved} of {self.tokens} token-layers)" if self.ids else "")


def prefill_decode_vs_plain(tag, cfg, params, dev, knobs, B=4, S=200, steps=16,
                            cache_len=256) -> None:
    """Prefill B x S + ``steps`` decode steps with each attention knob of
    ``knobs`` (an ``attn_kernel`` name, or a label and its config overrides)
    against the plain attention path (``attn_kernel=None``), teacher-forced
    on the first knob's greedy tokens.  Whisper's ``frames`` and internvl2's
    ``patches`` are serve.py's stubs, drawn after the tokens.  A MoE model's
    routing is pinned to the first knob's run (``RoutingPin``); its plain
    run with free routing is logged beside, not checked."""
    import torch

    from repro_torch.launch.serve import stub_inputs
    from repro_torch.models import transformer as T

    gen = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device=dev)
    batch = {"tokens": tokens, **stub_inputs(cfg, B, gen, dev)}
    overrides = dict((k, {"attn_kernel": k}) if isinstance(k, str) else k for k in knobs)
    labels = list(overrides)

    def run(over, feed):
        c = dataclasses.replace(cfg, **over)
        logits, cache = T.prefill(params, batch, c, cache_len)
        outs = [logits[:, -1].float()]
        greedy = [torch.argmax(outs[-1], -1)]
        for i in range(steps):
            tok = (feed[i] if feed is not None else greedy[-1])[:, None]
            logits, cache = T.decode_step(params, tok, cache, S + i, c)
            outs.append(logits[:, 0].float())
            greedy.append(torch.argmax(outs[-1], -1))
        torch.cuda.synchronize()
        return torch.stack(outs), greedy

    pin = RoutingPin()
    with pin.record():
        first, feed = run(overrides[labels[0]], None)
    runs, notes = {labels[0]: first}, {}
    for label in labels[1:]:
        with pin.replay():
            runs[label] = run(overrides[label], feed)[0]
        notes[label] = pin.note()
    with pin.replay():
        plain = run({}, feed)[0]
    plain_note = f"; plain{pin.note()}" if pin.ids else ""
    for label in labels:
        logits_vs_plain(f"{tag} {label}: prefill {B}x{S} + {steps} decode steps"
                        f"{notes.get(label, '')}{plain_note}", runs[label], plain)
    if pin.ids:  # the plain path routed by its own router: for the record
        logits_vs_plain(f"{tag} {labels[0]}: the same against the plain path with its own "
                        f"routing", first, run({}, feed)[0], check=False)
    del runs, first, plain
    torch.cuda.empty_cache()


def model_vs_plain(dev) -> None:
    """Full-width qwen3-1.7b: prefill + 16 decode steps with the flash and
    the block-sparse kernels against the plain attention path, teacher-forced
    on the flash path's greedy tokens."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    cfg = get_config(QWEN)
    params = T.init_model(cfg, seed=0, device=dev)
    log(f"[3] {QWEN}: {T.param_count(cfg) / 1e9:.3f} B parameters in {cfg.dtype}, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    # S = 200: block-sparse blocks of 8
    prefill_decode_vs_plain("[3]", cfg, params, dev, ("flash", "block_sparse"))
    del params
    torch.cuda.empty_cache()


def run_engine(label, cfg, params, dev, prompts, new_tokens, **engine_kw):
    """Serve ``prompts`` through ServeEngine; returns (requests, seconds, ticks,
    engine)."""
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
    return reqs, secs, ticks, engine


def long_logits_vs_plain(cfg, params, prompt, dev, cache_len: int, steps: int = 16,
                         knob: str = "block_sparse", tag: str = "[5]") -> None:
    """A long prompt through the model: the ``knob`` prefill (windowed) +
    ``steps`` decode steps against the plain path (teacher-forced on the
    kernel path's greedy tokens), over every prompt position.  The plain
    path chunks queries by 1024 beyond 4096 tokens (as the reference's), so
    a longer prompt is a multiple of 1024."""
    import torch

    from repro_torch.models import transformer as T

    tokens = torch.tensor([prompt], device=dev)
    runs = {}
    for k in (knob, None):
        c = dataclasses.replace(cfg, attn_kernel=k)
        logits, cache = T.prefill(params, {"tokens": tokens}, c, cache_len)
        outs = [logits[0]]
        feed = runs[knob][1] if k is None else None
        greedy = [torch.argmax(logits[:, -1:], -1)]
        for i in range(steps):
            tok = feed[i] if feed is not None else greedy[-1]
            logits, cache = T.decode_step(params, tok, cache, len(prompt) + i, c)
            outs.append(logits[0])
            greedy.append(torch.argmax(logits, -1))
        runs[k] = (torch.cat(outs).float(), greedy)
        del cache, logits
    window = cfg.sliding_window if "local_attn" in cfg.layer_pattern else cfg.long_context_window
    logits_vs_plain(f"{tag} {knob}: {len(prompt)}-token prefill (window {window}) + {steps} "
                    f"decode steps", runs[knob][0], runs[None][0])
    del runs
    torch.cuda.empty_cache()


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
        return out, counts

    def first_tokens_agree(name, reqs, plain):
        firsts = sum(a.output[0] == b.output[0] for a, b in zip(reqs, plain))
        same = sum(a.output == b.output for a, b in zip(reqs, plain))
        log(f"[4] {name}: first tokens equal to the plain engine's: {firsts}/8; whole outputs: "
            f"{same}/8 (bound: first tokens >= 6/8)")
        if firsts < 6:
            raise AssertionError(f"{name} engine disagrees with the plain engine")

    def every_prefill(phase, sparse, prefills):
        """The block-sparse run launched its kernel once per layer and prefill."""
        want = cfg.num_layers * prefills
        log(f"[{phase}] block_sparse_attention launches {sparse} = {cfg.num_layers} layers x "
            f"{prefills} prefills: {sparse == want}")
        if sparse != want:
            raise AssertionError(f"phase {phase}: block-sparse launches {sparse} != {want}")

    cfg = dataclasses.replace(get_config(QWEN), attn_kernel="flash")
    bcfg = dataclasses.replace(cfg, attn_kernel="block_sparse")
    params = T.init_model(cfg, seed=0, device=dev)
    rng = random.Random(0)
    lens = [17, 600, 130, 333, 17, 480, 64, 251]
    pool = {}
    prompts = [pool.setdefault(n, [rng.randrange(cfg.vocab_size) for _ in range(n)])
               for n in lens]  # the repeated 17-token prompt hits the prefix cache
    engine_kw = dict(max_slots=4, cache_len=1024, prompt_bucket=32)

    log("[4] ServeEngine at full width: 8 requests, prompts 17-600 tokens, 16 new tokens each")
    plain, *_ = run_engine("plain attention (reference)",
                             dataclasses.replace(cfg, attn_kernel=None), params, dev, prompts, 16,
                             **engine_kw)
    (kern, *_), fc = counted(4, ("flash_attention", "decode_attention"), lambda: run_engine(
        "kernels, bf16 KV", cfg, params, dev, prompts, 16, **engine_kw))
    first_tokens_agree("flash", kern, plain)
    qcfg = dataclasses.replace(cfg, quantized_kv=True)
    (qreqs, *_), _ = counted(4, ("flash_attention", "decode_attention_int8"), lambda: run_engine(
        "kernels, int8 KV", qcfg, params, dev, prompts, 16, **engine_kw))
    log(f"[4] int8-KV first tokens equal to bf16-KV's: "
        f"{sum(a.output[0] == b.output[0] for a, b in zip(qreqs, kern))}/8")
    (sreqs, *_), sc = counted(4, ("block_sparse_attention", "decode_attention"),
                                lambda: run_engine("block-sparse prefill, bf16 KV", bcfg, params,
                                                   dev, prompts, 16, **engine_kw))
    first_tokens_agree("block_sparse", sreqs, plain)
    # the flash run launched flash once per layer and prefill: same prefills here
    every_prefill(4, sc["block_sparse_attention"], fc["flash_attention"] // cfg.num_layers)
    torch.cuda.empty_cache()

    log("[5] one long-context request: 8448-token prompt, cache_len 8480 (ring of 8192)")
    long_prompt = [rng.randrange(cfg.vocab_size) for _ in range(8448)]
    counted(5, ("sliding_window_attention", "decode_attention"), lambda: run_engine(
        "long context", cfg, params, dev, [long_prompt], 16, max_slots=1, cache_len=8480,
        prompt_bucket=32))
    _, lc = counted(5, ("block_sparse_attention", "decode_attention"), lambda: run_engine(
        "long context, block-sparse prefill", bcfg, params, dev, [long_prompt], 16, max_slots=1,
        cache_len=8480, prompt_bucket=32))
    every_prefill(5, lc["block_sparse_attention"], 1)
    # the plain path takes 9216 tokens, not 8448: the same window and band blocks
    long_logits_vs_plain(cfg, params, [rng.randrange(cfg.vocab_size) for _ in range(9216)],
                         dev, 9248)
    del params
    torch.cuda.empty_cache()

    argv = ["--arch", QWEN, "--batch", "4", "--prompt-len", "256", "--gen", "16"]
    for knob in ("flash", "block_sparse"):
        log(f"[6] launch/serve.py {' '.join(argv)} (attn_kernel={knob!r})")
        metrics, counts = counted(6, (f"{knob}_attention", "decode_attention"), lambda: serve.main(
            argv, config_overrides={"attn_kernel": knob}))
        log(f"[6] {knob}: per-token {metrics['per_token_ms']:.2f} ms, prefill "
            f"{metrics['prefill_seconds']:.3f} s")
        if knob == "block_sparse":
            every_prefill(6, counts["block_sparse_attention"], 1)
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
    dec = [r for r in rows if "decode_split_kernel" in r[1]]
    log(f"[7] decode_attn kernel: {sum(r[0] for r in dec) / 1e3 / steps:.3f} ms/tick, "
        f"{sum(r[2] for r in dec) / steps:g} launches/tick")
    for dev_us, key, count in sorted(rows, reverse=True)[:10]:
        log(f"[7]   {dev_us / 1e3 / steps:8.3f} ms/tick {dev_us / 1e3 / busy_ms:6.1%} "
            f"x{count / steps:<5g} {key[:90]}")
    del params, cache
    torch.cuda.empty_cache()


# --------------------------------------------------- gossip kernels (phase 2)
QWEN_CHUNK_ROWS = 131072  # wq/wo chunk: 4 layers x 2048 x 16 x 128 = 2**24 elements


def _exact(label, a, b, failures) -> float:
    """Integer (or bit-exact float) outputs: equal element for element."""
    import torch

    same = a.shape == b.shape and a.dtype == b.dtype and bool(torch.equal(a, b))
    err = 0.0 if same or not a.is_floating_point() else float((a.float() - b.float()).abs().max())
    log(f"  {label}: {'exactly equal' if same else 'DIFFERENT'}"
        + ("" if same else f" (shapes {tuple(a.shape)}/{tuple(b.shape)}, max err {err:.3e})"))
    if not same:
        failures.append(label)
    return err


def check_gossip_kernels(dev) -> dict:
    """Kernels 5-8 against their plain versions at the trainer's largest
    gossip chunk (qwen3-1.7b wq: 2**24 elements per node, m = 4, bf16)."""
    import torch

    from repro_torch.kernels import choco_fused as kc
    from repro_torch.kernels.ref import encode_scale, f32_full, tau_for
    kq = importlib.import_module("repro_torch.kernels.quantize")  # not the wrapper

    gen = torch.Generator(device=dev).manual_seed(5)
    failures: list[str] = []
    records: dict[str, dict] = {}
    R, L, m = QWEN_CHUNK_ROWS, 128, 4
    n = R * L

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device=dev, dtype=torch.float32).to(dtype)

    def rand(*shape):
        return torch.rand(*shape, generator=gen, device=dev, dtype=torch.float32)

    # -- quantize / dequantize: one node's chunk [R, 128] f32
    for bits in (4, 8, 1):
        x, xi = randn(R, L), rand(R, L)
        norm = torch.linalg.vector_norm(x).reshape(1)
        lvl, sign = kq.quantize(x, xi, norm, bits)
        plvl, psign = kq.quantize_plain(x, xi, norm, bits)
        _exact(f"quantize bits={bits} [{R},{L}] levels", lvl, plvl, failures)
        _exact(f"quantize bits={bits} [{R},{L}] signs", sign, psign, failures)
        scale = norm / f32_full(norm, (1 << bits) * tau_for(n, bits))
        out = kq.dequantize(lvl, sign, scale, bits)
        dq_err = _exact(f"dequantize bits={bits} [{R},{L}]", out,
                        kq.dequantize_plain(lvl, sign, scale, bits), failures)
        if bits != 4:
            continue
        make = lambda: (randn(R, L), rand(R, L), norm)
        sets = copies_past_l2(make, n * 8)
        qfn = lambda a, b_, c: kq.quantize(a, b_, c, 4)
        ms = time_ms(qfn, sets, 20)
        plain_ms = time_ms(lambda a, b_, c: kq.quantize_plain(a, b_, c, 4), sets, 5)
        b_ms, b_by = bound(6 * n, n * (8 + 5 / 8), "float32")
        records["quantize"] = dict(
            name="quantize", route="cuda", source="src/repro_torch/csrc/quantize.cu",
            replaces="src/repro/kernels/quantize.py:80", max_abs_err=0.0, ms=ms,
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
            device_ms=device_ms(qfn, sets, 20), shape=f"[{R},{L}] f32, 4 bits")
        dsets = [kq.quantize(*a, 4) + (scale,) for a in sets]
        dfn = lambda a, b_, c: kq.dequantize(a, b_, c, 4)
        ms = time_ms(dfn, dsets, 20)
        plain_ms = time_ms(lambda a, b_, c: kq.dequantize_plain(a, b_, c, 4), dsets, 5)
        b_ms, b_by = bound(2 * n, n * (5 / 8 + 4), "float32")
        records["dequantize"] = dict(
            name="dequantize", route="cuda", source="src/repro_torch/csrc/quantize.cu",
            replaces="src/repro/kernels/quantize.py:110", max_abs_err=dq_err, ms=ms,
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
            device_ms=device_ms(dfn, dsets, 20), shape=f"[{R},{L}] u8 payload -> f32, 4 bits")
        del sets, dsets

    # -- fused encode: [m, R, 128] bf16, with and without the digest
    def enc_inputs(dtype=torch.bfloat16, bits=4):
        tn, hat = randn(m, R, L, dtype=dtype), randn(m, R, L, dtype=dtype)
        norms = torch.linalg.vector_norm((tn - hat).float().reshape(m, -1), dim=1)
        scales = torch.stack([encode_scale(norms, bits),
                              norms / f32_full(norms, (1 << bits) * tau_for(n, bits))], 1)
        return tn, hat, rand(m, R, L), scales

    args = enc_inputs()
    for digest in (False, True):
        out = kc.fused_encode(*args, 4, with_digest=digest)
        ref = kc.fused_encode_plain(*args, 4, with_digest=digest)
        tag = f"fused_encode{' +digest' if digest else ''} [{m},{R},{L}] bf16"
        for part, a, b in zip(("levels", "signs", "hat_new", "digest"), out, ref):
            _exact(f"{tag} {part}", a, b, failures)
    # round trip: the fused pass's payload is quantize's, and (f32, hat = 0)
    # its hat_new - hat is dequantize(quantize(resid))
    tn, hat, xi, scales = args
    resid = (tn - hat).float()
    norms = torch.linalg.vector_norm(resid.reshape(m, -1), dim=1)
    lvl, sign, _ = kc.fused_encode(tn, hat, xi, scales, 4)
    for i in (0, m - 1):
        ql, qs = kq.quantize(resid[i], xi[i], norms[i], 4)
        _exact(f"round trip node {i}: quantize(resid) levels == fused_encode levels", ql, lvl[i],
               failures)
        _exact(f"round trip node {i}: quantize(resid) signs == fused_encode signs", qs, sign[i],
               failures)
    tn32, zeros = tn.float(), torch.zeros(m, R, L, device=dev)
    norms32 = torch.linalg.vector_norm(tn32.reshape(m, -1), dim=1)
    sc32 = torch.stack([encode_scale(norms32, 4),
                        norms32 / f32_full(norms32, 16 * tau_for(n, 4))], 1)
    l32, s32, h32 = kc.fused_encode(tn32, zeros, xi, sc32, 4)
    for i in (0, m - 1):
        ql, qs = kq.quantize(tn32[i], xi[i], norms32[i], 4)
        _exact(f"round trip node {i} f32: dequantize(quantize(x)) == hat_new - hat",
               kq.dequantize(ql, qs, sc32[i, 1], 4), h32[i] - zeros[i], failures)
    del tn32, zeros, l32, s32, h32, resid
    sets = copies_past_l2(enc_inputs, m * n * 8)
    efn = lambda a, b_, c, d: kc.fused_encode(a, b_, c, d, 4)
    ms = time_ms(efn, sets, 10)
    plain_ms = time_ms(lambda a, b_, c, d: kc.fused_encode_plain(a, b_, c, d, 4), sets, 3)
    b_ms, b_by = bound(8 * m * n, m * n * (2 + 2 + 4 + 2 + 5 / 8), "float32")
    records["fused_encode"] = dict(
        name="fused_encode", route="cuda", source="src/repro_torch/csrc/choco_fused.cu",
        replaces="src/repro/kernels/choco_fused.py:165", max_abs_err=0.0, ms=ms,
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
        device_ms=device_ms(efn, sets, 10), shape=f"[{m},{R},{L}] bf16, 4 bits")
    del sets, args

    # -- the digest variant at the faulted round's shape: 3 nodes (phase 16a)
    m3 = 3

    def enc3():
        tn, hat = randn(m3, R, L, dtype=torch.bfloat16), randn(m3, R, L, dtype=torch.bfloat16)
        norms = torch.linalg.vector_norm((tn - hat).float().reshape(m3, -1), dim=1)
        scales = torch.stack([encode_scale(norms, 4),
                              norms / f32_full(norms, 16 * tau_for(n, 4))], 1)
        return tn, hat, rand(m3, R, L), scales

    args3 = enc3()
    out = kc.fused_encode(*args3, 4, with_digest=True)
    ref = kc.fused_encode_plain(*args3, 4, with_digest=True)
    for part, a, b in zip(("levels", "signs", "hat_new", "digest"), out, ref):
        _exact(f"fused_encode_digest [{m3},{R},{L}] bf16 {part}", a, b, failures)
    from repro_torch.core.faults import digest as wire_digest

    _exact(f"fused_encode_digest [{m3},{R},{L}] digest == core.faults.digest(hat_new)",
           out[3], wire_digest(out[2]), failures)
    # 8 bits and an odd number of 8-row groups per node: a block of the
    # digest's reduction straddles two nodes
    for dt in (torch.bfloat16, torch.float32):
        tn, hat = randn(m3, 40, L, dtype=dt), randn(m3, 40, L, dtype=dt)
        norms = torch.linalg.vector_norm((tn - hat).float().reshape(m3, -1), dim=1)
        sc = torch.stack([encode_scale(norms, 8),
                          norms / f32_full(norms, 256 * tau_for(40 * L, 8))], 1)
        small = (tn, hat, rand(m3, 40, L), sc)
        for part, a, b in zip(("levels", "signs", "hat_new", "digest"),
                              kc.fused_encode(*small, 8, with_digest=True),
                              kc.fused_encode_plain(*small, 8, with_digest=True)):
            _exact(f"fused_encode_digest [{m3},40,{L}] {dt} 8 bits {part}", a, b, failures)
    sets = copies_past_l2(enc3, m3 * n * 8)
    dfn = lambda a, b_, c, d: kc.fused_encode(a, b_, c, d, 4, with_digest=True)
    ms = time_ms(dfn, sets, 10)
    plain_ms = time_ms(lambda a, b_, c, d: kc.fused_encode_plain(a, b_, c, d, 4, True), sets, 3)
    # the encode's traffic, plus one integer add per element for the digest
    b_ms, b_by = bound(9 * m3 * n, m3 * n * (2 + 2 + 4 + 2 + 5 / 8) + 4 * m3, "float32")
    records["fused_encode_digest"] = dict(
        name="fused_encode_digest", route="cuda", source="src/repro_torch/csrc/choco_fused.cu",
        replaces="src/repro/kernels/choco_fused.py:165", max_abs_err=0.0, ms=ms,
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
        device_ms=device_ms(dfn, sets, 10), shape=f"[{m3},{R},{L}] bf16, 4 bits, +digest")
    del sets, args3, out, ref

    # -- fused mix: K = 3 ring shifts (the round's launch reads the unrolled
    # payload with node offsets), K = 8 through the rolled signature
    def mix_inputs(K):
        lvl = torch.randint(0, 256, (m, R // 2, L), generator=gen, device=dev,
                            dtype=torch.int32).to(torch.uint8)
        sign = torch.randint(0, 256, (m, R // 8, L), generator=gen, device=dev,
                             dtype=torch.int32).to(torch.uint8)
        return lvl, sign, randn(m, R, L), rand(K, m) * 1e-3

    ring = [0, 1, -1]
    lvl, sign, s0, ws = mix_inputs(3)
    rl = torch.stack([torch.roll(lvl, sh, 0) for sh in ring])
    rs = torch.stack([torch.roll(sign, sh, 0) for sh in ring])
    want = kc.fused_mix_plain(rl, rs, s0, ws, 4)
    mix_err = _exact(f"fused_mix K=3 rolled [{m},{R},{L}] f32", kc.fused_mix(rl, rs, s0, ws, 4),
                     want, failures)
    _exact(f"fused_mix K=3 unrolled with node offsets [{m},{R},{L}] f32",
           kc.fused_mix_shifted(lvl, sign, s0.clone(), ws, ring, 4), want, failures)
    _exact(f"fused_mix K=3 [{m},{R},{L}] bf16 s",
           kc.fused_mix(rl, rs, s0.to(torch.bfloat16), ws, 4),
           kc.fused_mix_plain(rl, rs, s0.to(torch.bfloat16), ws, 4), failures)
    del rl, rs, want
    shifts8 = list(range(8))
    lvl8, sign8, s8, ws8 = mix_inputs(8)
    rl8 = torch.stack([torch.roll(lvl8, sh % m, 0) for sh in shifts8])
    rs8 = torch.stack([torch.roll(sign8, sh % m, 0) for sh in shifts8])
    _exact(f"fused_mix K=8 rolled [{m},{R},{L}] f32", kc.fused_mix(rl8, rs8, s8, ws8, 4),
           kc.fused_mix_plain(rl8, rs8, s8, ws8, 4), failures)
    del rl8, rs8, lvl8, sign8, s8, ws8
    sets = copies_past_l2(lambda: mix_inputs(3), m * n * 8)
    mfn = lambda a, b_, c, d: kc.fused_mix_shifted(a, b_, c, d, ring, 4)
    ms = time_ms(mfn, sets, 10)

    def plain_mix(a, b_, c, d):
        rl_ = torch.stack([torch.roll(a, sh, 0) for sh in ring])
        rs_ = torch.stack([torch.roll(b_, sh, 0) for sh in ring])
        return kc.fused_mix_plain(rl_, rs_, c, d, 4)

    plain_ms = time_ms(plain_mix, sets, 3)
    b_ms, b_by = bound(2 * 3 * m * n, m * n * (3 * 5 / 8 + 4 + 4), "float32")
    records["fused_mix"] = dict(
        name="fused_mix", route="cuda", source="src/repro_torch/csrc/choco_fused.cu",
        replaces="src/repro/kernels/choco_fused.py:228", max_abs_err=mix_err, ms=ms,
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
        device_ms=device_ms(mfn, sets, 10), shape=f"[{m},{R},{L}] f32 s, K=3 ring shifts, 4 bits")
    del sets
    torch.cuda.synchronize()
    for r in records.values():
        log(f"  time {r['name']} [{r['shape']}]: kernel {r['ms']:.4f} ms per call "
            f"({r['bound_ms'] / r['ms']:.1%} of the bound), device {r['device_ms']:.4f} ms "
            f"({r['bound_ms'] / r['device_ms']:.1%} of the bound), plain {r['plain_ms']:.4f} ms, "
            f"library none, bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError(f"gossip kernels disagree with their plain versions: {failures}")
    return records


def check_moe_dispatch(dev) -> dict:
    """The MoE dispatch kernels against their plain versions, bit for bit,
    and against autograd's pad-row gather they replace, at deepseek-moe-16b's
    B4 x S2048 node (T 8192, E 64, C 960, K 6, d 2048, bf16; a random
    router): the forward equal, the gradient's gap in bf16 steps; the time
    of a forward and a backward, against the plain versions and the gather."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import moe_dispatch as kmd
    from repro_torch.models import moe

    cfg = get_config("deepseek-moe-16b")
    gen = torch.Generator(device=dev).manual_seed(9)
    T, d, bf = 8192, cfg.d_model, torch.bfloat16
    failures: list[str] = []

    def make_x():
        return torch.randn(1, T, d, generator=gen, device=dev).to(bf)

    x = make_x()
    router = torch.randn(d, cfg.num_experts, generator=gen, device=dev) * d**-0.5
    r = moe.route({"router": router}, x, cfg)
    src, slots, kept = r["src_tok"], r["slot_by_expert"], r["kept_by_expert"]
    E, C = src.shape[1:]
    K = slots.shape[-1]
    eb = kmd.dispatch(x, src)
    _exact(f"moe_dispatch [1,{T},{d}] -> [{E},{C},{d}] bf16", eb, kmd.moe_dispatch_plain(x, src),
           failures)
    grad = torch.randn(eb.shape, generator=gen, device=dev).to(bf)
    gx = kmd.dispatch_backward(grad, slots, kept)
    _exact(f"moe_dispatch_backward [{E},{C},{d}] -> [1,{T},{d}] bf16", gx,
           kmd.moe_dispatch_backward_plain(grad, slots, kept), failures)

    def gather(xr, g):  # the dispatch before the kernels (autograd), forward and backward
        xr.grad = None
        kmd.moe_dispatch_plain(xr, src).backward(g)

    xr = x.clone().requires_grad_()
    gather(xr, grad)
    old = xr.grad
    a, b = gx.float(), old.float()

    def steps(ref):  # one bf16 step (ulp) at |ref|
        return torch.exp2(torch.floor(torch.log2(ref.abs().clamp_min(1e-30))) - 7)

    gap = (a - b).abs()
    mass = kmd.moe_dispatch_backward_plain(grad.float().abs(), slots, kept)
    log(f"  gradient against autograd's index_put_ backward of the gather: bit-equal "
        f"{bool(torch.equal(gx, old))}; {int((gap > 0).sum())} of {gap.numel()} elements "
        f"differ, the largest by {float((gap / steps(torch.maximum(a.abs(), b.abs()))).max()):.0f} "
        f"bf16 steps of the larger value, {float((gap / steps(mass)).max()):.2f} of the sum of "
        f"|g_k| (kept slots {int(kept.sum())}, empty {int((src == T).sum())}, dropped "
        f"{int((~kept).sum())})")
    del xr, old, a, b, gap, mass

    n_kept = int(kept.sum())
    fwd_bytes = n_kept * d * 2 + E * C * d * 2 + E * C * 8
    bwd_bytes = n_kept * d * 2 + T * d * 2 + T * K * 9
    b_ms, b_by = bound(n_kept * d, fwd_bytes + bwd_bytes, "bfloat16")
    sets = [(make_x(), grad) for _ in range(4)]  # x 32 MB a copy; grad 252 MB

    def kernels(xs, g):
        kmd.dispatch(xs, src)
        kmd.dispatch_backward(g, slots, kept)

    def plain(xs, g):
        kmd.moe_dispatch_plain(xs, src)
        kmd.moe_dispatch_backward_plain(g, slots, kept)

    lib_sets = [(xs.clone().requires_grad_(), g) for xs, g in sets]
    fwd_ms = time_ms(lambda xs, g: kmd.dispatch(xs, src), sets, 20)
    bwd_ms = time_ms(lambda xs, g: kmd.dispatch_backward(g, slots, kept), sets, 20)
    rec = dict(
        name="moe_dispatch", route="cuda", source="src/repro_torch/csrc/moe_dispatch.cu",
        replaces="none (the reference's XLA gather)", max_abs_err=0.0, ms=fwd_ms + bwd_ms,
        plain_ms=time_ms(plain, sets, 5), bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(gather, lib_sets, 5), device_ms=device_ms(kernels, sets, 10),
        library_device_ms=device_ms(gather, lib_sets, 3),
        shape=f"T{T} E{E} C{C} K{K} d{d} bf16, forward + backward")
    log(f"  time moe_dispatch [{rec['shape']}]: forward {fwd_ms:.4f} + backward {bwd_ms:.4f} "
        f"= {rec['ms']:.4f} ms per call ({b_ms / rec['ms']:.1%} of the bound), device "
        f"{rec['device_ms']:.4f} ms ({b_ms / rec['device_ms']:.1%}), plain "
        f"{rec['plain_ms']:.4f} ms, library (autograd gather) {rec['library_ms']:.4f} ms per call, "
        f"{rec['library_device_ms']:.4f} device, bound {b_ms:.4f} ms ({b_by}; forward "
        f"{fwd_bytes / PEAK_BYTES * 1e3:.4f}, backward {bwd_bytes / PEAK_BYTES * 1e3:.4f})")
    del sets, lib_sets, eb, gx, grad, x
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError(f"moe dispatch kernels disagree with their plain versions: "
                             f"{failures}")
    return {"moe_dispatch": rec}


def check_block_topk(dev) -> dict:
    """Block top-k against its plain version, bit for bit, at the trainer's
    largest gossip chunk: 4 nodes x 2**24 f32 elements = [65536, 1024]
    blocks, k = 256 (``KernelBlockTopK(0.25, 1024)``), with a zero row, a row
    whose max ties more than k times and an all-negative row; then k = 1 and
    k = block."""
    import torch

    from repro_torch.kernels import topk as ktopk

    gen = torch.Generator(device=dev).manual_seed(9)
    failures: list[str] = []
    R, BLK, K = 4 * QWEN_CHUNK_ROWS * 128 // 1024, 1024, 256

    def make():
        return (torch.randn(R, BLK, generator=gen, device=dev) * 0.02,)

    (x,) = make()
    x[0] = 0.0
    x[1, ::3] = 0.1
    x[2] = -x[2].abs()
    err = 0.0
    for k in (K, 1, BLK):
        out = ktopk.block_topk(x, k)
        want = ktopk.block_topk_plain(x, k)
        _exact(f"block_topk [{R},{BLK}] f32 k={k} (bits, -0.0 included)",
               out.view(torch.int32), want.view(torch.int32), failures)
        err = max(err, float((out - want).abs().max()))
        if k == K:
            kept = (out != 0).sum(1)
            log(f"  block_topk k={K}: kept per row min {int(kept.min())} max {int(kept.max())} "
                f"(row 1 ties {int((x[1].abs() == 0.1).sum())} at its max); dropped negatives "
                f"signed -0.0: {bool(torch.signbit(out[2]).all())}")
    # the persistent walk's edges: rows not a multiple of a CTA's 4, a row
    # count below one wave, block 300 (75 16-byte chunks), block 75 (4-byte
    # copies), block 2048 and a view 4 bytes off a 16-byte boundary
    # and rows that leave the banded rounds: magnitudes past 1e38, a band of
    # ties too wide for the per-lane lists; and subnormal rows
    for rows, blk, kk in ((R - 3, BLK, K), (4097, BLK, K), (131, BLK, 7), (50001, 300, 75),
                          (20011, 75, 9), (8191, 2048, 512), ("view", BLK, K), ("huge", BLK, K),
                          ("ties", BLK, 300), ("subnormal", BLK, K)):
        if rows == "view":
            y = torch.randn(257 * blk + 1, generator=gen, device=dev)[1:].view(257, blk)
        elif rows == "huge":
            y = torch.randn(513, blk, generator=gen, device=dev)
            y[:, :3] = 3e38
        elif rows == "ties":  # 1..16 in steps of 1/8: hundreds of ties in the band
            y = torch.randint(8, 129, (1027, blk), generator=gen, device=dev).float() / 8
        elif rows == "subnormal":
            y = torch.randn(1029, blk, generator=gen, device=dev) * 1e-39
        else:
            y = torch.randn(rows, blk, generator=gen, device=dev) * 0.02
            y[rows // 2] = 0.0
            y[-1, ::3] = 0.01
        tag = f" ({rows})" if isinstance(rows, str) else ""
        _exact(f"block_topk [{y.shape[0]},{blk}] f32 k={kk}{tag}",
               ktopk.block_topk(y, kk).view(torch.int32),
               ktopk.block_topk_plain(y, kk).view(torch.int32), failures)
        del y
    sets = [(x,)] + [make() for _ in range(1)]
    ms = time_ms(lambda a: ktopk.block_topk(a, K), sets, 20)
    dev_ms = device_ms(lambda a: ktopk.block_topk(a, K), sets, 20)
    plain_ms = time_ms(lambda a: ktopk.block_topk_plain(a, K), sets, 3)
    lib_ms = time_ms(lambda a: torch.topk(a.abs(), K, dim=1), sets, 10)
    n = R * BLK
    # per element: |x| and the max (2), 20 rounds of compare + count (40), the mask and product (2)
    b_ms, b_by = bound(44 * n, 8 * n, "float32")
    rec = dict(name="block_topk", route="cuda", source="src/repro_torch/csrc/block_topk.cu",
               replaces="src/repro/kernels/topk.py:53", max_abs_err=err, ms=ms,
               plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
               device_ms=dev_ms, shape=f"[{R},{BLK}] f32, k={K}")
    sink = torch.empty_like(x)  # the same bytes moved by a plain device copy, as a yardstick
    copy_ms = time_ms(lambda a: sink.copy_(a), sets, 20)
    log(f"  time block_topk [{rec['shape']}]: kernel {ms:.4f} ms per call, device {dev_ms:.4f} "
        f"ms ({b_ms / dev_ms:.1%} of the bound), plain {plain_ms:.4f} ms, "
        f"library (torch.topk of |x|, selection only) {lib_ms:.4f} ms, bound {b_ms:.4f} ms "
        f"({b_by}), {b_ms / ms:.1%} of the bound; a copy of the same bytes {copy_ms:.4f} ms "
        f"({b_ms / copy_ms:.1%} of the bound), the kernel at {copy_ms / ms:.1%} of copy speed")
    del sink
    del sets, x
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError(f"block_topk disagrees with its plain version: {failures}")
    return {"block_topk": rec}


# ------------------------------------------------------------------ phase 8
def round_full_width(dev) -> None:
    """One CHOCO round on qwen3-1.7b's largest gossip chunk, [4, 131072,
    128] bf16 (4 wq layers per node), packed against fused, same noise."""
    import torch

    from repro_torch.core import gossip
    from repro_torch.core.topology import ring
    from repro_torch.kernels import _build
    from repro_torch.kernels.ops import KernelQuantization

    gen = torch.Generator(device=dev).manual_seed(8)
    m, R, L = 4, QWEN_CHUNK_ROWS, 128
    bf = torch.bfloat16

    def randn(scale):
        return (torch.randn(m, R, L, generator=gen, device=dev) * scale).to(bf)

    theta, hat, s = randn(0.02), randn(0.02), randn(0.02)
    xi = torch.rand(m, R, L, generator=gen, device=dev)
    topo, comp = ring(m), KernelQuantization(4)
    gamma = 0.5 * comp.delta_for(R * L)
    outs, times = {}, {}
    for name, fused in (("packed", False), ("fused", True)):
        _build.reset_launch_counts()
        gossip._round_leaf(theta, hat, s, xi, topo, gamma, comp, True, fused)  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = gossip._round_leaf(theta, hat, s, xi, topo, gamma, comp, True, fused)
        torch.cuda.synchronize()
        times[name] = (time.perf_counter() - t0) * 1e3
        outs[name] = out
        counts = {k: v // 2 for k, v in _build.launch_counts().items() if v}
        log(f"[8] {name} round [{m},{R},{L}] bf16: {times[name]:.2f} ms (host clock), "
            f"launches {counts}")
    (tp, hp, sp), (tf, hf, sf) = outs["packed"], outs["fused"]
    theta_eq = bool(torch.equal(tp, tf))
    hat_eq = bool(torch.equal(hp, hf))
    a, b = sp.float(), sf.float()
    diff = (a - b).abs()
    # one bf16 rounding step of the larger value: the f32 sums differ only in
    # the last bits (w*(l*scale) vs l*(w*scale)), so their bf16 roundings
    # are equal or adjacent
    step = torch.maximum(a.abs(), b.abs()) * 2.0**-7
    within = bool((diff <= step).all())
    log(f"[8] theta_new equal: {theta_eq}; theta_hat equal: {hat_eq}; s_new: "
        f"{int((diff > 0).sum())} of {diff.numel()} elements differ, max |diff| "
        f"{float(diff.max()):.3e}, all within one bf16 step (2^-7 of the value): {within}")
    if not (theta_eq and hat_eq and within):
        raise AssertionError("packed and fused rounds disagree")
    del outs, theta, hat, s, xi, tp, hp, sp, tf, hf, sf, a, b, diff, step
    torch.cuda.empty_cache()


# per-round records of the one-process runs that phase 17 holds its ranks
# against: "17a/packed", "17a/fused" (its own) and "16a/fused" (phase 16)
ROUND_RECORDS: dict[str, list] = {}


def _round_record(state, aux) -> dict:
    """Chunk digests of theta, theta_hat, s (and any mirrors) after a round,
    with its losses and consensus error, on the host."""
    cons = state.consensus
    return {"digests": _chunk_digests([state.theta, cons.theta_hat, cons.s, *cons.cache]).cpu(),
            "losses": aux["losses"].tolist(), "consensus_err": float(aux["consensus_err"])}


# ------------------------------------------------------------------ phase 9
TRAIN_ARGS = ["--arch", QWEN, "--nodes", "4", "--batch-per-node", "4", "--seq", "128",
              "--compressor", "kq4b", "--steps", "3", "--log-every", "1"]
# step-1/2 losses, packed against fused: the runs differ only in s's f32
# reassociation (theta_hat is equal), which moves theta by gamma * one bf16
# step of s at a few elements
LOSS_REL_BOUND = 1e-3


ROUND_SECTIONS = ("forward_backward", "optimizer", "dual", "consensus", "consensus_err")
GOSSIP_KERNEL_NAMES = ("quantize_kernel", "dequantize_kernel", "fused_encode_kernel",
                       "fused_mix_kernel", "block_topk_kernel")


def _device_events(prof, host: dict | None = None) -> list[tuple[str, int, int, bool]]:
    """(name, start ns, end ns, is a range annotation) of every event on the
    card's timeline, read from the profiler's chrome trace (written and
    parsed in C): building the profiler's Python event tree over every host
    op of a full-width round takes tens of seconds.  ``host``, if given,
    gets the host ms of the trainer's sections (their ``record_function``
    ranges on the CPU side of the same trace: it can be exported once)."""
    import os
    import tempfile

    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    finally:
        os.remove(path)
    trace = trace["traceEvents"] if isinstance(trace, dict) else trace
    if host is not None:
        for e in trace:
            if (e.get("ph") == "X" and e.get("cat") == "user_annotation"
                    and e["name"] in ROUND_SECTIONS):
                host[e["name"]] = host.get(e["name"], 0.0) + e["dur"] / 1e3
    out = [(e["name"], int(e["ts"] * 1e3), int((e["ts"] + e["dur"]) * 1e3),
            e["cat"] == "gpu_user_annotation")
           for e in trace if e.get("ph") == "X"
           and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset", "gpu_user_annotation")]
    if not out:
        raise AssertionError("the profiler's chrome trace holds no event on the card")
    return out


def _profile_breakdown(prof, wall_s: float, host: dict | None = None) -> dict:
    """Kernel time of one profiled round, by the trainer's sections (its
    ``record_function`` ranges, whose device-side spans bracket the kernels
    they launched; a section may recur, as the local steps do) and, inside
    the consensus, gossip kernels vs other ops."""
    t0 = time.perf_counter()
    events = _device_events(prof, host)
    spans: dict[str, list] = {}
    for name, lo, hi, is_range in events:
        if is_range and name in ROUND_SECTIONS:
            spans.setdefault(name, []).append((lo, hi))
    busy = {name: 0.0 for name in ROUND_SECTIONS + ("gossip kernels", "outside")}
    by_name: dict[str, list] = {}
    for name, lo, hi, is_range in events:
        if is_range:
            continue
        ms = (hi - lo) / 1e6
        section = next((k for k, rs in spans.items() if any(a <= lo < b for a, b in rs)),
                       "outside")
        busy[section] += ms
        if section == "consensus" and any(g in name for g in GOSSIP_KERNEL_NAMES):
            busy["gossip kernels"] += ms
        agg = by_name.setdefault(name, [0.0, 0])
        agg[0] += ms
        agg[1] += 1
    total = sum(v for k, v in busy.items() if k != "gossip kernels")
    top = sorted(((v[0], v[1], k) for k, v in by_name.items()), reverse=True)[:8]
    return {"wall_ms": wall_s * 1e3, "busy_ms": total, "busy": busy,
            "spans_ms": {k: sum(b - a for a, b in rs) / 1e6 for k, rs in spans.items()},
            "top": top, "read_s": time.perf_counter() - t0}


def train_full_width(dev) -> dict[str, int]:
    """Phase 9: launch/train.py at full width, ``kq4b`` packed then fused,
    then block top-k on its kernel; returns the kernels' launch counts summed
    over the three runs."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.core.gossip import _scan_plan, payload_bits
    from repro_torch.core.topology import ring
    from repro_torch.kernels import _build
    from repro_torch.kernels.ops import KernelBlockTopK, KernelQuantization
    from repro_torch.launch import train
    from repro_torch.models import transformer as T
    from repro_torch.tree import leaves

    cfg = get_config(QWEN)
    topk = KernelBlockTopK(0.25, 1024)
    m, K, steps = 4, 3, 3
    template = [torch.empty((m,) + tuple(p.shape), device="meta")
                for p in leaves(T.abstract_train_params(cfg))]
    n_enc = 0
    for leaf in template:
        plan = _scan_plan(tuple(leaf.shape), leaf[0].numel(), 1 << 24)
        n_enc += 1 if plan is None else plan[1]
    dual_bits = 32.0 * m * 2  # lambda: m floats to each of the 2 ring neighbours
    want_bits = {name: payload_bits(comp, template, ring(m)) + dual_bits
                 for name, comp in (("packed", KernelQuantization(4)),
                                    ("fused", KernelQuantization(4)), ("block_topk", topk))}
    want_gamma = {"block_topk": 0.5 * topk.fraction}
    expect = {
        "packed": {"quantize": m * n_enc, "dequantize": m * (1 + K) * n_enc},
        "fused": {"fused_encode": n_enc, "fused_mix": n_enc * -(-K // 8)},
        "block_topk": {"block_topk": n_enc},  # one launch per chunk for all nodes
    }
    log(f"[9] chunk plan: {n_enc} encodes per round; expected launches per round {expect}")

    total = {name: 0 for name in _build.COUNTERS}
    runs = {}
    for name, extra, comp in (("packed", [], None), ("fused", ["--fused-gossip"], None),
                              ("block_topk", [], topk)):
        log(f"[9] launch/train.py {' '.join(TRAIN_ARGS + extra)}"
            + (f" with compressor={comp!r} in place of the spec" if comp else ""))
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        prof_out = {}

        def wrap_step(step, run, state):
            if step != 1:
                return run()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                out = run()
                torch.cuda.synchronize()
                prof_out.update(prof=prof, wall=time.perf_counter() - t0)
            return out

        _build.reset_launch_counts()
        metrics = train.main(TRAIN_ARGS + extra, wrap_step=wrap_step, compressor=comp)
        torch.cuda.synchronize()
        counts = _build.launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(f"[9] {name}: launches {counts}; per round "
            f"{ {k: v / steps for k, v in counts.items() if v} }; peak memory {peak:.2f} GiB")
        for k, v in counts.items():
            total[k] += v
        for k, per_round in expect[name].items():
            if counts[k] != per_round * steps:
                raise AssertionError(f"phase 9 {name}: {k} launched {counts[k]} times, the chunk "
                                     f"plan gives {per_round} x {steps}")
        hist = metrics["history"]
        finite = all(math.isfinite(x) for h in hist for x in h["losses"] + [h["consensus_err"]])
        log(f"[9] {name}: s/step {[round(x, 3) for x in metrics['step_seconds']]} (round 1 "
            f"under the profiler); "
            f"bits/round {metrics['bits_per_round']:.6e} (payload_bits of the stacked "
            f"template + dual: {want_bits[name]:.6e}); gamma {metrics['gamma']:.6e}; "
            f"losses {[h['losses'] for h in hist]}; consensus error "
            f"{[h['consensus_err'] for h in hist]}; lambda_max {[h['lambda_max'] for h in hist]}")
        pb = _profile_breakdown(prof_out["prof"], prof_out["wall"])
        log(f"[9] {name} round 1 under torch.profiler: wall {pb['wall_ms']:.1f} ms, kernels "
            f"busy {pb['busy_ms']:.1f} ms ({pb['busy_ms'] / pb['wall_ms']:.1%} of the wall); "
            f"read in {pb['read_s']:.1f} s")
        log(f"[9] {name} kernel ms by section {({k: round(v, 1) for k, v in pb['busy'].items()})}"
            f"; device span ms by section {({k: round(v, 1) for k, v in pb['spans_ms'].items()})}")
        for ms_, count, key in pb["top"]:
            log(f"[9]   {ms_:9.2f} ms x{count:<6d} {key[:90]}")
        if not finite or metrics["bits_per_round"] != want_bits[name]:
            raise AssertionError(f"phase 9 {name}: non-finite losses / consensus error, or "
                                 f"bits/round != payload_bits")
        if name in want_gamma and metrics["gamma"] != want_gamma[name]:
            raise AssertionError(f"phase 9 {name}: gamma {metrics['gamma']} != "
                                 f"{want_gamma[name]} (0.5 delta)")
        runs[name] = hist
    p, f, t = runs["packed"], runs["fused"], runs["block_topk"]
    # round 0's losses come before any gossip: one seed, one model, one batch
    if not p[0]["losses"] == f[0]["losses"] == t[0]["losses"]:
        raise AssertionError(f"step-0 losses differ: {p[0]['losses']} / {f[0]['losses']} / "
                             f"{t[0]['losses']}")
    rel = max(abs(a - b) / abs(b) for s_ in (1, 2) for a, b in zip(p[s_]["losses"],
                                                                   f[s_]["losses"]))
    log(f"[9] step-0 losses equal (packed == fused == block_topk); steps 1-2 max relative "
        f"difference packed vs fused {rel:.3e} (bound {LOSS_REL_BOUND})")
    if rel > LOSS_REL_BOUND:
        raise AssertionError("packed and fused trainers disagree")
    torch.cuda.empty_cache()
    return total


# ----------------------------------------------------------------- phase 10
# worst accuracies of the reference's quickstart (JAX, CPU) with top10 gossip
TOP10_REFERENCE_WORST = {"AD-GDA": 0.242, "CHOCO-SGD": 0.170}


def quickstart(dev) -> None:
    from repro_torch.launch.quickstart import run

    for comp, path in (("kq4b", "fused"), ("top10", "packed")):
        t0 = time.perf_counter()
        res = run(600, compressor=comp, device=dev)
        log(f"[10] quickstart, 10 nodes, ring, {comp} {path}, 600 rounds each: "
            f"{time.perf_counter() - t0:.1f} s")
        log(f"[10] {'':12s} {'majority':>9s} {'minority':>9s} {'worst':>9s}")
        for name, acc in res.items():
            log(f"[10] {name:12s} {acc['majority']:9.3f} {acc['minority']:9.3f} "
                f"{acc['worst']:9.3f}")
        if res["AD-GDA"]["worst"] < res["CHOCO-SGD"]["worst"]:
            raise AssertionError(f"{comp}: AD-GDA's worst accuracy fell below CHOCO-SGD's")
        if comp == "top10":
            off = {n: abs(res[n]["worst"] - w) for n, w in TOP10_REFERENCE_WORST.items()}
            log(f"[10] top10 worst against the reference's {TOP10_REFERENCE_WORST}: "
                f"|difference| {off} (bound 0.01)")
            if max(off.values()) > 0.01:
                raise AssertionError("top10 quickstart departs from the reference's accuracies")


# the depth of the paths past the main ones (phases 4-6 and 9 run qwen3-1.7b
# at full depth): 7 layers, full width, for qwen3-1.7b in the fleet (11) and
# on the training paths (15a-15c, 16a, 17), and for granite-20b,
# recurrentgemma-2b (13) and deepseek-moe-16b (14).  What those phases hold
# (tick fields, served tokens against the plain path, launches per layer and
# forward, masked rows, the GT lanes, the checkpoints' round trip, the
# faulted wire, the ranks against one process) holds at any depth, and the
# cut keeps the whole run under its 1200 s on a card whose host is slow (the
# whole run moves by ~1.4x with the host: PERF.md section 6).
CUT_LAYERS = 7
SERVE_CUT = ("granite-20b", "recurrentgemma-2b", "deepseek-moe-16b")


@contextlib.contextmanager
def _cut_depth(layers: int, arch: str = QWEN, tag: str = "15"):
    """``launch/train.py``, ``launch/serve.py`` and the phase's own
    expectations (through ``configs.get_config``) see ``arch`` with
    ``layers`` of its layers, at full width."""
    from repro_torch import configs
    from repro_torch.launch import serve, train

    full = configs.get_config
    cut = dataclasses.replace(full(arch), num_layers=layers)
    patched = lambda name: cut if name == arch else full(name)
    configs.get_config = train.get_config = serve.get_config = patched
    log(f"[{tag}] {arch} cut to {layers} of {full(arch).num_layers} layers, full width")
    try:
        yield cut
    finally:
        configs.get_config = train.get_config = serve.get_config = full


def _serve_cut(arch: str, tag: str):
    """``_cut_depth(CUT_LAYERS)`` for the archs of SERVE_CUT, else nothing."""
    return _cut_depth(CUT_LAYERS, arch, tag) if arch in SERVE_CUT else contextlib.nullcontext()


# ----------------------------------------------------------------- phase 11
FLEET_NODES, FLEET_SLOTS, FLEET_REQUESTS = 2, 4, 96
# serve.py --fleet at full width: a pool of 64 zipf-popular prompts of 4-512
# tokens, 1-32 new tokens, a 1024-token cache (below the 8192 window, so the
# prefix cache stays on)
FLEET_ARGS = ["--arch", QWEN, "--fleet", str(FLEET_NODES), "--slots", str(FLEET_SLOTS),
              "--prompts", "zipf", "--prompt-pool", "64", "--prompt-len", "512", "--gen", "32",
              "--cache-len", "1024", "--requests", str(FLEET_REQUESTS)]
# the fields that count ticks, requests and cache lookups: the --no-fastpath
# twin must give the same values (the load generator draws no EOS)
TICK_FIELDS = ("completed", "rejected", "shed", "p50_ttft_ticks", "p95_ttft_ticks",
               "p99_ttft_ticks", "mean_queue_depth", "max_queue_depth", "slot_occupancy")
ATTENTION_KERNELS = ("flash_attention", "sliding_window_attention", "block_sparse_attention",
                     "decode_attention", "decode_attention_int8")


def fleet_rate(util: float) -> float:
    """Offered requests per tick per node at ``util`` of a node's capacity
    (slots / mean_request_tokens, as ``benchmarks/bench_serving.py``)."""
    from repro_torch.serving import LoadGenConfig

    lg = LoadGenConfig(num_nodes=FLEET_NODES, rate=1.0, vocab_size=151936, prompt_min=4,
                       prompt_max=512, output_min=1, output_max=32)
    return round(util * FLEET_SLOTS / lg.mean_request_tokens(), 4)


def launches_per_forward(phase, label, counts, prefill_kernels, decode_kernel, prefills, decodes,
                         layers) -> None:
    """Every prefill forward launched one of ``prefill_kernels`` once per
    attention layer (their launches summed: flash and the sliding window
    split a hybrid's prefills by length), every decode forward
    ``decode_kernel``, and no other attention kernel ran."""
    got = {k: counts[k] for k in ATTENTION_KERNELS if counts[k]}
    prefill = sum(counts[k] for k in prefill_kernels)
    others = [k for k in got if k not in prefill_kernels and k != decode_kernel]
    ok = (prefill == layers * prefills and counts[decode_kernel] == layers * decodes
          and not others and prefills and decodes)
    log(f"[{phase}] {label}: launches {got}; {layers} attention layers x ({prefills} prefill, "
        f"{decodes} decode forwards) {'equal' if ok else 'DIFFERENT'}")
    if not ok:
        raise AssertionError(f"phase {phase} {label}: launches {got} != {layers} x "
                             f"({prefills} prefill of {prefill_kernels}, {decodes} decode)")


def served_vs_plain(label, served, cfg, params, dev) -> None:
    """Eight of a fleet run's finished requests, spread over prompt lengths,
    against the plain path (``attn_kernel=None``): one plain prefill over
    prompt + output[:-1] gives the plain argmax at every generated position.
    Phase 4's rule holds the first tokens (>= 6 of 8 equal); the later tokens,
    which the decode kernel gave at the fleet's gathered batch shapes, must
    equal the plain argmax on their own prefix at >= 3/4 of the positions."""
    import torch

    from repro_torch.models import transformer as T

    plain = dataclasses.replace(cfg, attn_kernel=None)
    pool = sorted({tuple(r["prompt"]): r for r in served}.values(),
                  key=lambda r: (len(r["prompt"]), len(r["output"])))
    sample = [pool[round(i * (len(pool) - 1) / 7)] for i in range(8)] if len(pool) >= 8 else pool
    firsts = later = later_same = 0
    with torch.no_grad():
        for r in sample:
            seq = r["prompt"] + r["output"][:-1]
            logits, _ = T.prefill(params, {"tokens": torch.tensor([seq], device=dev)}, plain,
                                  cache_len=len(seq))
            want = torch.argmax(logits[0, len(r["prompt"]) - 1:], dim=-1).tolist()
            firsts += want[0] == r["output"][0]
            later += len(want) - 1
            later_same += sum(a == b for a, b in zip(want[1:], r["output"][1:]))
            del logits
    share = later_same / later if later else 1.0
    log(f"[11] {label}: served tokens against the plain path on {len(sample)} requests "
        f"(prompts {[len(r['prompt']) for r in sample]}): first tokens equal {firsts}/"
        f"{len(sample)} (bound >= 6/8), later tokens equal to the plain argmax {later_same}/"
        f"{later} = {share:.3f} (bound >= 0.75)")
    if len(sample) < 8 or firsts < 6 or share < 0.75:
        raise AssertionError(f"phase 11 {label}: served tokens disagree with the plain path")


def fleet_full_width(dev) -> dict[str, int]:
    """Phase 11: ``launch/serve.py --fleet`` at full width with flash, int8
    decode and block-sparse attention, the --no-fastpath twin, an overload
    run, and a hot reload mid-run through the fleet's API.  Returns the
    kernels' launch counts summed over the runs."""
    import tempfile

    import torch

    from repro_torch.checkpoint import save, step_path
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    from repro_torch.serving import (AdmissionControl, FleetNode, HotReloader, LoadGenConfig,
                                     LoadGenerator, ServeEngine, ServingFleet)

    layers = get_config(QWEN).num_layers
    card = gpu_name_and_limit()
    total = {name: 0 for name in _build.COUNTERS}
    rate, over = fleet_rate(0.8), fleet_rate(1.4)
    flash = {"attn_kernel": "flash"}
    runs = [("flash", flash, rate, [], "flash_attention", "decode_attention"),
            ("flash, int8 KV", {**flash, "quantized_kv": True}, rate, [], "flash_attention",
             "decode_attention_int8"),
            ("block_sparse", {"attn_kernel": "block_sparse"}, rate, [], "block_sparse_attention",
             "decode_attention"),
            ("flash --no-fastpath", flash, rate, ["--no-fastpath"], "flash_attention",
             "decode_attention"),
            ("flash, utilization 1.4", flash, over, [], "flash_attention", "decode_attention")]
    # serve.py's weights (its --seed 0 generator): the plain path's reference
    base = get_config(QWEN)
    plain_params = T.init_model(base, generator=torch.Generator(device=dev).manual_seed(0),
                                device=dev)
    checked = ("flash", "flash, int8 KV", "block_sparse")
    out = {}
    for label, overrides, r, extra, pk, dk in runs:
        argv = FLEET_ARGS + ["--rate", str(r)] + extra
        log(f"[11] launch/serve.py {' '.join(argv)} (config {overrides})")
        _build.reset_launch_counts()
        res = serve.main(argv, config_overrides=overrides)
        torch.cuda.synchronize()
        counts = _build.launch_counts()
        for k, v in counts.items():
            total[k] += v
        f = res["metrics"]
        log(f"[11] {label} ({card}): {f['tok_per_s']:.1f} tokens/s, {f['per_token_ms']:.2f} "
            f"ms/token, TTFT p50/p99 {f['p50_ttft_ms']:.1f}/{f['p99_ttft_ms']:.1f} ms "
            f"({f['p50_ttft_ticks']:.0f}/{f['p99_ttft_ticks']:.0f} ticks), queue depth mean/max "
            f"{f['mean_queue_depth']:.2f}/{f['max_queue_depth']:.0f}, slot occupancy "
            f"{f['slot_occupancy']:.3f}, cache hit rate {f['cache_hit_rate']:.3f}; "
            f"{res['offered']} offered, {f['completed']} completed, {f['rejected']} rejected, "
            f"{f['shed']} shed in {res['ticks']} ticks, {res['wall_seconds']:.1f} s")
        launches_per_forward(11, label, counts, (pk,), dk, res["prefill_forwards"],
                             res["decode_forwards"], layers)
        if f["completed"] + f["rejected"] + f["shed"] != res["offered"] or not f["completed"]:
            raise AssertionError(f"phase 11 {label}: requests lost or none completed")
        if label in checked:
            served_vs_plain(label, res["served"], dataclasses.replace(base, **overrides),
                            plain_params, dev)
        out[label] = res
    fast, twin = out["flash"], out["flash --no-fastpath"]
    same = {k: (fast["metrics"][k], twin["metrics"][k]) for k in TICK_FIELDS}
    same["ticks"] = (fast["ticks"], twin["ticks"])
    equal = all(a == b for a, b in same.values())
    log(f"[11] --no-fastpath twin against the fast run, tick fields (fast, twin): {same}: "
        f"{'equal' if equal else 'DIFFERENT'}; prefill forwards {fast['prefill_forwards']} "
        f"against {twin['prefill_forwards']}, wall {fast['wall_seconds']:.1f} against "
        f"{twin['wall_seconds']:.1f} s")
    if not equal:
        raise AssertionError("phase 11: the --no-fastpath twin's tick fields differ")
    if out["flash, utilization 1.4"]["metrics"]["rejected"] == 0:
        raise AssertionError("phase 11: admission control rejected nothing at utilization 1.4")
    if out["flash"]["metrics"]["cache_hit_rate"] <= 0:
        raise AssertionError("phase 11: the prefix cache never hit on zipf traffic")

    del plain_params
    torch.cuda.empty_cache()

    # hot reload: serve, save a new step (and plant a torn newer one), serve on
    cfg = dataclasses.replace(get_config(QWEN), **flash)
    params = T.init_model(cfg, seed=0, device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        prefix = f"{tmp}/consensus"
        gen = LoadGenerator(LoadGenConfig(num_nodes=FLEET_NODES, rate=rate,
                                          vocab_size=cfg.vocab_size, prompt_min=4,
                                          prompt_max=512, output_min=1, output_max=32,
                                          prompt_mode="pool", prompt_pool=64, seed=1))
        skips: list[str] = []
        # one restore per step, shared by the nodes (no per-node copy)
        reloaders = HotReloader.for_nodes(prefix, params, FLEET_NODES, log=skips.append)
        nodes = [FleetNode(i, ServeEngine(cfg, params, max_slots=FLEET_SLOTS, cache_len=1024,
                                          prompt_bucket=8, device=dev),
                           admission=AdmissionControl(max_queue=12), reloader=reloader)
                 for i, reloader in enumerate(reloaders)]
        fleet = ServingFleet(nodes, gen, reload_every=4)
        _build.reset_launch_counts()
        fleet.run(max_requests=FLEET_REQUESTS, max_ticks=30)
        before = [n.engine.stats()["prefix_entries"] for n in nodes]
        t0 = time.perf_counter()
        new = {**params, "final_norm": {"scale": params["final_norm"]["scale"] * 1.5}}
        fname = save(prefix, new, step=1)
        with open(step_path(prefix, 2), "wb") as fh:
            fh.write(b"PK\x03\x04 a checkpoint torn in flight")
        log(f"[11] hot reload: after {fleet.ticks} ticks, saved {fname} "
            f"({Path(fname).stat().st_size / 2**30:.2f} GiB) in {time.perf_counter() - t0:.1f} s "
            f"and a torn step 2; prefix cache entries per node {before}")
        rep = fleet.run(max_requests=FLEET_REQUESTS)
        torch.cuda.synchronize()
        counts = _build.launch_counts()
        for k, v in counts.items():
            total[k] += v
    log(f"[11] hot reload: {len(skips)} polls skipped the torn file, first: "
        f"{skips[0] if skips else None}")
    f = rep.fleet
    reload_state = [(n.reloader.step, n.reloader.reloads, n.reloader.skipped,
                     n.engine.params_version, n.engine.prefix_invalidations) for n in nodes]
    shared = all(n.engine.params is nodes[0].engine.params for n in nodes)
    log(f"[11] hot reload: the nodes serve one restored params object: {shared}")
    if not shared or nodes[0].engine.params is params:
        raise AssertionError("phase 11 hot reload: the nodes do not share the restored params")
    log(f"[11] hot reload ({card}): {rep.offered} offered, {f['completed']} completed in "
        f"{rep.ticks} ticks; per node (step, reloads, torn files skipped, params version, "
        f"prefix-cache invalidations) {reload_state}; {f['tok_per_s']:.1f} tokens/s")
    launches_per_forward(11, "hot reload", counts, ("flash_attention",), "decode_attention",
                         sum(n.engine.prefill_forwards for n in nodes),
                         sum(n.engine.decode_forwards for n in nodes), layers)
    bad = [t for n in nodes for r in n.requests for t in r.output
           if not 0 <= t < cfg.vocab_size]
    # each node: step 1 loaded once, the torn step 2 skipped, the prefix cache dropped
    if (any(st != 1 or rl != 1 or sk < 1 or ver != 1 or inv < 1
            for st, rl, sk, ver, inv in reload_state)
            or bad or f["completed"] + f["rejected"] + f["shed"] != rep.offered):
        raise AssertionError(f"phase 11 hot reload: {reload_state}, {len(bad)} invalid tokens")
    del params, new, nodes, fleet
    torch.cuda.empty_cache()
    return total


# ----------------------------------------------------------------- phase 12
def train_and_serve(dev) -> dict[str, int]:
    """Phase 12: AD-GDA and its unweighted twin with ``kq4b`` fused gossip,
    the consensus checkpointed each phase and served by a fleet of
    classifier engines that hot-reload it.  Returns the launch counts."""
    import torch

    from repro_torch.core.gossip import _scan_plan
    from repro_torch.data import rotated_minority_classification
    from repro_torch.kernels import _build
    from repro_torch.launch import train_serve

    phases, rounds = 4, 100
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    rows = train_serve.run(phases=phases, rounds=rounds, compressor="kq4b", device=dev,
                           log=lambda s_: log(f"[12] {s_}"))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = _build.launch_counts()
    # one encode and one mix per leaf chunk and round (w [dim, classes], b
    # [classes]; K = 3 ring shifts, one mix launch), two trainers
    data = rotated_minority_classification(num_nodes=10, minority_nodes=2, seed=0)
    enc = sum(1 if (pl := _scan_plan((10,) + shape, math.prod(shape), 1 << 24)) is None
              else pl[1] for shape in ((data.dim, data.num_classes), (data.num_classes,)))
    want = {"fused_encode": enc * 2 * phases * rounds, "fused_mix": enc * 2 * phases * rounds}
    log(f"[12] train and serve, m10s4, kq4b fused, {phases} x {rounds} rounds each, "
        f"{secs:.1f} s: launches {({k: v for k, v in counts.items() if v})}")
    for r in rows:
        log(f"[12] {r['algo']:10s} worst_node_acc {r['worst_node_acc']:.4f} served_worst_acc "
            f"{r['served_worst_acc']:.4f} mean_node_acc {r['mean_node_acc']:.4f} "
            f"first_worst_acc {r['first_worst_acc']:.4f} worst_node_loss "
            f"{r['worst_node_loss']:.4f} reloads {r['reloads']} skipped {r['reload_skipped']} "
            f"requests {r['requests']} probe_forwards {r['probe_forwards']:.0f}")
    adgda, plain = rows
    log(f"[12] AD-GDA worst-node accuracy {adgda['worst_node_acc']:.4f} against the unweighted "
        f"twin's {plain['worst_node_acc']:.4f}: "
        f"{'above' if adgda['worst_node_acc'] > plain['worst_node_acc'] else 'NOT above'}")
    if {k: counts[k] for k in want} != want:
        raise AssertionError(f"phase 12: launches {counts} != {want}")
    if any(r["reloads"] != 10 * phases or r["probe_forwards"] != phases + 1 for r in rows):
        raise AssertionError("phase 12: a node missed a reload, or the probe ran off its steps")
    if adgda["worst_node_acc"] <= plain["worst_node_acc"]:
        raise AssertionError("phase 12: AD-GDA's worst-node accuracy is not above the "
                             "unweighted twin's")
    return counts


# ----------------------------------------------------------------- phase 13
# the model zoo at full width, in the order run (the largest engine first)
ZOO_ARCHS = ("granite-20b", "recurrentgemma-2b", "qwen3-4b", "command-r-35b")
ZOO_FLEET_REQUESTS = 48
FLASH_PREFILL = ("flash_attention", "sliding_window_attention")  # S < 256, S >= 256 windowed


def attention_layers(cfg) -> int:
    """Layers whose self-attention takes the kernels (whisper's encoder and
    cross-attention keep the plain path, as the reference's)."""
    return sum(cfg.mixer_for_layer(i) in ("attn", "local_attn") for i in range(cfg.num_layers))


def zoo_row(arch: str, counter: str) -> str:
    """The kernels line's row whose shapes ``arch``'s launches of ``counter``
    run: decode at the arch's row of ``ZOO_DECODE`` (internvl2-2b's G 2 at
    the qwen3-1.7b row), recurrentgemma-2b's attention at hd 256,
    whisper-small's at hd 64, llama4's flash at 40 heads, the other archs'
    at the qwen3-1.7b rows' hd 128."""
    if counter.startswith("decode"):
        return next((f"{counter} {tag}" for tag, shp in ZOO_DECODE.items()
                     if shp["arch"] == arch), counter)
    if arch == LLAMA4:  # flash at its 40 heads; block-sparse on the hd-128 row
        return f"{counter} H40" if counter == "flash_attention" else counter
    return {"recurrentgemma-2b": f"{counter} hd256",
            "whisper-small": f"{counter} hd64"}.get(arch, counter)


ENGINE_RUNS = (("flash", {"attn_kernel": "flash"}, FLASH_PREFILL, "decode_attention"),
               ("flash, int8 KV", {"attn_kernel": "flash", "quantized_kv": True}, FLASH_PREFILL,
                "decode_attention_int8"),
               ("block_sparse", {"attn_kernel": "block_sparse"}, ("block_sparse_attention",),
                "decode_attention"))


def zoo_engines(arch, cfg, params, dev, lens, cache_len, total, *, slots=4, runs=ENGINE_RUNS,
                extra=None, phase=13) -> list:
    """ServeEngine with plain attention and each of ``runs`` (flash, flash +
    int8 KV and block-sparse prefill by default) on ``len(lens)`` requests
    (16 new tokens each; ``extra`` the engine's ``extra_inputs``): first
    tokens against the plain engine's (>= 3/4; a MoE model's routing pinned
    to the plain engine's), launches against the forwards.  Returns each
    run's seconds per generated token."""
    import torch

    from repro_torch.kernels import _build

    layers = attention_layers(cfg)
    n = len(lens)
    rng = random.Random(len(arch))
    pool = {}
    prompts = [pool.setdefault(m, [rng.randrange(cfg.vocab_size) for _ in range(m)])
               for m in lens]
    kw = dict(max_slots=slots, cache_len=cache_len, prompt_bucket=32, extra_inputs=extra)
    log(f"[{phase}] {arch} ServeEngine: {n} requests, prompts {lens}, 16 new tokens, {slots} "
        f"slots x {cache_len}-token cache" + (f", extra inputs {sorted(extra)}" if extra else ""))
    pin = RoutingPin()
    with pin.record():
        plain, *_ = run_engine("plain attention (reference)", cfg, params, dev, prompts, 16,
                               **kw)
    per_token = []
    for label, over, pks, dk in runs:
        _build.reset_launch_counts()
        with pin.replay():
            reqs, secs, _, eng = run_engine(label, dataclasses.replace(cfg, **over), params, dev,
                                            prompts, 16, **kw)
        torch.cuda.synchronize()
        per_token.append(secs / (16 * n))
        counts = _build.launch_counts()
        for k, v in counts.items():
            total[k] += v
        launches_per_forward(phase, f"{arch} engine {label}", counts, pks, dk,
                             eng.prefill_forwards, eng.decode_forwards, layers)
        firsts = sum(a.output[0] == b.output[0] for a, b in zip(reqs, plain))
        same = sum(a.output == b.output for a, b in zip(reqs, plain))
        need = math.ceil(0.75 * n)
        log(f"[{phase}] {arch} {label}: first tokens equal to the plain engine's {firsts}/{n}, "
            f"whole outputs {same}/{n} (bound: first tokens >= {need}/{n}){pin.note()}")
        if firsts < need:
            raise AssertionError(f"[{phase}] {arch} {label} engine disagrees with the plain "
                                 f"engine")
    torch.cuda.empty_cache()
    return per_token


def zoo_fleet(arch, layers, dev, total, phase=13) -> float:
    """``serve.py --fleet 2`` at utilization 0.8 with flash, and its
    --no-fastpath twin: tick fields equal, launches against the forwards."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.launch import serve

    argv = ["--arch", arch, "--fleet", str(FLEET_NODES), "--slots", str(FLEET_SLOTS),
            "--prompts", "zipf", "--prompt-pool", "64", "--prompt-len", "512", "--gen", "32",
            "--cache-len", "1024", "--requests", str(ZOO_FLEET_REQUESTS),
            "--rate", str(fleet_rate(0.8))]
    out = {}
    for label, extra in (("flash", []), ("flash --no-fastpath", ["--no-fastpath"])):
        log(f"[{phase}] launch/serve.py {' '.join(argv + extra)} (attn_kernel='flash')")
        _build.reset_launch_counts()
        res = serve.main(argv + extra, config_overrides={"attn_kernel": "flash"})
        torch.cuda.synchronize()
        counts = _build.launch_counts()
        for k, v in counts.items():
            total[k] += v
        f = res["metrics"]
        log(f"[{phase}] {arch} fleet {label}: {f['tok_per_s']:.1f} tokens/s, "
            f"{f['per_token_ms']:.2f} ms/token, TTFT p50/p99 {f['p50_ttft_ms']:.1f}/"
            f"{f['p99_ttft_ms']:.1f} ms ({f['p50_ttft_ticks']:.0f}/{f['p99_ttft_ticks']:.0f} "
            f"ticks); {res['offered']} offered, {f['completed']} completed, {f['rejected']} "
            f"rejected in {res['ticks']} ticks, {res['wall_seconds']:.1f} s")
        launches_per_forward(phase, f"{arch} fleet {label}", counts, FLASH_PREFILL,
                             "decode_attention", res["prefill_forwards"], res["decode_forwards"],
                             layers)
        if f["completed"] + f["rejected"] + f["shed"] != res["offered"] or not f["completed"]:
            raise AssertionError(f"[{phase}] {arch} fleet {label}: requests lost or none "
                                 f"completed")
        out[label] = res
    fast, twin = out["flash"], out["flash --no-fastpath"]
    same = {k: (fast["metrics"][k], twin["metrics"][k]) for k in TICK_FIELDS}
    same["ticks"] = (fast["ticks"], twin["ticks"])
    equal = all(a == b for a, b in same.values())
    log(f"[{phase}] {arch} --no-fastpath twin, tick fields (fast, twin): {same}: "
        f"{'equal' if equal else 'DIFFERENT'}")
    if not equal:
        raise AssertionError(f"[{phase}] {arch}: the --no-fastpath twin's tick fields differ")
    return fast["metrics"]["per_token_ms"]


def zoo_serve_batch(arch, B, dev, total, phase=13, S=256) -> float:
    """``serve.py --arch <arch> --batch B --prompt-len S --gen 16`` with
    flash: launches = layers x (1 prefill, 15 decode forwards); then the
    same weights, prompt and ``frames`` / ``patches`` stubs (serve.py's
    seeded generator) through the plain path: the served tokens against the
    plain argmax on their own prefix (>= 3/4) and the flash prefill's logits
    over that sequence against the plain prefill's.  Returns serve.py's ms
    per token."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T

    gen_n = 16
    cfg = get_config(arch)
    layers = attention_layers(cfg)
    argv = ["--arch", arch, "--batch", str(B), "--prompt-len", str(S), "--gen", str(gen_n)]
    log(f"[{phase}] launch/serve.py {' '.join(argv)} (attn_kernel='flash')")
    _build.reset_launch_counts()
    metrics = serve.main(argv, config_overrides={"attn_kernel": "flash"})
    torch.cuda.synchronize()
    counts = _build.launch_counts()
    for k, v in counts.items():
        total[k] += v
    log(f"[{phase}] {arch} serve.py: per-token {metrics['per_token_ms']:.2f} ms, prefill "
        f"{metrics['prefill_seconds']:.3f} s")
    launches_per_forward(phase, f"{arch} serve.py", counts, FLASH_PREFILL, "decode_attention", 1,
                         gen_n - 1, layers)
    torch.cuda.empty_cache()
    # serve.py's weights and prompt: its --seed 0 generator draws the weights, then the tokens
    g = torch.Generator(device=dev).manual_seed(0)
    params = T.init_model(cfg, generator=g, device=dev)
    prompt = torch.randint(0, cfg.vocab_size, (B, S), generator=g, device=dev)
    batch = serve.stub_inputs(cfg, B, g, dev)
    served = torch.tensor(metrics["tokens"], device=dev)
    batch["tokens"] = seq = torch.cat([prompt, served[:, :-1]], dim=1)
    with torch.no_grad():
        plain, _ = T.prefill(params, batch, cfg, cache_len=seq.shape[1])
        want = torch.argmax(plain[:, S - 1:], -1)
        flash, _ = T.prefill(params, batch, dataclasses.replace(cfg, attn_kernel="flash"),
                             cache_len=seq.shape[1])
    share = float((want == served).float().mean())
    log(f"[{phase}] {arch} serve.py: served tokens equal to the plain argmax on their own prefix "
        f"{int((want == served).sum())}/{served.numel()} = {share:.3f} (bound >= 0.75); first "
        f"tokens {int((want[:, 0] == served[:, 0]).sum())}/{B}")
    logits_vs_plain(f"[{phase}] {arch} flash prefill over the served sequence",
                    flash[:, S - 1:].float(), plain[:, S - 1:].float())
    if share < 0.75:
        raise AssertionError(f"[{phase}] {arch}: served tokens disagree with the plain path")
    del params, plain, flash
    return metrics["per_token_ms"]


def model_zoo(dev) -> dict[str, dict[str, int]]:
    """Phase 13: granite-20b, recurrentgemma-2b, qwen3-4b and command-r-35b at
    full width (random bf16 weights from a seeded generator, one model on the
    card at a time; granite-20b and recurrentgemma-2b on CUT_LAYERS of their
    layers).  Returns each arch's kernel launch counts."""
    card = gpu_name_and_limit()
    out = {}
    for arch in ZOO_ARCHS:
        with _serve_cut(arch, "13"):
            out[arch] = zoo_model(arch, dev, card)
    return out


def zoo_model(arch, dev, card) -> dict[str, int]:
    """One model of phase 13; returns its kernel launch counts."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models import transformer as T

    capacity = torch.cuda.get_device_properties(dev).total_memory
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    total = {name: 0 for name in _build.COUNTERS}
    cfg = get_config(arch)
    layers = attention_layers(cfg)
    log(f"[13] {arch}: {T.param_count(cfg) / 1e9:.3f} B parameters in {cfg.dtype}, "
        f"{cfg.num_layers} layers ({layers} attention), hd {cfg.hd}, "
        f"{cfg.num_heads // cfg.num_kv_heads} query heads per kv head")
    if arch in ("granite-20b", "recurrentgemma-2b"):
        params = T.init_model(cfg, seed=0, device=dev)
        prefill_decode_vs_plain(f"[13] {arch}", cfg, params, dev, ("flash", "block_sparse"))
        if arch == "granite-20b":
            zoo_engines(arch, cfg, params, dev, [17, 600, 130, 333, 17, 480, 64, 251], 1024,
                        total)
        else:
            # exact-length prefill: lengths that are multiples of 8, so the
            # block-sparse prefill finds a block that divides each; the
            # 2048-row rings of the local layers wrap for 2432 and 3000
            zoo_engines(arch, cfg, params, dev, [24, 2432, 136, 640, 24, 3000, 64, 1024],
                        4096, total)
            rng = random.Random(7)
            prompt = [rng.randrange(cfg.vocab_size) for _ in range(4096)]
            for knob in ("flash", "block_sparse"):
                long_logits_vs_plain(cfg, params, prompt, dev, 4096 + 32, knob=knob,
                                     tag="[13] recurrentgemma-2b")
        del params
        torch.cuda.empty_cache()
        zoo_fleet(arch, layers, dev, total)
    else:
        zoo_serve_batch(arch, 4 if arch == "qwen3-4b" else 2, dev, total)
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"[13] {arch} ({card}): peak memory {peak / 2**30:.2f} GiB of the card's "
        f"{capacity / 2**30:.2f} GiB; {time.perf_counter() - t0:.1f} s; launches "
        f"{ {k: v for k, v in total.items() if v} }")
    return total


# ----------------------------------------------------------------- phase 14
# the sixth slice's families at full width, one model on the card at a
# time: prompts per engine (deepseek-moe-16b's 12 fill 12 slots, so that a
# batched decode passes 8 rows; mamba2-1.3b's are whole 256-token chunks;
# internvl2-2b's cover its 256 patch positions; whisper-small's decoder
# prompts are short, as transcripts are)
FAMILY_ARCHS = ("deepseek-moe-16b", "mamba2-1.3b", "internvl2-2b", "whisper-small")
FAMILY_LENS = {
    "deepseek-moe-16b": [17, 600, 130, 333, 17, 480, 64, 251, 600, 96, 200, 45],
    "mamba2-1.3b": [256, 512, 768, 1024, 256, 1024, 512, 768],
    "internvl2-2b": [256, 300, 600, 257, 480, 256, 400, 333],
    "whisper-small": [8, 40, 120, 17, 200, 64, 33, 100],
}


MAMBA_F32_REL_BOUND = 1e-3


def mamba_continuation(cfg, params, dev, S: int, B: int = 2, steps: int = 16,
                       check: bool = True) -> None:
    """Prefill B x S + ``steps`` decode steps (teacher-forced) against one
    prefill over S + one chunk of the same tokens: the decode path's logits
    at positions S-1 .. S+steps-1 against the full-sequence chunked scan's.
    Checked in float32 (``cfg.dtype``): rel L2 <= MAMBA_F32_REL_BOUND (f32
    summation order; a wrong state or conv tail is O(1)) and phase 3's
    greedy bound; in bf16 logged beside ``mamba_noise_floor``."""
    import torch

    from repro_torch.models import transformer as T

    gen = torch.Generator(device=dev).manual_seed(S)
    ext = S + cfg.ssm_chunk
    tokens = torch.randint(0, cfg.vocab_size, (B, ext), generator=gen, device=dev)
    full, _ = T.prefill(params, {"tokens": tokens}, cfg, ext)
    logits, cache = T.prefill(params, {"tokens": tokens[:, :S]}, cfg, S)
    outs = [logits[:, -1]]
    for i in range(steps):
        logits, cache = T.decode_step(params, tokens[:, S + i:S + i + 1], cache, S + i, cfg)
        outs.append(logits[:, 0])
    a = torch.stack(outs).float()
    b = full[:, S - 1:S + steps].transpose(0, 1).float()
    rel = float((a - b).norm() / b.norm())
    agree = float((a.argmax(-1) == b.argmax(-1)).float().mean())
    bounds = f" (bound {MAMBA_F32_REL_BOUND})" if check else " (not a check)"
    log(f"[14] mamba2-1.3b {cfg.dtype}: prefill {B}x{S} + {steps} decode steps against one scan "
        f"over {ext} tokens: logits rel L2 {rel:.3e}{bounds}, greedy agreement {agree:.3f}"
        + (f" (bound >= {GREEDY_AGREE_BOUND})" if check else ""))
    if check and (rel > MAMBA_F32_REL_BOUND or agree < GREEDY_AGREE_BOUND):
        raise AssertionError(f"[14] mamba2-1.3b: the decode path does not continue the scan "
                             f"(S {S})")
    del full, logits, cache
    torch.cuda.empty_cache()


def mamba_noise_floor(cfg, params, dev, S: int = 512, B: int = 2) -> None:
    """How far the bf16 model moves its own logits under a rounding-sized
    change: one prefill against the same prefill with the embedding table
    scaled by (1 + 2^-9 N(0, 1)), under half a bf16 step.  48 random layers
    amplify it; the bf16 decode continuation is read against this."""
    import torch

    from repro_torch.models import transformer as T

    gen = torch.Generator(device=dev).manual_seed(5)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device=dev)
    table = params["embed"]["table"]
    noise = 1 + 2**-9 * torch.randn(table.shape, generator=gen, device=dev)
    moved = dict(params, embed={"table": (table.float() * noise).to(table.dtype)})
    del noise
    a, _ = T.prefill(params, {"tokens": tokens}, cfg, S)
    b, _ = T.prefill(moved, {"tokens": tokens}, cfg, S)
    a, b = a.float(), b.float()
    log(f"[14] mamba2-1.3b {cfg.dtype} noise floor: {B}x{S} prefill against the same with the "
        f"embedding scaled by 1 + 2^-9 N(0, 1): logits rel L2 "
        f"{float((a - b).norm() / b.norm()):.3e}, greedy agreement "
        f"{float((a.argmax(-1) == b.argmax(-1)).float().mean()):.3f}")
    del a, b, moved
    torch.cuda.empty_cache()


def mamba_engine(cfg, params, dev, check: bool) -> float:
    """mamba2-1.3b through ServeEngine: 8 requests of whole chunks (exact
    length prefill, same-length prompts batched), 16 new tokens; first tokens
    against a batch-1 prefill of each prompt (>= 6/8 with ``check``: f32,
    where batching changes only the summation order), the prefix cache
    bypassed.  No kernel runs on this path (the reference has no Pallas
    kernel for the SSD scan).  Returns ms per generated token."""
    import torch

    from repro_torch.models import transformer as T

    lens = FAMILY_LENS["mamba2-1.3b"]
    rng = random.Random(3)
    prompts = [[rng.randrange(cfg.vocab_size) for _ in range(n)] for n in lens]
    log(f"[14] mamba2-1.3b {cfg.dtype} ServeEngine: 8 requests, prompts {lens}, 16 new tokens, "
        f"4 slots")
    reqs, secs, _, eng = run_engine(f"mamba2 engine {cfg.dtype}", cfg, params, dev, prompts, 16,
                                    max_slots=4, cache_len=1040, prompt_bucket=32)
    with torch.no_grad():
        alone = [int(torch.argmax(T.prefill(params, {"tokens": torch.tensor([p], device=dev)},
                                            cfg, len(p))[0][0, -1])) for p in prompts]
    firsts = sum(r.output[0] == a for r, a in zip(reqs, alone))
    lookups = eng.prefix_hits + eng.prefix_misses
    log(f"[14] mamba2-1.3b {cfg.dtype} engine: first tokens equal to a batch-1 prefill's "
        f"{firsts}/8" + (" (bound >= 6/8)" if check else " (not a check)") + f"; "
        f"{eng.prefill_forwards} prefill, {eng.decode_forwards} decode forwards, prefix cache "
        f"lookups {lookups} (bypassed)")
    if (check and firsts < 6) or lookups:
        raise AssertionError("[14] mamba2-1.3b engine disagrees with a batch-1 prefill, or "
                             "looked up its prefix cache")
    return secs / (16 * len(lens)) * 1e3


def mamba_serve_batch() -> float:
    """``serve.py --arch mamba2-1.3b`` batch mode: the prompt length rounded
    down to whole chunks, 16 tokens a row.  Returns ms per token."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import serve

    chunk = get_config("mamba2-1.3b").ssm_chunk
    argv = ["--arch", "mamba2-1.3b", "--batch", "4", "--prompt-len", "300", "--gen", "16"]
    log(f"[14] launch/serve.py {' '.join(argv)} (prompts rounded to whole chunks)")
    metrics = serve.main(argv)
    log(f"[14] mamba2-1.3b serve.py: prompt {metrics['prompt_len']} tokens, per-token "
        f"{metrics['per_token_ms']:.2f} ms, prefill {metrics['prefill_seconds']:.3f} s")
    if (metrics["prompt_len"] != 300 - 300 % chunk
            or tuple(torch.tensor(metrics["tokens"]).shape) != (4, 16)):
        raise AssertionError("[14] mamba2-1.3b serve.py: prompt not rounded, or tokens missing")
    return metrics["per_token_ms"]


def families(dev) -> dict[str, dict[str, int]]:
    """Phase 14: deepseek-moe-16b (on CUT_LAYERS of its layers), mamba2-1.3b,
    internvl2-2b and whisper-small at full width (random bf16 weights from a
    seeded generator, one model on the card at a time).  Returns each arch's
    launch counts."""
    card = gpu_name_and_limit()
    out = {}
    for arch in FAMILY_ARCHS:
        with _serve_cut(arch, "14"):
            out[arch] = family_model(arch, dev, card)
    return out


def family_model(arch, dev, card) -> dict[str, int]:
    """One model of phase 14; returns its kernel launch counts."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.launch.serve import stub_inputs
    from repro_torch.models import transformer as T

    capacity = torch.cuda.get_device_properties(dev).total_memory
    int8 = ("flash, int8 KV", {"attn_kernel": "flash", "quantized_kv": True})
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    total = {name: 0 for name in _build.COUNTERS}
    cfg = get_config(arch)
    layers = attention_layers(cfg)
    lens = FAMILY_LENS[arch]
    log(f"[14] {arch}: {T.param_count(cfg) / 1e9:.3f} B parameters "
        f"({T.active_param_count(cfg) / 1e9:.3f} B active) in {cfg.dtype}, {cfg.num_layers} "
        f"layers ({layers} attention" + (f", {cfg.encoder_layers} encoder" if cfg.is_encdec
                                          else "") + ")"
        + (f", hd {cfg.hd}, {cfg.num_heads // cfg.num_kv_heads} query heads per kv head"
           if layers else ""))
    params = T.init_model(cfg, seed=0, device=dev)
    ms = {}
    if arch == "deepseek-moe-16b":
        prefill_decode_vs_plain(f"[14] {arch}", cfg, params, dev, ("flash", "block_sparse"))
        ms["engine"] = 1e3 * zoo_engines(arch, cfg, params, dev, lens, 1024, total, slots=12,
                                         phase=14)[0]
        del params
        torch.cuda.empty_cache()
        ms["fleet"] = zoo_fleet(arch, layers, dev, total, phase=14)
    elif arch == "mamba2-1.3b":
        # the served bf16 model is chaotic at random weights (a change under
        # half a bf16 step moves its logits by tens of percent), so the
        # continuation is held in f32 and read in bf16 beside that floor
        mamba_continuation(cfg, params, dev, 256, check=False)
        mamba_noise_floor(cfg, params, dev)
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        p32 = T.init_model(cfg32, seed=0, device=dev)
        for S in (256, 512, 1024):
            mamba_continuation(cfg32, p32, dev, S)
        mamba_engine(cfg32, p32, dev, check=True)
        del p32
        torch.cuda.empty_cache()
        ms["engine"] = mamba_engine(cfg, params, dev, check=False)
        del params
        torch.cuda.empty_cache()
        ms["serve.py"] = mamba_serve_batch()
    else:
        S = 300 if cfg.num_patches else 200  # internvl2's prompts cover its patches
        prefill_decode_vs_plain(f"[14] {arch}", cfg, params, dev, ("flash", int8), S=S,
                                cache_len=512)
        gen = torch.Generator(device=dev).manual_seed(9)
        extra = {k: v[0] for k, v in stub_inputs(cfg, 1, gen, dev).items()}
        cache_len = 1024 if cfg.num_patches else 256  # whisper's prompts are short
        ms["engine"] = 1e3 * zoo_engines(arch, cfg, params, dev, lens, cache_len, total,
                                         runs=ENGINE_RUNS[:2], extra=extra, phase=14)[0]
        del params
        torch.cuda.empty_cache()
        ms["serve.py"] = zoo_serve_batch(arch, 4, dev, total, phase=14,
                                         S=256 if cfg.num_patches else 200)
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"[14] {arch} ({card}): peak memory {peak / 2**30:.2f} GiB of the card's "
        f"{capacity / 2**30:.2f} GiB; ms/token "
        f"{', '.join(f'{k} {v:.2f}' for k, v in ms.items())}; "
        f"{time.perf_counter() - t0:.1f} s; launches "
        f"{ {k: v for k, v in total.items() if v} }")
    torch.cuda.empty_cache()
    return total


# ----------------------------------------------------------------- phase 18
# llama4-scout-17b-a16e (106.7 B parameters, 213 GB in bf16) at full width
# and the depth its dry run picks: the deepest whose predicted peak on one
# device, for this phase's own shapes, stays within P18_PEAK_GIB
P18_PEAK_GIB = 70.0
P18_MIN_LAYERS = 8
# 18b: the dry run's predicted peak against the card's (PERF.md section 2)
DRYRUN_PEAK_REL = 0.05
P18_PAIR = ["--arch", LLAMA4, "--shape", "decode_32k"]


def _storage_bytes(tree) -> int:
    """Bytes of the distinct storages under ``tree`` (the dry run's count)."""
    from repro_torch.launch.op_cost import _tensors

    seen = {}
    for t in _tensors(tree):
        st = t.untyped_storage()
        seen[st.data_ptr()] = st.nbytes()
    return sum(seen.values())


def llama4_depth(cfg) -> tuple[int, dict]:
    """The deepest llama4 (at least P18_MIN_LAYERS) whose dry-run peak on a
    one-device mesh, for the plain prefill B4 S200 into a 256-row cache and
    the decode step after it, is at most P18_PEAK_GIB; returns it and its
    traces.  A layer adds the same bytes, so two depths give the slope and
    one more trace confirms the pick."""
    from repro_torch.launch.dryrun import trace_on_one_device

    limit = P18_PEAK_GIB * 2**30

    def traces(layers):
        c = dataclasses.replace(cfg, num_layers=layers)
        return {step: trace_on_one_device(c, step, batch=4, seq=200, cache_len=256)
                for step in ("prefill", "decode")}

    def peak(tr):
        return max(t.mem["peak_bytes"] for t in tr.values())

    t0 = time.perf_counter()
    low = traces(P18_MIN_LAYERS)
    per_layer = peak(traces(P18_MIN_LAYERS + 1)) - peak(low)
    depth = min(cfg.num_layers, P18_MIN_LAYERS + int((limit - peak(low)) // per_layer))
    picked = traces(depth)
    while peak(picked) > limit and depth > P18_MIN_LAYERS:
        depth -= 1
        picked = traces(depth)
    log(f"[18] dry run on a one-device mesh: peak {peak(low) / 2**30:.2f} GiB at "
        f"{P18_MIN_LAYERS} layers, {per_layer / 2**30:.3f} GiB a layer; {depth} layers peak "
        f"{peak(picked) / 2**30:.2f} GiB (limit {P18_PEAK_GIB} GiB); "
        f"{time.perf_counter() - t0:.1f} s of traces")
    if peak(picked) > limit:
        raise AssertionError(f"phase 18: no depth of {LLAMA4} fits {P18_PEAK_GIB} GiB")
    return depth, picked


def dryrun_vs_card(cfg, params, dev, traced: dict) -> None:
    """18b: the plain prefill B4 S200 (256-row cache) and one decode step
    after it on the card, against the dry run's one-device traces of the
    same calls: argument bytes exactly the bytes of the arguments on the
    card, predicted peak within DRYRUN_PEAK_REL of max_memory_allocated()."""
    import torch

    from repro_torch.models import transformer as T

    plain = dataclasses.replace(cfg, attn_kernel=None, quantized_kv=False)
    gen = torch.Generator(device=dev).manual_seed(18)
    tokens = torch.randint(0, cfg.vocab_size, (4, 200), generator=gen, device=dev,
                           dtype=torch.int32)
    failures = []

    def measured(label, tr, args, fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_allocated(dev)
        out = fn()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev)
        have = _storage_bytes(args)
        pred = tr.mem["peak_bytes"]
        rel = abs(pred - peak) / peak
        log(f"[18b] {label}: argument bytes dry run {tr.mem['argument_bytes']} / card {have} "
            f"({'equal' if have == tr.mem['argument_bytes'] else 'DIFFERENT'}); peak dry run "
            f"{pred / 2**30:.3f} GiB / card {peak / 2**30:.3f} GiB (allocated before "
            f"{before / 2**30:.3f} GiB): {rel:.2%} apart (bound {DRYRUN_PEAK_REL:.0%}); output "
            f"{tr.mem['output_bytes'] / 2**20:.1f} MiB, temporaries "
            f"{tr.mem['temp_bytes'] / 2**20:.1f} MiB; traced in {tr.seconds:.1f} s")
        if have != tr.mem["argument_bytes"] or rel > DRYRUN_PEAK_REL:
            failures.append(label)
        return out

    logits, cache = measured("plain prefill B4 S200, 256-row cache", traced["prefill"],
                             (params, tokens),
                             lambda: T.prefill(params, {"tokens": tokens}, plain, 256))
    tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
    pos = torch.tensor(200, dtype=torch.int32, device=dev)
    del logits
    torch.cuda.empty_cache()
    logits, _ = measured("plain decode step at position 200", traced["decode"],
                         (params, cache, tok, pos),
                         lambda: T.decode_step(params, tok, cache, pos, plain))
    if not bool(torch.isfinite(logits).all()):
        failures.append("non-finite decode logits")
    del logits, cache
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError(f"phase 18b: the dry run disagrees with the card: {failures}")


def dryrun_pair() -> None:
    """18b: one production pair end to end, ``launch/dryrun.py`` in its own
    process (the fake 256-rank world of the 16x16 mesh, fake tensors): its
    row and seconds."""
    import tempfile

    with tempfile.TemporaryDirectory() as out:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", *P18_PAIR, "--out-dir", out]
        t0 = time.perf_counter()
        run = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=900,
                             env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
        secs = time.perf_counter() - t0
        rows = [json.loads(p.read_text()) for p in sorted(Path(out).glob("*.json"))]
    for line in run.stdout.splitlines()[-4:]:
        log(f"[18b]   {line}")
    if run.returncode != 0 or len(rows) != 1:
        log(run.stderr[-3000:])
        raise AssertionError(f"phase 18b: dryrun {' '.join(P18_PAIR)} failed ({run.returncode})")
    row = rows[0]
    log(f"[18b] dryrun {' '.join(P18_PAIR)} @ 16x16 in {secs:.1f} s (process): "
        f"{json.dumps(row)}")


def llama4_full_width(dev) -> dict[str, int]:
    """Phase 18: llama4-scout-17b-a16e at full width (d 5120, 40 heads on 8,
    16 experts top-1 + shared, vocab 202048) and the depth the dry run picks
    (18b checks the dry run against the card); prefill + decode with flash
    and block-sparse against the plain path, routing pinned; the engine at
    12 slots with flash, flash + int8 KV and block-sparse.  Returns the
    launch counts."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models import transformer as T

    card = gpu_name_and_limit()
    capacity = torch.cuda.get_device_properties(dev).total_memory
    full = get_config(LLAMA4)
    depth, traced = llama4_depth(full)
    cfg = dataclasses.replace(full, num_layers=depth)
    total = {name: 0 for name in _build.COUNTERS}
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    log(f"[18] {LLAMA4}: {T.param_count(full) / 1e9:.3f} B parameters at full depth "
        f"({full.num_layers} layers); here {depth} layers (the dry run's pick): "
        f"{T.param_count(cfg) / 1e9:.3f} B ({T.active_param_count(cfg) / 1e9:.3f} B active) in "
        f"{cfg.dtype}, hd {cfg.hd}, {cfg.num_heads // cfg.num_kv_heads} query heads per kv head")
    params = T.init_model(cfg, seed=0, device=dev)
    dryrun_vs_card(cfg, params, dev, traced)
    prefill_decode_vs_plain(f"[18] {LLAMA4}", cfg, params, dev, ("flash", "block_sparse"))
    ms = 1e3 * zoo_engines(LLAMA4, cfg, params, dev, FAMILY_LENS["deepseek-moe-16b"], 1024,
                           total, slots=12, phase=18)[0]
    peak = torch.cuda.max_memory_allocated(dev)
    del params
    torch.cuda.empty_cache()
    dryrun_pair()
    log(f"[18] {LLAMA4} ({card}): peak memory {peak / 2**30:.2f} GiB of the card's "
        f"{capacity / 2**30:.2f} GiB; ms/token engine {ms:.2f}; "
        f"{time.perf_counter() - t0:.1f} s; launches { {k: v for k, v in total.items() if v} }")
    return total


# ----------------------------------------------------------------- phase 15
P15_ARGS = ["--arch", QWEN, "--batch-per-node", "4", "--seq", "128", "--compressor", "kq4b",
            "--log-every", "1"]
P15_DROPOUT = "0.25"
# Table 5 on rotated_minority, the reference's quick run (``python -m
# benchmarks.run --only T5``, JAX on the CPU): worst-node accuracy
# (mean of seeds 0 and 1) and bits per gradient iteration of the busiest node
T5_REFERENCE = {"AD-GDA-GT-K5": (0.796875, 902.4), "AD-GDA": (0.77734375, 2896.0),
                "DR-DSGD": (0.7470703125, 8704.0), "CHOCO-SGD": (0.70703125, 1616.0),
                "AD-GDA-K5": (0.6181640625, 579.2), "DRFA": (0.3916015625, 2176.0)}
# DRFA's client samples in that run (one bitmask of the 10 nodes per round,
# 60 rounds): lambda never returns to a node it left out, so the first draw
# decides whether the minority nodes take part at all (seed 0: never, worst
# accuracy 0.0039; seed 1: yes, 0.7793); the card's run is held on these
DRFA_REFERENCE_SAMPLES = {
    0: (668,) * 60,
    1: (818, 818, 818, 583, 426, 714, 678, 334, 555, 271, 391, 271, 419, 283, 395, 587, 555,
        395, 675, 115, 91, 651, 803, 803, 79, 279, 295, 787, 803, 79, 171, 647, 87, 587, 451,
        47, 47, 647, 279, 103, 307, 279, 107, 299, 203, 551, 179, 295, 31, 103, 647, 403, 535,
        555, 107, 659, 155, 79, 803, 103),
}
FT_ACC_BAND = 0.05  # the reference's own band (benchmarks/check_regression.py)
# processes on the card for 15d, one per host core but the one 15c runs on
# beside it: 15d's rounds are host-bound
P15_WORKERS = 7


def _round_rows(state):
    """Per node-stacked leaf of a trainer state: theta, theta_hat, s and the
    optimizer moments (empty without momentum)."""
    from repro_torch.tree import leaves

    opt = state.opt
    return (leaves(state.theta) + leaves(state.consensus.theta_hat)
            + leaves(state.consensus.s) + [x for part in (opt.mu, opt.nu) for x in part])


def _bits(x):
    """``x`` viewed as integers of its width: equal means equal bit for bit
    (``torch.equal`` on floats holds -0.0 equal to 0.0 and NaN unequal)."""
    import torch

    return x.view({1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
                  [x.element_size()])


def _host_rows(rows, i: int, slot: int, pool: dict) -> list:
    """Row ``i`` of each leaf in ``rows``, copied into one host buffer per
    ``slot`` (the dropped node's place in its round) that later rounds
    reuse.  On a card the buffer is page-locked with ``cudaHostRegister``
    (a fresh pageable copy of a node's 10.3 GB runs at ~3 GB/s), and
    :func:`_release_rows` unlocks and frees it: the caching host allocator
    of ``pin_memory=True`` would keep it locked for the phases after."""
    import torch

    sizes = [x[i].numel() * x.element_size() for x in rows]
    offsets = [0]
    for n in sizes:
        offsets.append(offsets[-1] + -(-n // 64) * 64)
    buf = pool.get(slot)
    if buf is None or buf.numel() < offsets[-1]:
        _release_rows({slot: pool.pop(slot)} if buf is not None else {})
        buf = pool[slot] = torch.empty(offsets[-1], dtype=torch.uint8)
        if torch.cuda.is_available():
            torch.cuda.check_error(torch.cuda.cudart().cudaHostRegister(
                buf.data_ptr(), buf.numel(), 0))
    return [buf[o:o + n].view(x.dtype).view(x.shape[1:]).copy_(x[i])
            for x, o, n in zip(rows, offsets, sizes)]


def _release_rows(pool: dict) -> None:
    import torch

    for buf in pool.values():
        if torch.cuda.is_available():
            torch.cuda.check_error(torch.cuda.cudart().cudaHostUnregister(buf.data_ptr()))
    pool.clear()


def _chunk_plan(cfg, m: int) -> int:
    import torch

    from repro_torch.core.gossip import _scan_plan
    from repro_torch.models import transformer as T
    from repro_torch.tree import leaves

    n = 0
    for p in leaves(T.abstract_train_params(cfg)):
        plan = _scan_plan((m,) + tuple(p.shape), int(torch.Size(p.shape).numel()), 1 << 24)
        n += 1 if plan is None else plan[1]
    return n


def masked_full_width(dev, total) -> dict:
    """15a: masked rounds at full width -- 4 nodes, 25% dropout, round-robin
    ring + torus and one-peer matchings with ``kq4b``, round-robin with
    block top-k on its kernel, and 2 nodes on the ring with SGD momentum 0.9
    (the moments' revert; 4 nodes' f32 moments do not fit beside the round).
    Each dropped node's rows are copied to the host before its round and
    compared with the rows after it bit for bit."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.core.gossip import payload_bits
    from repro_torch.core.topology import make_topology_schedule
    from repro_torch.kernels import _build
    from repro_torch.kernels.ops import KernelBlockTopK, KernelQuantization
    from repro_torch.launch import train
    from repro_torch.models import transformer as T
    from repro_torch.tree import leaves

    cfg = get_config(QWEN)
    topk = KernelBlockTopK(0.25, 1024)
    pinned: dict = {}  # host buffers of the dropped rows, kept across rounds and runs
    # name, nodes, rounds, schedule spec, extra flags, compressor object; the
    # 4-node runs' masks drop node 0 in round 0 and nodes 1, 3 in round 1, and
    # round 2 rejoins them (a fourth round, all alive, was cut for phase 17's time)
    runs = (("roundrobin", 4, 3, "roundrobin:ring,torus", [], None),
            ("matching", 4, 3, "matching:8", [], None),
            ("block_topk", 4, 3, "roundrobin:ring,torus", [], topk),
            # the seed drops node 1 in round 2, after two rounds of momentum
            ("momentum", 2, 3, "ring", ["--momentum", "0.9"], None))
    out = {}
    for name, m, steps, spec, extra, comp in runs:
        n_enc = _chunk_plan(cfg, m)
        template = [torch.empty((m,) + tuple(p.shape), device="meta")
                    for p in leaves(T.abstract_train_params(cfg))]
        argv = P15_ARGS + ["--nodes", str(m), "--steps", str(steps), "--topology-schedule",
                           spec, "--dropout", P15_DROPOUT] + extra
        log(f"[15a] launch/train.py {' '.join(argv)}"
            + (f" with compressor={comp!r} in place of the spec" if comp else ""))
        sched = make_topology_schedule(spec, m, dropout=float(P15_DROPOUT))
        want_bits = (payload_bits(comp or KernelQuantization(4), template, sched)
                     + 32.0 * m * sched.max_degree)
        expect = ({"block_topk": n_enc} if comp else
                  {"quantize": m * n_enc, "dequantize": m * n_enc})
        frozen, prof_out, round_s, copy_s = [], {}, [], []

        def wrap_step(step, run, state):
            # the round's mask, drawn ahead on a copy of the mask generator
            gen = torch.Generator()
            gen.set_state(state.mask_generator.get_state())
            dropped = [i for i, a in enumerate(sched.mask_at(gen, state.step).tolist())
                       if a <= 0]
            t0 = time.perf_counter()
            saved = {i: _host_rows(_round_rows(state), i, slot, pinned)
                     for slot, i in enumerate(dropped)}
            copy_s.append(time.perf_counter() - t0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if step == 1 and name == "roundrobin":  # one profiled round
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    new, aux = run()
                    torch.cuda.synchronize()
                    prof_out.update(prof=prof, wall=time.perf_counter() - t0)
            else:
                new, aux = run()
                torch.cuda.synchronize()
            round_s.append(time.perf_counter() - t0)
            alive = aux["participation"].tolist()
            if [i for i, a in enumerate(alive) if a == 0] != dropped:
                raise AssertionError(f"phase 15a {name}: round {step} dropped "
                                     f"{alive}, the mask generator's copy gave {dropped}")
            t0 = time.perf_counter()
            for i, rows in saved.items():
                same = all(torch.equal(_bits(x[i]), _bits(old.to(x.device)))
                           for x, old in zip(_round_rows(new), rows))
                frozen.append((step, i, same))
            copy_s[-1] += time.perf_counter() - t0
            del saved
            return new, aux

        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        metrics = train.main(argv, wrap_step=wrap_step, compressor=comp)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = _build.launch_counts()
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        peak = torch.cuda.max_memory_allocated() / 2**30
        hist = metrics["history"]
        masks = [h["participation"] for h in hist]
        kept = "theta, theta_hat, s" + (", the momentum" if extra else "")
        log(f"[15a] {name}: masks per round {masks}; dropped nodes' {kept} equal to the "
            f"host copy bit for bit (step, node, kept): {frozen}; host copies and "
            f"comparisons {sum(copy_s):.1f} s")
        log(f"[15a] {name}: launches {({k: v for k, v in counts.items() if v})}; chunk plan "
            f"{n_enc} encodes per round, expected per round {expect}; peak memory {peak:.2f} GiB; "
            f"{secs:.1f} s; s per round {[round(x, 3) for x in round_s]} (the host copies "
            f"aside{'; round 1 profiled' if prof_out else ''})")
        log(f"[15a] {name}: bits/round {metrics['bits_per_round']:.6e} (payload_bits at the "
            f"schedule's max degree {sched.max_degree} + the dual: {want_bits:.6e}); realized "
            f"{[h['bits_realized'] for h in hist]}; losses {[h['losses'] for h in hist]}; "
            f"consensus error {[h['consensus_err'] for h in hist]}")
        pb = None
        if prof_out:
            pb = _profile_breakdown(prof_out.pop("prof"), prof_out["wall"])
            log(f"[15a] {name} round 1 under torch.profiler: wall {pb['wall_ms']:.1f} ms, "
                f"kernels busy {pb['busy_ms']:.1f} ms ({pb['busy_ms'] / pb['wall_ms']:.1%} of the "
                f"wall); kernel ms by section {({k: round(v, 1) for k, v in pb['busy'].items()})}"
                f"; device span ms by section "
                f"{({k: round(v, 1) for k, v in pb['spans_ms'].items()})}; read in "
                f"{pb['read_s']:.1f} s")
            for ms_, count, key in pb["top"]:
                log(f"[15a]   {ms_:9.2f} ms x{count:<6d} {key[:90]}")
        for k, per_round in expect.items():
            if counts[k] != per_round * steps:
                raise AssertionError(f"phase 15a {name}: {k} launched {counts[k]} times, the "
                                     f"chunk plan gives {per_round} x {steps}")
        if not frozen or not all(f[2] for f in frozen):
            raise AssertionError(f"phase 15a {name}: no node dropped, or a dropped node's "
                                 f"state moved: {frozen}")
        if extra and not any(f[0] > 0 for f in frozen):
            raise AssertionError(f"phase 15a {name}: no node dropped after round 0, so the "
                                 f"momentum it would revert is zero: {frozen}")
        finite = all(math.isfinite(x) for h in hist for x in h["losses"] + [h["consensus_err"]])
        if not finite or metrics["bits_per_round"] != want_bits:
            raise AssertionError(f"phase 15a {name}: non-finite losses / consensus error, or "
                                 f"bits/round != payload_bits at the max degree + the dual")
        out[name] = {"s_per_round": round_s, "peak_gib": peak, "profile": pb}
        del metrics
    _release_rows(pinned)  # a failed check ends the script, which frees them
    return out


def gt_full_width(dev, total) -> dict:
    """15b: gradient tracking with 4 local steps on 2 nodes, ``kq4b`` fused
    then packed, both lanes through the kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.launch import train
    from repro_torch.models import transformer as T

    cfg = get_config(QWEN)
    m, steps, K = 2, 2, 4  # two rounds: the second is the "later" one (a third was cut)
    n_enc = _chunk_plan(cfg, m)
    shifts = 2  # ring(2) is the 2-node mesh: shifts 0 and 1
    expect = {"fused": {"fused_encode": 2 * n_enc, "fused_mix": 2 * n_enc * -(-shifts // 8)},
              "packed": {"quantize": 2 * m * n_enc, "dequantize": 2 * m * (1 + shifts) * n_enc}}
    runs, out = {}, {}
    for name, extra in (("fused", ["--fused-gossip"]), ("packed", [])):
        argv = P15_ARGS + ["--nodes", str(m), "--steps", str(steps), "--consensus", "gt",
                           "--local-steps", str(K)] + extra
        log(f"[15b] launch/train.py {' '.join(argv)}")
        prof_out = {}

        def wrap_step(step, run, state):
            if step != 1 or name != "fused":  # one profiled round
                return run()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                res = run()
                torch.cuda.synchronize()
                prof_out.update(prof=prof, wall=time.perf_counter() - t0)
            return res

        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        metrics = train.main(argv, wrap_step=wrap_step)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = _build.launch_counts()
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        peak = torch.cuda.max_memory_allocated() / 2**30
        hist = metrics["history"]
        log(f"[15b] gt {name}: launches {({k: v for k, v in counts.items() if v})}, expected "
            f"per round {expect[name]} (2 lanes x the chunk plan's {n_enc} encodes); peak "
            f"memory {peak:.2f} GiB (7 theta-sized bf16 trees "
            f"{7 * 2 * m * T.param_count(cfg) / 1e9:.1f} GB + theta_prev + the gradients); "
            f"{secs:.1f} s; s/step "
            f"{[round(x, 3) for x in metrics['step_seconds']]}; bits/round "
            f"{metrics['bits_per_round']:.6e}; losses {[h['losses'] for h in hist]}")
        pb = None
        if prof_out:
            pb = _profile_breakdown(prof_out.pop("prof"), prof_out["wall"])
            log(f"[15b] gt {name} round 1 under torch.profiler: wall {pb['wall_ms']:.1f} ms, "
                f"kernels busy {pb['busy_ms']:.1f} ms ({pb['busy_ms'] / pb['wall_ms']:.1%}); "
                f"kernel ms by section {({k: round(v, 1) for k, v in pb['busy'].items()})}; "
                f"device span ms by section "
                f"{({k: round(v, 1) for k, v in pb['spans_ms'].items()})}; read in "
                f"{pb['read_s']:.1f} s")
            for ms_, count, key in pb["top"]:
                log(f"[15b]   {ms_:9.2f} ms x{count:<6d} {key[:90]}")
        for k, per_round in expect[name].items():
            if counts[k] != per_round * steps:
                raise AssertionError(f"phase 15b {name}: {k} launched {counts[k]} times, the "
                                     f"chunk plan gives {per_round} x {steps}")
        if not all(math.isfinite(x) for h in hist for x in h["losses"] + [h["consensus_err"]]):
            raise AssertionError(f"phase 15b {name}: non-finite losses or consensus error")
        runs[name] = hist
        out[name] = {"s_per_round": metrics["step_seconds"], "peak_gib": peak, "profile": pb}
        del metrics
    f, p = runs["fused"], runs["packed"]
    if f[0]["losses"] != p[0]["losses"]:
        raise AssertionError(f"phase 15b: step-0 losses differ: {f[0]['losses']} / "
                             f"{p[0]['losses']}")
    rel = max(abs(a - b) / abs(b) for s_ in range(1, steps)
              for a, b in zip(f[s_]["losses"], p[s_]["losses"]))
    log(f"[15b] step-0 losses equal (fused == packed); later steps max relative difference "
        f"{rel:.3e} (bound {LOSS_REL_BOUND})")
    if rel > LOSS_REL_BOUND:
        raise AssertionError("phase 15b: fused and packed gradient tracking disagree")
    return out


def resume_full_width(dev, total) -> dict:
    """15c: run A (4 rounds straight), run B (2 rounds, checkpointed), run C
    (resumed from B to 4): C's losses and final theta against A's."""
    import shutil
    import tempfile

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.launch import train
    from repro_torch.models import transformer as T
    from repro_torch.tree import leaves

    cfg = get_config(QWEN)
    m = 2
    n_params = T.param_count(cfg)
    # two state files (theta, theta_hat, s in bf16) and the f32 model file
    need = 2 * 3 * m * 2 * n_params + 4 * n_params
    base = max((Path(tempfile.gettempdir()), ROOT), key=lambda d: shutil.disk_usage(d).free)
    free = shutil.disk_usage(base).free
    log(f"[15c] disk under {base}: {free / 1e9:.1f} GB free, the checkpoints need "
        f"{need / 1e9:.1f} GB")
    if free < need * 1.05:
        raise AssertionError(f"phase 15c: {free / 1e9:.1f} GB free under {base}, "
                             f"{need / 1e9:.1f} GB needed")
    tmp = Path(tempfile.mkdtemp(prefix="p15c_", dir=base))
    ck = str(tmp / "run")
    argv = P15_ARGS + ["--nodes", str(m), "--fused-gossip"]

    def run(label, extra):
        log(f"[15c] {label}: launch/train.py {' '.join(argv + extra)}")
        torch.cuda.empty_cache()
        _build.reset_launch_counts()
        kept = {}

        def wrap_step(step, run_, state):  # keeps the final state's theta
            new, aux = run_()
            kept["theta"] = new.theta
            return new, aux

        t0 = time.perf_counter()
        metrics = train.main(argv + extra, wrap_step=wrap_step)
        torch.cuda.synchronize()
        for k, v in _build.launch_counts().items():
            total[k] = total.get(k, 0) + v
        theta = [x.cpu() for x in leaves(kept.pop("theta"))]
        torch.cuda.empty_cache()
        log(f"[15c] {label}: {time.perf_counter() - t0:.1f} s; losses "
            f"{[h['losses'] for h in metrics['history']]}; checkpoint io "
            f"{metrics['checkpoint_io']}")
        return metrics, theta

    try:
        a, theta_a = run("A", ["--steps", "4"])
        b, _ = run("B", ["--steps", "2", "--checkpoint", ck])
        model_file = tmp / "run_model.npz"
        log(f"[15c] B wrote {sorted(f.name for f in tmp.iterdir())}; the model file "
            f"{model_file.stat().st_size / 1e9:.2f} GB")
        model_file.unlink()
        c, theta_c = run("C", ["--steps", "4", "--checkpoint", ck, "--resume"])
        losses_a = [h["losses"] for h in a["history"][2:]]
        losses_c = [h["losses"] for h in c["history"]]
        exact = (c["start_step"] == 2 and losses_a == losses_c
                 and all(torch.equal(x, y) for x, y in zip(theta_a, theta_c)))
        log(f"[15c] C resumed at step {c['start_step']}: losses of steps 2-3 and the final "
            f"theta equal to A's bit for bit: {exact}")
        gap = None
        if not exact:  # is the card's forward / backward itself repeatable?
            a2, theta_a2 = run("A again", ["--steps", "4"])
            dev_ = lambda u, v: max(float((x.float() - y.float()).abs().max())
                                    for x, y in zip(u, v))
            gap = dev_(theta_a, theta_a2)
            off = dev_(theta_a, theta_c)
            log(f"[15c] A against A again: theta max |diff| {gap:.3e}, losses "
                f"{[h['losses'] for h in a2['history'][2:]]}; C against A: {off:.3e}")
            if c["start_step"] != 2 or off > gap:
                raise AssertionError("phase 15c: the resumed run departs from the "
                                     "uninterrupted one by more than two uninterrupted runs do")
        io = {"save_seconds": b["checkpoint_io"]["save_seconds"]
              + c["checkpoint_io"]["save_seconds"],
              "save_bytes": b["checkpoint_io"]["save_bytes"] + c["checkpoint_io"]["save_bytes"],
              "restore_seconds": c["checkpoint_io"]["restore_seconds"], "exact": exact,
              "gap": gap}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return io


def comparisons_on_card(dev, total) -> dict:
    """15d: the paper's small-model comparisons on the card with the
    reference's settings (10 nodes, logistic, ``kq4b``), seeds 0 and 1:
    FT's fault-free rows, the ksweep anchors, Table 5 on rotated_minority."""
    from repro_torch.launch import comparisons as C

    ft_ref = {(r["schedule"], r["dropout"]): r
              for r in json.loads((ROOT / "BENCH_FT.json").read_text())["rows"]
              if r["fault_spec"] == "none" and r["schedule"] in C.FT_SCHEDULES}
    task_list = C.tasks()
    task_list = [t + (DRFA_REFERENCE_SAMPLES[t[2]],) if t[1] == "DRFA" else t
                 for t in task_list] + [("t5", "DRFA", seed) for seed in (0, 1)]
    t0 = time.perf_counter()
    results = C.run_tasks(task_list, dev, workers=P15_WORKERS)
    secs = time.perf_counter() - t0
    own = [r for r in results if r["name"] == "DRFA" and r["samples"] == "own"]
    rows = C.summarize([r for r in results if r not in own])
    for r in results:
        for k, v in r["launches"].items():
            total[k] = total.get(k, 0) + v
    log(f"[15d] {len(results)} runs in {P15_WORKERS} processes on the card: {secs:.1f} s; "
        f"seconds per run {[round(r['seconds'], 1) for r in results]}")
    failures = []
    for sched in C.FT_SCHEDULES:
        for d in C.FT_DROPOUTS:
            got, ref = rows[("ft", f"{sched}|{d:g}")], ft_ref[(sched, d)]
            ok = (got["bits_per_round"] == ref["bits_per_round"]
                  and got["bits_per_round_expected"] == ref["bits_per_round_expected"]
                  and got["worst_acc"] >= ref["worst_acc"] - FT_ACC_BAND)
            log(f"[15d] FT {sched} dropout {d}: worst_acc {got['worst_acc']:.4f} (reference "
                f"{ref['worst_acc']:.4f}, must be >= -{FT_ACC_BAND}); bits/round "
                f"{got['bits_per_round']} / expected {got['bits_per_round_expected']} "
                f"(reference {ref['bits_per_round']} / {ref['bits_per_round_expected']}); "
                f"realized {got['bits_per_round_realized']:.2f}; {'ok' if ok else 'FAILED'}")
            if not ok:
                failures.append(f"FT {sched} {d}")
    gt, ch8, ch16 = (rows[("ksweep", n)] for n in ("gt@16", "choco@8", "choco@16"))
    ok = (gt["worst_acc"] > ch8["worst_acc"] and gt["worst_acc"] > ch16["worst_acc"]
          and gt["bits_realized_total"] <= 1.05 * ch8["bits_realized_total"])
    log(f"[15d] ksweep: worst_acc gt@16 {gt['worst_acc']:.4f} (must be > choco@8 "
        f"{ch8['worst_acc']:.4f} and choco@16 {ch16['worst_acc']:.4f}); total bits gt@16 "
        f"{gt['bits_realized_total']:.0f} (must be <= 1.05 x choco@8's "
        f"{ch8['bits_realized_total']:.0f}); bits/round gt {gt['bits_per_round']} choco "
        f"{ch8['bits_per_round']}; {'ok' if ok else 'FAILED'}")
    if not ok:
        failures.append("ksweep")
    order = list(T5_REFERENCE)  # the reference's order, best first
    accs = {n: rows[("t5", n)]["worst_acc"] for n in order}
    for n in order:
        got = rows[("t5", n)]
        log(f"[15d] T5 {n}: worst_acc {got['worst_acc']:.4f} (reference "
            f"{T5_REFERENCE[n][0]:.4f}); bits per iteration {got['bits_per_iteration']} "
            f"(reference {T5_REFERENCE[n][1]})")
        if got["bits_per_iteration"] != T5_REFERENCE[n][1]:
            failures.append(f"T5 bits {n}")
    ordered = all(accs[a] > accs[b] for a, b in zip(order, order[1:]))
    log(f"[15d] T5 worst-accuracy order {' > '.join(order)}: {'held' if ordered else 'BROKEN'}"
        f" (DRFA on the reference's client samples); DRFA on the port's own samples: "
        f"{[round(r['worst_acc'], 4) for r in own]} (seeds 0, 1; not held: see "
        f"DRFA_REFERENCE_SAMPLES)")
    if not ordered:
        failures.append("T5 order")
    if failures:
        raise AssertionError(f"phase 15d: {failures}")
    return {"seconds": secs, "rows": {f"{k[0]}|{k[1]}": v for k, v in rows.items()}}


def trainer_breadth(dev) -> tuple[dict[str, int], dict]:
    """Phase 15: 15a, 15b and 15c with 15d beside them (15d's processes are
    host-bound and light on the card, the others at 7 layers short of its
    time); returns the gossip kernels' launch counts and 15d's rows (FT's
    faulted rows among them, which phase 16b holds)."""
    import concurrent.futures as cf

    total: dict[str, int] = {}
    t0 = time.perf_counter()
    side: dict[str, int] = {}  # 15d's launches, counted in its own processes
    with cf.ThreadPoolExecutor(1) as pool:
        comparisons = pool.submit(comparisons_on_card, dev, side)
        for label, fn in (("15a", masked_full_width), ("15b", gt_full_width),
                          ("15c", resume_full_width)):
            t1 = time.perf_counter()
            with _cut_depth(CUT_LAYERS, tag=label):
                fn(dev, total)
            log(f"[{label}] took {time.perf_counter() - t1:.1f} s (15d beside it)")
        rows = comparisons.result()["rows"]
    log(f"[15a-15d] took {time.perf_counter() - t0:.1f} s")
    for k, v in side.items():
        total[k] = total.get(k, 0) + v
    return total, rows


# ----------------------------------------------------------------- phase 16
P16_SPEC = "drop:0.2,corrupt:0.1,stale:0"
# the events depend on the fault generator alone; under this spec on a
# 3-node ring, 95.9% of 2000 generator seeds draw a drop, a corrupt, a
# verified and a failed resync within 8 rounds (70.6% within 4), a host-side
# count made before choosing the rounds (see PERF.md)
P16_ROUNDS = 8


def _chunk_digests(trees):
    """Per (tree, leaf, chunk) the [m] int32 digests (``core.faults.digest``)
    of the gossip's chunks, stacked: [chunks, m] on the device."""
    import torch

    from repro_torch.core.faults import digest
    from repro_torch.core.gossip import _chunk_views, _scan_plan
    from repro_torch.tree import leaves

    out = []
    for tree in trees:
        for leaf in leaves(tree):
            plan = _scan_plan(tuple(leaf.shape), leaf[0].numel(), 1 << 24)
            out += [digest(c) for c in ([leaf] if plan is None else _chunk_views(leaf, plan))]
    return torch.stack(out)


def _wire_bits(ev, want, union, msg_bits) -> "np.ndarray":
    """The delivered-bits meter from a round's events, on the host, in f32 as
    the reference's formula: per sender and op, 0 for a drop, 2x for a dup,
    else 1x of (payload + digest lane + the dense hat when its receiver
    asked for a resync)."""
    import numpy as np

    from repro_torch.core.faults import receiver_maps

    payload, dig, dense = msg_bits
    mult = np.where(ev.drop.numpy(), 0.0, np.where(ev.dup.numpy(), 2.0, 1.0)).astype(np.float32)
    bits = np.zeros(union.num_nodes, np.float32)
    for k, rcv in enumerate(receiver_maps(union)):
        for j, i in enumerate(rcv):
            if i >= 0:
                msg = np.float32(payload + dig) + np.float32(float(want[k, i])) * np.float32(dense)
                bits[j] = np.float32(bits[j] + mult[k, i] * msg)
    return bits


def faulted_full_width(dev, total) -> dict:
    """16a: the faulted wire on qwen3-1.7b at full width, 3 nodes on a ring,
    ``kq4b``, packed then fused on the same seeds."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.core import faults as F
    from repro_torch.core.exchange import wire_msg_bits
    from repro_torch.core.topology import compile_permute_plan, make_topology
    from repro_torch.core.wire import compile_union_wire
    from repro_torch.kernels import _build
    from repro_torch.kernels.ops import KernelQuantization
    from repro_torch.launch import train
    from repro_torch.tree import leaves

    cfg = get_config(QWEN)
    m, spec = 3, F.parse_fault_spec(P16_SPEC)
    n_enc = _chunk_plan(cfg, m)
    union = compile_union_wire((compile_permute_plan(make_topology("ring", m)),))
    dual_bits = np.float32(32.0 * m * 2)  # the lambda gossip's constant: m floats, degree 2
    zero = {k: 0 for k in GOSSIP_KERNELS}
    expect = {"packed": {**zero, "quantize": m * n_enc, "dequantize": m * n_enc},
              "fused": {**zero, "fused_encode_digest": n_enc, "dequantize": m * n_enc}}
    argv = P15_ARGS + ["--nodes", str(m), "--steps", str(P16_ROUNDS), "--topology", "ring",
                       "--fault-spec", P16_SPEC]

    def trees(state):
        cons = state.consensus
        return [state.theta, cons.theta_hat, cons.s, *cons.cache]

    def two_leaves(state):  # the embeddings and layer 0's wq of every tree
        return [t for tree in trees(state)
                for t in (tree["embed"]["table"], tree["blocks"][0]["mixer"]["wq"][:, 0])]

    runs, out = {}, {}
    for name, extra in (("packed", []), ("fused", ["--fused-gossip"])):
        rec, prof_out = [], {}
        cover = {"drop": False, "corrupt": False, "resync_ok": False, "resync_failed": False}

        def wrap_step(step, run, state):
            gen = torch.Generator()  # the round's draw, ahead, on a copy of the fault generator
            gen.set_state(state.fault_generator.get_state())
            ev = F.sample_events(spec, torch.rand((union.n_ops, m), generator=gen))
            before = F.FaultState(*(x.cpu() for x in state.consensus.fault))
            want = ((before.stale.T > spec.stale) & (before.wait.T <= 0)).numpy()
            msg_bits = wire_msg_bits(KernelQuantization(4), state.theta)
            counts0 = _build.launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if step == 1 and name == "fused":  # one profiled round
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    new, aux = run()
                    torch.cuda.synchronize()
                    prof_out.update(prof=prof, wall=time.perf_counter() - t0)
            else:
                new, aux = run()
                torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            counts = {k: v - counts0.get(k, 0) for k, v in _build.launch_counts().items()}
            got = {k: counts.get(k, 0) for k in GOSSIP_KERNELS}
            if got != expect[name]:
                raise AssertionError(f"phase 16a {name} round {step}: launches {got} != "
                                     f"{expect[name]}")
            fs = F.FaultState(*(x.cpu() for x in new.consensus.fault))
            # coverage, from the events drawn and what the state machine did
            cover["drop"] |= bool(ev.drop.any())
            cover["corrupt"] |= bool(ev.corrupt.any())
            cover["resync_ok"] |= bool((fs.resyncs > before.resyncs).any())
            cover["resync_failed"] |= bool((torch.from_numpy(want).T & (fs.synced == 0)).any())
            # the meter against the host's formula, and the trainer's realized bits
            want_bits = _wire_bits(ev, want, union, msg_bits)
            if not np.array_equal(fs.bits.numpy(), want_bits):
                raise AssertionError(f"phase 16a {name} round {step}: meter {fs.bits.tolist()} "
                                     f"!= formula {want_bits.tolist()}")
            if aux["bits_realized"] != float(np.float32(want_bits.max()) + dual_bits):
                raise AssertionError(f"phase 16a {name} round {step}: bits_realized "
                                     f"{aux['bits_realized']} != {want_bits.max()} + {dual_bits}")
            # the mirror invariant, on the device
            cons = new.consensus
            hats = leaves(cons.theta_hat)
            dig_hat = _chunk_digests([cons.theta_hat])
            for k, snd in enumerate(union.senders):
                dig_mirror = _chunk_digests([cons.cache[k]])
                for i, j in enumerate(snd):
                    if fs.synced[i, k] > 0:
                        same = all(torch.equal(_bits(mir[i]), _bits(hat[j]))
                                   for mir, hat in zip(leaves(cons.cache[k]), hats))
                        if not same:
                            raise AssertionError(f"phase 16a {name} round {step}: op {k} node "
                                                 f"{i} synced, mirror != sender {j}'s hat")
                    elif torch.equal(dig_mirror[:, i], dig_hat[:, j]):
                        raise AssertionError(f"phase 16a {name} round {step}: op {k} node {i} "
                                             f"unsynced, yet every chunk digest equals {j}'s")
            rec.append({"digests": _chunk_digests(trees(new)).cpu(),
                        "losses": aux["losses"].tolist(),
                        "consensus_err": float(aux["consensus_err"]),
                        "fault": [x.clone() for x in fs], "seconds": secs,
                        "events": {f: getattr(ev, f).int().tolist() for f in ("drop", "corrupt")},
                        "detected": fs.detected.tolist(), "resyncs": fs.resyncs.tolist(),
                        "bits": fs.bits.tolist(), "launches": got})
            if step == P16_ROUNDS - 1:  # full copies of two leaves of every tree
                if name == "packed":
                    runs["kept"] = [x.cpu() for x in two_leaves(new)]
                else:
                    rec[-1]["two_leaves_equal"] = all(
                        torch.equal(_bits(x), _bits(y.to(x.device)))
                        for x, y in zip(two_leaves(new), runs["kept"]))
            return new, aux

        log(f"[16a] launch/train.py {' '.join(argv + extra)}")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        metrics = train.main(argv + extra, wrap_step=wrap_step)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        for k, v in _build.launch_counts().items():
            total[k] = total.get(k, 0) + v
        peak = torch.cuda.max_memory_allocated() / 2**30
        hist = metrics["history"]
        log(f"[16a] {name}: {secs:.1f} s; s per round {[round(r['seconds'], 3) for r in rec]}; "
            f"peak memory {peak:.2f} GiB; launches per round {rec[0]['launches']} (= "
            f"{expect[name]}: {n_enc} chunks, {m} nodes)")
        log(f"[16a] {name}: events per round (drop, corrupt; [op][receiver]) "
            f"{[(r['events']['drop'], r['events']['corrupt']) for r in rec]}; detected "
            f"{[r['detected'] for r in rec]}; resyncs {[r['resyncs'] for r in rec]}; coverage "
            f"{cover}")
        log(f"[16a] {name}: meter per node and round (= the host's formula) "
            f"{[r['bits'] for r in rec]}; bits_realized {[h['bits_realized'] for h in hist]}; "
            f"losses {[h['losses'] for h in hist]}; consensus error "
            f"{[h['consensus_err'] for h in hist]}")
        pb = None
        if prof_out:
            pb = _profile_breakdown(prof_out.pop("prof"), prof_out["wall"])
            log(f"[16a] fused round 1 under torch.profiler: wall {pb['wall_ms']:.1f} ms, kernels "
                f"busy {pb['busy_ms']:.1f} ms ({pb['busy_ms'] / pb['wall_ms']:.1%}); kernel ms by "
                f"section {({k: round(v, 1) for k, v in pb['busy'].items()})}; device span ms "
                f"by section {({k: round(v, 1) for k, v in pb['spans_ms'].items()})}; read in "
                f"{pb['read_s']:.1f} s")
            for ms_, count, key in pb["top"]:
                log(f"[16a]   {ms_:9.2f} ms x{count:<6d} {key[:90]}")
        if not all(cover.values()):
            raise AssertionError(f"phase 16a {name}: the seed's events did not cover every "
                                 f"case: {cover}")
        if not all(math.isfinite(x) for h in hist for x in h["losses"] + [h["consensus_err"]]):
            raise AssertionError(f"phase 16a {name}: non-finite losses or consensus error")
        runs[name] = rec
        ROUND_RECORDS[f"16a/{name}"] = rec  # phase 17b's one-process reference
        out[name] = {"s_per_round": [r["seconds"] for r in rec], "peak_gib": peak,
                     "seconds": secs, "profile": pb}
        del metrics, hist
    same = []
    for r, (a, b) in enumerate(zip(runs["packed"], runs["fused"])):
        eq = (torch.equal(a["digests"], b["digests"])
              and all(torch.equal(_bits(x), _bits(y)) if x.is_floating_point()
                      else torch.equal(x, y) for x, y in zip(a["fault"], b["fault"])))
        same.append(eq)
    two = runs["fused"][-1].get("two_leaves_equal")
    log(f"[16a] fused == packed per round (every chunk digest of theta, theta_hat, s and both "
        f"mirrors; the fault state and meter): {same}; the embeddings and layer 0's wq of "
        f"every tree equal bit for bit after the last round: {two}")
    if not all(same) or not two:
        raise AssertionError("phase 16a: the fused faulted run departs from the packed one")
    return out


def faulted_ft(dev, rows: dict | None) -> dict:
    """16b: FT's six faulted rows (10 nodes, logistic, ``kq4b``, 400 rounds,
    seeds 0 and 1) from 15d's pool, or run here with their fault-free
    twins when phase 15 did not run, held by the reference's FT rules."""
    from repro_torch.launch import comparisons as C

    if rows is None:
        task_list = [t for t in C.tasks(("ft",)) if t[1].endswith("|0") or t[1].count("|") == 2]
        t0 = time.perf_counter()
        rows = {f"{k[0]}|{k[1]}": v for k, v in
                C.summarize(C.run_tasks(task_list, dev, workers=P15_WORKERS)).items()}
        log(f"[16b] {len(task_list)} runs in {P15_WORKERS} processes: "
            f"{time.perf_counter() - t0:.1f} s")
    ref = {(r["schedule"], r["fault_spec"]): r
           for r in json.loads((ROOT / "BENCH_FT.json").read_text())["rows"]
           if r["dropout"] == 0.0 and r["schedule"] in C.FT_SCHEDULES}
    failures = []
    for sched in C.FT_SCHEDULES:
        twin = rows[f"ft|{sched}|0"]
        for spec in C.FT_FAULTS:
            got, r = rows[f"ft|{sched}|0|{spec}"], ref[(sched, spec)]
            checks = [
                ("consensus_err <= 2x the twin's", got["consensus_err"]
                 <= 2.0 * twin["consensus_err"]),
                ("detected > 0 and resyncs > 0", got["faults_detected"] > 0 and got["resyncs"] > 0),
                ("worst_acc >= the reference's - 0.05",
                 got["worst_acc"] >= r["worst_acc"] - FT_ACC_BAND),
                ("bits exact", got["bits_per_round"] == r["bits_per_round"]
                 and got["bits_per_round_expected"] == r["bits_per_round_expected"]),
                ("detected, resyncs within 20% of the reference's",
                 abs(got["faults_detected"] - r["faults_detected"]) <= 0.2 * r["faults_detected"]
                 and abs(got["resyncs"] - r["resyncs"]) <= 0.2 * r["resyncs"]),
            ]
            if spec.startswith("drop:0.1"):
                checks.append(("worst_acc >= the twin's - 0.05",
                               got["worst_acc"] >= twin["worst_acc"] - FT_ACC_BAND))
            bad = [c for c, ok in checks if not ok]
            log(f"[16b] FT {sched} {spec}: worst_acc {got['worst_acc']:.4f} (twin "
                f"{twin['worst_acc']:.4f}, reference {r['worst_acc']:.4f}); consensus_err "
                f"{got['consensus_err']:.4g} (twin {twin['consensus_err']:.4g}); detected "
                f"{got['faults_detected']} resyncs {got['resyncs']} (reference "
                f"{r['faults_detected']} / {r['resyncs']}); bits/round {got['bits_per_round']} / "
                f"expected {got['bits_per_round_expected']} (reference {r['bits_per_round']} / "
                f"{r['bits_per_round_expected']}); realized {got['bits_per_round_realized']:.2f}; "
                f"{'ok' if not bad else 'FAILED: ' + '; '.join(bad)}")
            if bad:
                failures.append(f"FT {sched} {spec}")
    if failures:
        raise AssertionError(f"phase 16b: {failures}")
    return {k: v for k, v in rows.items() if k.count("|") == 3}


def faulted_wire(dev, ft_rows) -> dict[str, int]:
    """Phase 16: 16a, then 16b; returns the gossip kernels' launch counts."""
    total: dict[str, int] = {}
    t0 = time.perf_counter()
    with _cut_depth(CUT_LAYERS, tag="16a"):
        faulted_full_width(dev, total)
    log(f"[16a] took {time.perf_counter() - t0:.1f} s")
    faulted_ft(dev, ft_rows)
    return total


# ----------------------------------------------------------------- phase 17
# the multi-process wire: launch/train.py --gossip-backend ppermute on R rank
# processes that share the card (gloo through page-locked host buffers)
P17A_ARGS = TRAIN_ARGS + ["--gossip-backend", "ppermute"]
P17B_ROUNDS = 4
P17B_ARGS = P15_ARGS + ["--nodes", "3", "--steps", str(P17B_ROUNDS), "--topology", "ring",
                        "--fault-spec", P16_SPEC, "--fused-gossip"]
P17_TIMEOUT = 600  # seconds a world may take before its ranks are killed


def _payload_row_bytes(d: int, bits: int = 4) -> int:
    """Bytes of one node's packed payload for an encode of d elements:
    levels and signs of the padded [rows, 128] grid, and one f32 (the norm,
    or the fused round's dequantize scale)."""
    from repro_torch.kernels.ops import KernelQuantization

    rows = KernelQuantization(bits).noise_shape(1, (d,))[1]
    return rows * 128 * bits // 8 + rows * 128 // 8 + 4


def _chunk_sizes(cfg, m: int) -> list[tuple[int, int]]:
    """(elements per node, bytes per element) of every encode of the chunk
    plan, in the gossip's order."""
    from repro_torch.core.gossip import _scan_plan
    from repro_torch.models import transformer as T
    from repro_torch.tree import leaves

    out = []
    for p in leaves(T.abstract_train_params(cfg)):
        n = math.prod(p.shape)
        plan = _scan_plan((m,) + tuple(p.shape), n, 1 << 24)
        chunks = 1 if plan is None else plan[1]
        out += [(n // chunks, p.dtype.itemsize)] * chunks
    return out


def p17_rank(cfg_path: str) -> int:
    """One rank of a phase-17 world (run as ``chip_smoke.py --p17-rank
    CONFIG``, with the env a launcher sets): ``launch/train.py`` with each
    of the config's flag lists in turn, recording after each round the
    chunk digests of the rank's rows of theta, theta_hat, s and the mirrors,
    the fault state, the launches, the wire's bytes and seconds and the
    round's seconds; round ``profile_step`` of each run under
    torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import exchange
    from repro_torch.kernels import _build
    from repro_torch.launch import train

    cfg = json.loads(Path(cfg_path).read_text())
    rec: list = []

    def wrap_step(step, run, state):
        counts0 = _build.launch_counts()
        sent0, wire0 = exchange.wire_bytes_sent.count, exchange.wire_bytes_sent.seconds
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prof_out = {}
        if step == cfg.get("profile_step"):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                new, aux = run()
                torch.cuda.synchronize()
            host = {}
            prof_out = _profile_breakdown(prof, time.perf_counter() - t0, host)
            prof_out.pop("top")
            prof_out["host_ms"] = host
        else:
            new, aux = run()
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = {k: v - counts0.get(k, 0) for k, v in _build.launch_counts().items()}
        fault = new.consensus.fault
        rec.append({**_round_record(new, aux), "seconds": secs,
                    "wire_bytes": exchange.wire_bytes_sent.count - sent0,
                    "wire_seconds": exchange.wire_bytes_sent.seconds - wire0,
                    "launches": {k: counts.get(k, 0) for k in GOSSIP_KERNELS},
                    "fault": [x.cpu() for x in fault] if fault != () else None,
                    "profile": prof_out})
        return new, aux

    import torch.distributed as dist

    from repro_torch.launch.mesh import BACKEND

    # one process group for every run (train.main leaves a group it did not start)
    dist.init_process_group(BACKEND, init_method="env://")
    runs = []
    for argv in cfg["runs"]:
        rec = []
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with _cut_depth(cfg["layers"], tag="17"):
            metrics = train.main(argv, wrap_step=wrap_step)
        runs.append({"rec": rec, "seconds": time.perf_counter() - t0,
                     "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                     "io": metrics["checkpoint_io"], "start_step": metrics["start_step"]})
        torch.cuda.empty_cache()
    torch.save(runs, cfg["out"])
    dist.destroy_process_group()
    return 0


def p17_world(tag: str, runs: list, ranks: int, profile_step=None) -> list[list[dict]]:
    """Start ``ranks`` processes on the card that run ``launch/train.py``
    with each flag list of ``runs`` in turn (``p17_rank``, qwen3-1.7b on
    CUT_LAYERS of its layers), with the env a launcher sets; a rank that
    fails fails the world, and a world past P17_TIMEOUT seconds is killed and
    fails.  Returns per run the ranks' records."""
    import os
    import socket
    import tempfile

    import torch

    torch.cuda.empty_cache()
    log(f"[{tag}] the parent holds {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
        f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved on the card as the ranks start")
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    tmp = Path(tempfile.mkdtemp(prefix=f"p17-{tag}-"))
    procs = []
    for r in range(ranks):
        conf = tmp / f"{r}.json"
        conf.write_text(json.dumps({"runs": runs, "out": str(tmp / f"{r}.pt"),
                                    "profile_step": profile_step, "layers": CUT_LAYERS}))
        # expandable segments: three ranks' 24 GiB each leave no room for the
        # caching allocator's unused reserved blocks
        env = {**os.environ, "RANK": str(r), "WORLD_SIZE": str(ranks), "LOCAL_RANK": str(r),
               "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
               "PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"}
        logf = open(tmp / f"{r}.log", "w")
        procs.append((subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"),
                                        "--p17-rank", str(conf)], env=env, stdout=logf,
                                       stderr=subprocess.STDOUT, cwd=ROOT), logf))
    deadline = time.perf_counter() + P17_TIMEOUT
    hung = False
    for p, _ in procs:
        try:
            p.wait(timeout=max(1.0, deadline - time.perf_counter()))
        except subprocess.TimeoutExpired:
            hung = True
            break
    for p, logf in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
        logf.close()
    for r in range(ranks):
        for line in (tmp / f"{r}.log").read_text().splitlines():
            if any(k in line for k in ("mesh:", "wire bytes", "peak device", "step ", "Error",
                                       "error", "Traceback", "resumed", "saved final",
                                       "unreadable")):
                log(f"[{tag} r{r}] {line.strip()[:400]}")
    codes = [p.returncode for p, _ in procs]
    if hung or any(c != 0 for c in codes):
        for r in range(ranks):
            tail = (tmp / f"{r}.log").read_text().splitlines()[-30:]
            log(f"[{tag} r{r}] last lines:\n" + "\n".join(tail))
        raise AssertionError(f"phase {tag}: ranks exited {codes}"
                             + (f", killed after {P17_TIMEOUT} s" if hung else ""))
    per_rank = [torch.load(tmp / f"{r}.pt", weights_only=False) for r in range(ranks)]
    return [[w[i] for w in per_rank] for i in range(len(runs))]


def p17_reference(key: str, argv: list) -> list[dict]:
    """The one-process run of ``argv`` (17a's, or 16a's when that phase did
    not run), with per-round records."""
    import torch

    from repro_torch.launch import train

    recs = []

    def wrap_step(step, run, state):
        out = run()
        recs.append({**_round_record(*out),
                     "fault": ([x.cpu() for x in out[0].consensus.fault]
                               if out[0].consensus.fault != () else None)})
        return out

    log(f"[17] one-process reference {key}: launch/train.py {' '.join(argv)}")
    train.main(argv, wrap_step=wrap_step)
    torch.cuda.empty_cache()
    ROUND_RECORDS[key] = recs
    return recs


def _p17_check(tag, ranks, ref, rounds, trees: int, failures: list) -> None:
    """Every round's chunk digests (the ranks' rows side by side) and losses
    against the one-process run's; the consensus error within 1e-6."""
    import torch

    for r in range(rounds):
        dig = torch.cat([w["rec"][r]["digests"] for w in ranks], dim=1)
        want = ref[r]["digests"]
        per = want.shape[0] // trees
        same = [bool(torch.equal(dig[t * per:(t + 1) * per], want[t * per:(t + 1) * per]))
                for t in range(trees)]
        losses = [w["rec"][r]["losses"] for w in ranks]
        err = [w["rec"][r]["consensus_err"] for w in ranks]
        rel = abs(err[0] - ref[r]["consensus_err"]) / abs(ref[r]["consensus_err"])
        log(f"[{tag}] round {r}: chunk digests equal per tree (theta, theta_hat, s"
            f"{', mirrors' if trees > 3 else ''}) {same}; losses equal "
            f"{all(x == ref[r]['losses'] for x in losses)}; consensus error {err[0]:.9e} "
            f"(one process {ref[r]['consensus_err']:.9e}, relative {rel:.2e})")
        if not all(same):
            failures.append(f"{tag} round {r}: digests differ {same}")
        if not all(x == ref[r]["losses"] for x in losses):
            failures.append(f"{tag} round {r}: losses {losses} != {ref[r]['losses']}")
        if rel > 1e-6 or len(set(err)) != 1:
            failures.append(f"{tag} round {r}: consensus error {err} vs {ref[r]['consensus_err']}")


def _p17_log_rounds(tag, ranks) -> None:
    card = gpu_name_and_limit()
    for r, w in enumerate(ranks):
        rec = w["rec"]
        log(f"[{tag}] rank {r}: s per round {[round(x['seconds'], 3) for x in rec]}; wire s "
            f"per round (staging + gloo) {[round(x['wire_seconds'], 3) for x in rec]}; bytes "
            f"sent per round {[x['wire_bytes'] for x in rec]}; peak memory "
            f"{w['peak_gib']:.2f} GiB; launches per round {rec[0]['launches']}; "
            f"{w['seconds']:.1f} s in train.main ({card})")
        for x in rec:
            if x["profile"]:
                pb = x["profile"]
                log(f"[{tag}] rank {r} profiled round: wall {pb['wall_ms']:.1f} ms, kernels busy "
                    f"{pb['busy_ms']:.1f} ms; kernel ms by section "
                    f"{({k: round(v, 1) for k, v in pb['busy'].items()})}; host ms by section "
                    f"{({k: round(v, 1) for k, v in pb['host_ms'].items()})}")


def multi_process_wire(dev, total) -> dict:
    """Phase 17 (under ``_cut_depth(CUT_LAYERS)``): 17a, 4 nodes on 2 ranks,
    packed then fused, against the one-process runs of the same flags; 17b,
    the faulted fused wire, 3 nodes on 3 ranks, against 16a's fused rounds
    0-3."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import faults as F
    from repro_torch.core.faults import receiver_maps
    from repro_torch.core.topology import compile_permute_plan, make_topology
    from repro_torch.core.wire import compile_union_wire

    cfg = get_config(QWEN)
    failures, out = [], {}
    # ---- 17a
    m, R, K = 4, 2, 2  # nodes, ranks, non-zero ring shifts
    block = m // R
    sizes = _chunk_sizes(cfg, m)
    n_enc = len(sizes)
    lam_bytes = K * 4 * m  # one lambda row of m f32 per shift
    want_bytes = sum(K * _payload_row_bytes(d) for d, _ in sizes) + lam_bytes
    zero = {k: 0 for k in GOSSIP_KERNELS}
    expect = {"packed": {**zero, "quantize": block * n_enc, "dequantize": block * (1 + K) * n_enc},
              "fused": {**zero, "fused_encode": n_enc, "fused_mix": n_enc}}
    log(f"[17a] predicted wire bytes per rank and round: {want_bytes} ({n_enc} encodes, "
        f"{K} shifts x one node's payload + {lam_bytes} B of lambda rows)")
    names = {"packed": [], "fused": ["--fused-gossip"]}
    refs = {name: p17_reference(f"17a/{name}", TRAIN_ARGS + extra)
            for name, extra in names.items()}
    log(f"[17a] {R} ranks: launch/train.py {' '.join(P17A_ARGS)}, then with --fused-gossip, "
        f"in the same processes")
    t0 = time.perf_counter()
    worlds = p17_world("17a", [P17A_ARGS + extra for extra in names.values()], R,
                       profile_step=1)
    log(f"[17a] {time.perf_counter() - t0:.1f} s for the world (packed, then fused)")
    out["17a/seconds"] = time.perf_counter() - t0
    for name, ranks in zip(names, worlds):
        ref = refs[name]
        _p17_log_rounds(f"17a {name}", ranks)
        _p17_check(f"17a {name}", ranks, ref, 3, 3, failures)
        for r, w in enumerate(ranks):
            for i, x in enumerate(w["rec"]):
                if x["launches"] != expect[name]:
                    failures.append(f"17a {name} rank {r} round {i}: launches {x['launches']} "
                                    f"!= {expect[name]}")
                if x["wire_bytes"] != want_bytes:
                    failures.append(f"17a {name} rank {r} round {i}: {x['wire_bytes']} bytes "
                                    f"!= {want_bytes}")
            for k, v in w["rec"][0]["launches"].items():
                total[k] = total.get(k, 0) + v * len(w["rec"])
        out[f"17a/{name}"] = {"ranks": [
            {"s_per_round": [x["seconds"] for x in w["rec"]],
             "wire_s_per_round": [x["wire_seconds"] for x in w["rec"]],
             "bytes_per_round": [x["wire_bytes"] for x in w["rec"]], "peak_gib": w["peak_gib"]}
            for w in ranks]}
    # ---- 17b
    m = R = 3
    spec = F.parse_fault_spec(P16_SPEC)
    union = compile_union_wire((compile_permute_plan(make_topology("ring", m)),))
    sizes = _chunk_sizes(cfg, m)
    n_enc = len(sizes)
    ref = (ROUND_RECORDS.get("16a/fused") or p17_reference(
        "16a/fused", P17B_ARGS))[:P17B_ROUNDS]
    argv = P17B_ARGS + ["--gossip-backend", "ppermute"]
    log(f"[17b] {R} ranks: launch/train.py {' '.join(argv)}")
    t0 = time.perf_counter()
    ranks = p17_world("17b", [argv], R)[0]
    secs = time.perf_counter() - t0
    _p17_log_rounds("17b", ranks)
    _p17_check("17b", ranks, ref, P17B_ROUNDS, 3 + union.n_ops, failures)
    expect = {**{k: 0 for k in GOSSIP_KERNELS}, "fused_encode_digest": n_enc,
              "dequantize": (1 + union.n_ops) * n_enc}
    rcv = receiver_maps(union)
    for i in range(P17B_ROUNDS):
        fault = [torch.cat([w["rec"][i]["fault"][f] for w in ranks]) for f in range(7)]
        same = all(torch.equal(_bits(a), _bits(b)) if a.is_floating_point() else torch.equal(a, b)
                   for a, b in zip(fault, ref[i]["fault"]))
        log(f"[17b] round {i}: fault state and meter equal the one-process run's: {same}; "
            f"detected {fault[4].tolist()} resyncs {fault[5].tolist()} meter "
            f"{fault[6].tolist()}")
        if not same:
            failures.append(f"17b round {i}: fault state differs")
        # the resync requests the round's senders saw: the state before it
        before = ref[i - 1]["fault"] if i else None
        want = (np.zeros((union.n_ops, m), bool) if before is None
                else ((before[1].T > spec.stale) & (before[2].T <= 0)).numpy())
        for r, w in enumerate(ranks):
            # alive, degree and resync-request bits (4 B) on each op, for the
            # model lane and the lambda lane (alive and degree only), then per
            # encode the payload and its digest on each op and the dense hat
            # on an op whose receiver asked; lambda's row of m f32 on each op
            got = w["rec"][i]["wire_bytes"]
            formula = union.n_ops * (3 * 4 + 2 * 4 + 4 * m)
            for d, item in sizes:
                for k in range(union.n_ops):
                    formula += _payload_row_bytes(d) + 4
                    if want[k, rcv[k][r]]:
                        formula += d * item
            if got != formula:
                failures.append(f"17b rank {r} round {i}: {got} bytes != formula {formula}")
            if w["rec"][i]["launches"] != expect:
                failures.append(f"17b rank {r} round {i}: launches {w['rec'][i]['launches']} "
                                f"!= {expect}")
    for w in ranks:
        for k, v in w["rec"][0]["launches"].items():
            total[k] = total.get(k, 0) + v * len(w["rec"])
    out["17b"] = {"seconds": secs, "ranks": [
        {"s_per_round": [x["seconds"] for x in w["rec"]],
         "wire_s_per_round": [x["wire_seconds"] for x in w["rec"]],
         "bytes_per_round": [x["wire_bytes"] for x in w["rec"]], "peak_gib": w["peak_gib"]}
        for w in ranks]}
    log(f"[17b] {secs:.1f} s for the world; {out['17b']}")
    t0 = time.perf_counter()
    out["17c"] = resume_on_ranks(cfg, total, failures)
    log(f"[17c] {time.perf_counter() - t0:.1f} s for 17c ({gpu_name_and_limit()})")
    if failures:
        raise AssertionError(f"phase 17: {failures}")
    return total


P17C_NODES = 2  # one node a rank; 4 nodes would double every file
P17C_ARGS = P15_ARGS + ["--nodes", str(P17C_NODES), "--topology", "ring", "--fused-gossip"]


def _npz_layout(fname) -> dict:
    """{leaf name: (shape, dtype)} of an ``.npz`` from its members' headers
    (no leaf is read)."""
    import zipfile

    import numpy as np

    out = {}
    with zipfile.ZipFile(fname) as zf:
        for name in zf.namelist():
            with zf.open(name) as f:
                version = np.lib.format.read_magic(f)
                read = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                        else np.lib.format.read_array_header_2_0)
                shape, _, dtype = read(f)
            out[name[:-len(".npy")]] = (tuple(shape), str(dtype))
    return out


def resume_on_ranks(cfg, total, failures: list) -> dict:
    """17c: 2 nodes on 2 ranks, ``kq4b`` fused.  A: 4 rounds straight; B: 2
    rounds with ``--checkpoint`` (rank 0 writes one file, gathering the
    other rank's rows); C: ``--resume`` to 4; D: the same file resumed in
    one process on the rolled backend (a hard link in a fresh directory),
    to 4.  C's and D's losses of rounds 2-3 and the chunk digests of theta,
    theta_hat and s after round 4 (C: each rank's rows; D: its whole
    tensors) must equal A's; B's file has the leaves of the file a
    one-process run writes (D's own), whole [2, ...]; the fused kernels
    launch the chunk plan once a round on every rank and in one process."""
    import shutil
    import tempfile

    import torch

    from repro_torch.kernels import _build
    from repro_torch.launch import train
    from repro_torch.models import transformer as T

    m = R = P17C_NODES
    n_params = T.param_count(cfg)
    # B's step-2 file beside C's step-4 file (theta, theta_hat, s: bf16) and
    # one f32 model file, then D's step-4 file and model file in their place
    need = 2 * 3 * m * 2 * n_params + 4 * n_params
    base = max((Path(tempfile.gettempdir()), ROOT), key=lambda d: shutil.disk_usage(d).free)
    free = shutil.disk_usage(base).free
    log(f"[17c] disk under {base}: {free / 1e9:.1f} GB free, the checkpoints need "
        f"{need / 1e9:.1f} GB")
    if free < need * 1.05:
        raise AssertionError(f"phase 17c: {free / 1e9:.1f} GB free under {base}, "
                             f"{need / 1e9:.1f} GB needed")
    n_enc = len(_chunk_sizes(cfg, m))
    tmp = Path(tempfile.mkdtemp(prefix="p17c_", dir=base))
    ck, dck = tmp / "ranks" / "run", tmp / "one" / "run"
    ranks_argv = P17C_ARGS + ["--gossip-backend", "ppermute"]
    runs = {"A": ranks_argv + ["--steps", "4"],
            "B": ranks_argv + ["--steps", "2", "--checkpoint", str(ck)],
            "C": ranks_argv + ["--steps", "4", "--checkpoint", str(ck), "--resume"]}
    out = {}
    try:
        log(f"[17c] {R} ranks: launch/train.py {' '.join(ranks_argv)}: A --steps 4, B --steps 2 "
            f"--checkpoint, C --steps 4 --resume, in the same processes")
        t0 = time.perf_counter()
        worlds = dict(zip(runs, p17_world("17c", list(runs.values()), R)))
        out["world_seconds"] = time.perf_counter() - t0
        step2 = Path(f"{ck}_00000002.npz")
        layout_b = _npz_layout(step2)
        for name in ("_00000004.npz", "_model.npz"):  # C's outputs: room for D's
            Path(f"{ck}{name}").unlink()
        dck.parent.mkdir()
        os.link(step2, f"{dck}_00000002.npz")
        recs = []

        def wrap_step(step, run, state):
            counts0 = _build.launch_counts()
            new, aux = run()
            torch.cuda.synchronize()
            counts = _build.launch_counts()
            recs.append({**_round_record(new, aux),
                         "launches": {k: counts.get(k, 0) - counts0.get(k, 0)
                                      for k in GOSSIP_KERNELS}})
            return new, aux

        log(f"[17c] D: launch/train.py {' '.join(P17C_ARGS)} --steps 4 --resume, one process, "
            f"from a hard link to B's step-2 file")
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        d_metrics = train.main(P17C_ARGS + ["--steps", "4", "--checkpoint", str(dck),
                                            "--resume"], wrap_step=wrap_step)
        torch.cuda.synchronize()
        out["D_seconds"] = time.perf_counter() - t0
        layout_d = _npz_layout(f"{dck}_00000004.npz")
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    a, b, c = (worlds[k] for k in "ABC")
    # the file
    whole = all(shape[0] == m for name, (shape, _) in layout_b.items()
                if name.startswith(("theta|", "consensus|")))
    log(f"[17c] B's file: {len(layout_b)} leaves, the names, shapes and dtypes of the "
        f"one-process file (D's): {layout_b == layout_d}; theta and consensus leaves whole "
        f"[{m}, ...]: {whole}")
    if layout_b != layout_d or not whole:
        diff = sorted(set(layout_b.items()) ^ set(layout_d.items()))[:6]
        failures.append(f"17c: B's file is not the one-process file ({diff}; whole {whole})")
    # the rounds
    want_losses = [a[0]["rec"][i]["losses"] for i in (2, 3)]
    want_dig = torch.cat([w["rec"][3]["digests"] for w in a], dim=1)
    c_dig = torch.cat([w["rec"][-1]["digests"] for w in c], dim=1)
    d_dig = recs[-1]["digests"]
    starts = [w["start_step"] for w in c] + [d_metrics["start_step"]]
    same = {"C losses": all([x["losses"] for x in w["rec"]] == want_losses for w in c),
            "D losses": [x["losses"] for x in recs] == want_losses,
            "C digests": bool(torch.equal(c_dig, want_dig)),
            "D digests": bool(torch.equal(d_dig, want_dig)),
            "rounds 2-3 of A equal across ranks": all(
                [x["losses"] for x in w["rec"][2:]] == want_losses for w in a)}
    log(f"[17c] C and D resumed at steps {starts}; against A (bit for bit): {same}")
    if starts != [2] * (R + 1) or not all(same.values()):
        failures.append(f"17c: resumed runs differ from the straight one: {same}, "
                        f"start steps {starts}")
    # the launches: fused encode and mix, once per encode of the chunk plan a round
    zero = {k: 0 for k in GOSSIP_KERNELS}
    expect = {**zero, "fused_encode": n_enc, "fused_mix": n_enc}
    for label, ranks in (("A", a), ("B", b), ("C", c), ("D", [{"rec": recs}])):
        for r, w in enumerate(ranks):
            bad = [x["launches"] for x in w["rec"] if x["launches"] != expect]
            if bad or not w["rec"]:
                failures.append(f"17c {label} rank {r}: launches {bad[:1]} != {expect}")
            for x in w["rec"]:
                for k, v in x["launches"].items():
                    total[k] = total.get(k, 0) + v
    log(f"[17c] launches a round, every rank of A, B, C and D: {expect} "
        f"({n_enc} encodes in the chunk plan)")
    # the checkpoint I/O
    io = {"B": [w["io"] for w in b], "C": [w["io"] for w in c],
          "D": d_metrics["checkpoint_io"]}
    for label in ("B", "C"):
        for r, x in enumerate(io[label]):
            log(f"[17c] {label} rank {r}: saves {[round(t, 2) for t in x['save_seconds']]} s of "
                f"{[round(n / 1e9, 3) for n in x['save_bytes']]} GB (state file, model file); "
                f"sent to rank 0 {[round(n / 1e9, 3) for n in x['gather_bytes']]} GB; restore "
                f"{x['restore_seconds'] if x['restore_seconds'] is None else round(x['restore_seconds'], 2)} s")
    x = io["D"]
    log(f"[17c] D (one process): restore {x['restore_seconds']:.2f} s of "
        f"{x['save_bytes'][0] / 1e9:.3f} GB (the size of its own state file); saves {[round(t, 2) for t in x['save_seconds']]} s "
        f"of {[round(n / 1e9, 3) for n in x['save_bytes']]} GB")
    out.update(io=io, start_steps=starts, same=same)
    for label, ranks in (("A", a), ("B", b), ("C", c)):
        _p17_log_rounds(f"17c {label}", ranks)
    return out




# ----------------------------------------------------------------- phase 19
# (arch, nodes, --seq, layers kept or None for all), one on the card at a
# time, width never cut.  deepseek-moe-16b's 16.1 B parameters do not train
# on one card: 6 of its 28 layers (one dense, five MoE, 3.2 B) on 2 nodes.
# internvl2-2b's 256 patches need --seq 512 (256 positions of text);
# mamba2-1.3b's --seq is one SSD chunk.
# The dense configs and llama4 on 2 nodes, each at the depth whose peak at
# ~8.35 B a parameter a node (θ, θ̂ and s in bf16, one node's gradient,
# activations, the round's f32 temporaries: phase 19's measured rate) stays
# under P19_PEAK_GIB:
# qwen3-4b whole (4.02 B), granite-20b on CUT_LAYERS (2.96 B), command-r-35b
# on 2 of 40 (3.51 B, its tied [256000, 8192] embedding the largest leaf of
# any run) and llama4-scout-17b-a16e on 1 of 48 (3.24 B; every layer is the
# same MoE layer, its expert leaves [16, 5120, 8192]).
P19_RUNS = (("whisper-small", 4, 128, None), ("internvl2-2b", 3, 512, None),
            ("mamba2-1.3b", 4, 256, None), ("recurrentgemma-2b", 3, 128, None),
            ("deepseek-moe-16b", 2, 128, 6), ("qwen3-4b", 2, 128, None),
            ("granite-20b", 2, 128, CUT_LAYERS), ("command-r-35b", 2, 128, 2),
            (LLAMA4, 2, 128, 1))
# leaves and routing new to the chunk plan
P19_PACKED = ("deepseek-moe-16b", "mamba2-1.3b", LLAMA4)
P19_PROFILED = ("deepseek-moe-16b", "mamba2-1.3b", "recurrentgemma-2b", "command-r-35b",
                LLAMA4)
P19_ARGS = ["--batch-per-node", "4", "--topology", "ring", "--compressor", "kq4b",
            "--steps", "2", "--log-every", "1"]
P19_PEAK_GIB = 70.0
P19_STUB_SEED = 19


@contextlib.contextmanager
def _stub_batches(seed: int):
    """``launch/train.py`` builds each round's batch with seeded N(0, 0.02²)
    ``frames`` / ``patches`` (``serve.stub_inputs``, drawn over the node
    rows) in place of the reference's zeros: a norm over a constant row
    divides by ``sqrt(eps)``, and whisper's and internvl2's gradients
    overflow (``launch/train.py``'s docstring)."""
    import torch

    from repro_torch.launch import serve, train

    real = train.make_batch
    gens: dict = {}

    def make_batch(tokens, cfg, round_batch, device):
        dev = torch.device(device)
        gen = gens.setdefault(dev, torch.Generator(device=dev).manual_seed(seed))
        lead = (tokens.shape[0], round_batch)
        stubs = serve.stub_inputs(cfg, lead[0] * lead[1], gen, dev)
        return {"tokens": tokens.to(dev),
                **{k: v.reshape(lead + tuple(v.shape[1:])) for k, v in stubs.items()}}

    train.make_batch = make_batch
    try:
        yield
    finally:
        train.make_batch = real


def train_family(arch, m, seq, total) -> None:
    """One family of phase 19: ``launch/train.py`` fused (and packed for
    P19_PACKED), its launches, bits, losses and peak against the chunk plan
    of its stacked template; the launches are added to ``total``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.core.gossip import payload_bits
    from repro_torch.core.topology import ring
    from repro_torch.kernels import _build
    from repro_torch.kernels.ops import KernelQuantization
    from repro_torch.launch import train
    from repro_torch.models import transformer as T
    from repro_torch.tree import leaves

    tag = f"[19] {arch}"
    cfg = get_config(arch)
    stubbed = cfg.is_encdec or cfg.num_patches > 0
    steps = int(P19_ARGS[P19_ARGS.index("--steps") + 1])
    n_enc = _chunk_plan(cfg, m)
    K = len(ring(m).shifts)  # shifts of the ring's mixing, 0 included
    template = [torch.empty((m,) + tuple(p.shape), device="meta")
                for p in leaves(T.abstract_train_params(cfg))]
    want_bits = payload_bits(KernelQuantization(4), template, ring(m)) + 32.0 * m * (K - 1)
    expect = {"fused": {"fused_encode": n_enc, "fused_mix": n_enc * -(-K // 8)},
              "packed": {"quantize": m * n_enc, "dequantize": m * (1 + K) * n_enc}}
    log(f"{tag}: {cfg.num_layers} layers, d {cfg.d_model}, {T.param_count(cfg) / 1e9:.3f} B "
        f"parameters a node, {m} nodes on a ring, --seq {seq}; chunk plan {n_enc} encodes a "
        f"round; expected launches a round {expect}"
        + ("; frames / patches: seeded N(0, 0.02²) stubs (the reference's zeros overflow "
           "the gradients)" if stubbed else ""))
    pin = RoutingPin()
    runs = {}
    for name in ("fused", "packed") if arch in P19_PACKED else ("fused",):
        argv = (["--arch", arch, "--nodes", str(m), "--seq", str(seq)] + P19_ARGS
                + (["--fused-gossip"] if name == "fused" else []))
        log(f"{tag} {name}: launch/train.py {' '.join(argv)}")
        prof_out: dict = {}

        def wrap_step(step, run, state, name=name):
            if step != 1 or name != "fused" or arch not in P19_PROFILED:
                return run()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                res = run()
                torch.cuda.synchronize()
                prof_out.update(prof=prof, wall=time.perf_counter() - t0)
            return res

        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launch_counts()
        # the fused run's routing, replayed by the packed run: one bf16 flip
        # would move a token to another expert and the losses apart
        routing = pin.record() if name == "fused" else pin.replay()
        t0 = time.perf_counter()
        with routing, _stub_batches(P19_STUB_SEED) if stubbed else contextlib.nullcontext():
            metrics = train.main(argv, wrap_step=wrap_step)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = _build.launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        hist = metrics["history"]
        log(f"{tag} {name}: {secs:.1f} s in train.main; s per round "
            f"{[round(x, 3) for x in metrics['step_seconds']]}"
            + (" (round 1 under the profiler)" if prof_out else "")
            + f"; peak memory {peak:.2f} GiB ({gpu_name_and_limit()}); launches "
            f"{({k: v for k, v in counts.items() if v})}; bits/round "
            f"{metrics['bits_per_round']:.6e} (payload_bits + the dual: {want_bits:.6e}); "
            f"losses {[h['losses'] for h in hist]}; consensus error "
            f"{[h['consensus_err'] for h in hist]}; lambda_max "
            f"{[h['lambda_max'] for h in hist]}" + (pin.note() if name == "packed" else ""))
        failures = []
        for k, per_round in expect[name].items():
            if counts[k] != per_round * steps:
                failures.append(f"{k} launched {counts[k]} times, the chunk plan gives "
                                f"{per_round} x {steps}")
        if metrics["bits_per_round"] != want_bits:
            failures.append(f"bits/round {metrics['bits_per_round']} != {want_bits}")
        if not all(math.isfinite(x) for h in hist for x in h["losses"] + [h["consensus_err"]]):
            failures.append("non-finite losses or consensus error")
        if peak > P19_PEAK_GIB:
            failures.append(f"peak {peak:.2f} GiB > {P19_PEAK_GIB}")
        if prof_out:
            host: dict = {}
            pb = _profile_breakdown(prof_out.pop("prof"), prof_out["wall"], host)
            log(f"{tag} {name} round 1 under torch.profiler: wall {pb['wall_ms']:.1f} ms, "
                f"kernels busy {pb['busy_ms']:.1f} ms ({pb['busy_ms'] / pb['wall_ms']:.1%}); "
                f"kernel ms by section {({k: round(v, 1) for k, v in pb['busy'].items()})}; "
                f"device span ms by section "
                f"{({k: round(v, 1) for k, v in pb['spans_ms'].items()})}; host ms by section "
                f"{({k: round(v, 1) for k, v in host.items()})}; read in {pb['read_s']:.1f} s")
            for ms_, count, key in pb["top"]:
                log(f"[19]   {ms_:9.2f} ms x{count:<6d} {key[:90]}")
        if failures:
            raise AssertionError(f"phase 19 {arch} {name}: {failures}")
        runs[name] = hist
        del metrics
    if "packed" in runs:
        f, p = runs["fused"], runs["packed"]
        if f[0]["losses"] != p[0]["losses"]:
            raise AssertionError(f"phase 19 {arch}: step-0 losses differ: {f[0]['losses']} / "
                                 f"{p[0]['losses']}")
        rel = max(abs(a - b) / abs(b) for s_ in range(1, steps)
                  for a, b in zip(f[s_]["losses"], p[s_]["losses"]))
        log(f"{tag}: step-0 losses equal (fused == packed); step 1 max relative difference "
            f"{rel:.3e} (bound {LOSS_REL_BOUND})")
        if rel > LOSS_REL_BOUND:
            raise AssertionError(f"phase 19 {arch}: fused and packed disagree")
    torch.cuda.empty_cache()


def zoo_trains() -> dict[str, int]:
    """Phase 19: each family of P19_RUNS in turn; returns the gossip
    kernels' launch counts."""
    total: dict[str, int] = {}
    for arch, m, seq, layers in P19_RUNS:
        t0 = time.perf_counter()
        with _cut_depth(layers, arch, tag="19") if layers else contextlib.nullcontext():
            train_family(arch, m, seq, total)
        log(f"[19] {arch} took {time.perf_counter() - t0:.1f} s")
    return total


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--phases", default="1,2,3,4,5,6,7,8,9,10,11,12,13,14,15,16,17,18,19",
                    help="comma-separated phases to run (default: all)")
    ap.add_argument("--turns", metavar="PARENT_ROOT",
                    help="instead of the phases: time the attention and decode rows of the "
                         "checkout at PARENT_ROOT and of this one in turns")
    ap.add_argument("--time-rows", metavar="SRC", help=argparse.SUPPRESS)
    ap.add_argument("--p17-rank", metavar="CONFIG", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    phases = {int(p) for p in args.phases.split(",")}
    if args.time_rows:  # one turn of --turns: that tree's package, not this one's
        sys.path.insert(0, args.time_rows)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA card",
              file=sys.stderr)
        return 2
    from repro_torch import resolve_device
    from repro_torch.kernels import _build

    dev = resolve_device("cuda")
    if args.p17_rank:  # one rank of a phase-17 world, started by the parent
        return p17_rank(args.p17_rank)
    if args.time_rows:
        print(json.dumps(time_rows(dev)), flush=True)
        return 0
    if args.turns:
        print(gpu_name_and_limit(), flush=True)
        turns(Path(args.turns))
        print(gpu_name_and_limit(), flush=True)
        return 0
    t_start = time.perf_counter()
    # the card's name and power limit, as nvidia-smi gives them
    print(gpu_name_and_limit(), flush=True)
    log(f"[1] python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    secs = _build.build()
    log(f"[1] nvcc build of {sorted(secs)} in {time.perf_counter() - t0:.1f} s "
        f"({', '.join(f'{k} {v:.1f} s' for k, v in sorted(secs.items()))})")
    for name, text in sorted(_build.BUILD_LOG.items()):
        for line in text.splitlines():
            if ("registers" in line or "spill" in line or "error" in line.lower()
                    or "Compiling entry" in line or "warning" in line.lower()):
                log(f"[1]   {name}: {line.strip()}")
    attention_sass()

    def timed(phase, fn):
        """Run one phase; log its seconds on the host clock."""
        t0 = time.perf_counter()
        out = fn()
        log(f"[{phase}] phase took {time.perf_counter() - t0:.1f} s")
        return out

    def kernels():
        log("[2] kernels against their plain versions")
        out = check_kernels(dev)
        for check in (check_block_sparse, check_wide_shapes, check_gossip_kernels,
                      check_block_topk, check_moe_dispatch):
            out.update(check(dev))
        return out

    records = timed(2, kernels) if 2 in phases else {}
    if 3 in phases:
        timed(3, lambda: model_vs_plain(dev))
    launches = {}  # from the main paths' own runs only; null when they did not run
    if phases & {4, 5, 6}:
        serving = timed("4-6", lambda: main_path(dev))
        launches.update({k: serving[k] for k in SERVING_KERNELS})
    if 7 in phases:
        timed(7, lambda: profile_decode(dev))
    if 8 in phases:
        timed(8, lambda: round_full_width(dev))
    if 9 in phases:
        training = timed(9, lambda: train_full_width(dev))
        launches.update({k: training[k] for k in GOSSIP_KERNELS})
    if 10 in phases:
        timed(10, lambda: quickstart(dev))
    if 11 in phases:
        with _cut_depth(CUT_LAYERS, tag="11"):
            fleet = timed(11, lambda: fleet_full_width(dev))
        for k in SERVING_KERNELS:
            launches[k] = launches.get(k, 0) + fleet[k]
    if 12 in phases:
        served = timed(12, lambda: train_and_serve(dev))
        for k in ("fused_encode", "fused_mix"):
            launches[k] = launches.get(k, 0) + served[k]
    for phase, run in ((13, model_zoo), (14, families)):
        if phase in phases:
            for arch, counts in timed(phase, lambda: run(dev)).items():
                for k in SERVING_KERNELS:
                    row = zoo_row(arch, k)
                    launches[row] = launches.get(row, 0) + counts[k]
    if 18 in phases:
        counts = timed(18, lambda: llama4_full_width(dev))
        for k in SERVING_KERNELS:
            row = zoo_row(LLAMA4, k)
            launches[row] = launches.get(row, 0) + counts[k]
    ft_rows = None
    if 15 in phases:
        breadth, ft_rows = timed(15, lambda: trainer_breadth(dev))
        for k in GOSSIP_KERNELS:
            launches[k] = launches.get(k, 0) + breadth.get(k, 0)
    if 16 in phases:
        faulted = timed(16, lambda: faulted_wire(dev, ft_rows))
        for k in GOSSIP_KERNELS:
            launches[k] = launches.get(k, 0) + faulted.get(k, 0)
    if 17 in phases:
        with _cut_depth(CUT_LAYERS, tag="17"):
            ranks = timed(17, lambda: multi_process_wire(dev, {}))
        for k in GOSSIP_KERNELS:
            launches[k] = launches.get(k, 0) + ranks.get(k, 0)
    if 19 in phases:
        trained = timed(19, zoo_trains)
        for k in GOSSIP_KERNELS:
            launches[k] = launches.get(k, 0) + trained.get(k, 0)

    log(f"[all] phases {sorted(phases)} took {time.perf_counter() - t_start:.1f} s")
    print(gpu_name_and_limit(), flush=True)  # again, beside the numbers it qualifies
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
