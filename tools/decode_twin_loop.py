"""Run the decode tests of ``tests/test_torch_cuda.py`` many times on the card
and report, per run, how far the f32 decode kernel and the f32 CPU twin of its
plan (``kernels/decode.py::decode_attention_split``) each lie from the twin run
in float64, on the inputs of ``test_decode_split_kernel_matches_its_cpu_twin``.

    PYTHONPATH=src python tools/decode_twin_loop.py --runs 30

Each run is a pytest process of its own (this file is its plugin).  On a run
where kernel and f32 twin disagree past the f32 bound (atol 2e-5, rtol 1e-4),
it reruns the kernel on the same inputs and the f32 twin on fresh copies and
on copies at another alignment, and prints how many elements each rerun
changes.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
from pathlib import Path

NAME = "test_decode_split_kernel_matches_its_cpu_twin"
_rec: dict = {}
_orig: tuple = ()


def _moved(t):
    import torch

    buf = torch.empty(t.numel() + 3, dtype=t.dtype)
    return buf[3:].view(t.shape).copy_(t)


def pytest_runtest_setup(item):
    global _orig
    if item.name != NAME:
        return
    from repro_torch.kernels import decode as kd

    _orig = (kd.decode_attention, kd.decode_attention_split)

    def dec(*a, **kw):
        out = _orig[0](*a, **kw)
        _rec.update(args=[t.clone() for t in a], out=out.cpu())
        return out

    kd.decode_attention = dec


def pytest_runtest_teardown(item):
    if item.name != NAME or not _orig:
        return
    from repro_torch.kernels import decode as kd

    kd.decode_attention = _orig[0]
    if "out" not in _rec:
        return
    args = [t.cpu() for t in _rec["args"]]
    twin = _orig[1](*args)  # f32, as the test held it before the float64 oracle
    twin64 = _orig[1](*(t.double() for t in args[:3]), args[3]).float()
    out = _rec["out"]
    lim = 2e-5 + 1e-4 * twin.abs()
    bad = int(((out - twin).abs() > lim).sum())
    run = os.environ.get("DECODE_TWIN_RUN", "0")
    print(f"\nrun {run}: kernel vs float64 twin {float((out - twin64).abs().max()):.3e}, "
          f"f32 twin vs float64 twin {float((twin - twin64).abs().max()):.3e}, "
          f"kernel vs f32 twin: {bad} elements past the bound", flush=True)
    if bad:
        kernel = [int((_orig[0](*_rec["args"]).cpu() != out).sum()) for _ in range(10)]
        again = [int((_orig[1](*(t.clone() for t in args)) != twin).sum()) for _ in range(5)]
        moved = [int((_orig[1](*(_moved(t) for t in args)) != twin).sum()) for _ in range(5)]
        print(f"run {run} missed: elements changed by kernel reruns {kernel}, by f32 twin "
              f"reruns {again}, at another alignment {moved}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=30)
    args = ap.parse_args()
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(root / "src"), str(root / "tools"), os.environ.get("PYTHONPATH", "")]))
    for i in range(1, args.runs + 1):
        out = subprocess.run(
            [sys.executable, "-m", "pytest", "-q", "-s", "-m", "cuda", "-k", "decode",
             "-p", "decode_twin_loop", "-p", "no:cacheprovider",
             str(root / "tests" / "test_torch_cuda.py")],
            cwd=root, env=dict(env, DECODE_TWIN_RUN=str(i)), capture_output=True, text=True)
        lines = [ln for ln in out.stdout.splitlines() if ln.startswith(f"run {i}")]
        print(*lines, f"(pytest exit {out.returncode}: {out.stdout.strip().splitlines()[-1]})",
              sep="\n", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
