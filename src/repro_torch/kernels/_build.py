"""Build and load the port's CUDA kernels (``csrc/*.cu``) at first use.

Each source compiles with ``nvcc`` for ``sm_90a`` into its own shared library
with a plain C interface, loaded with ``ctypes``.  The library's file name
carries a hash of the sources and flags, so a stale build is never loaded.
Builds of several sources start together (one ``nvcc`` each) and land under
the package's git-ignored ``build/`` directory; a failed build raises.

Every kernel wrapper counts its launches in a :class:`LaunchCounter`
registered in :data:`COUNTERS`, so a run can show that its main path went
through the kernels.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
#: kernel library name -> source file under csrc/
SOURCES = {
    "flash_attn": "flash_attn.cu",
    "decode_attn": "decode_attn.cu",
    "quantize": "quantize.cu",
    "choco_fused": "choco_fused.cu",
    "block_topk": "block_topk.cu",
    "block_sparse_attn": "block_sparse_attn.cu",
    "moe_dispatch": "moe_dispatch.cu",
}
#: flags of one library on top of NVCC_FLAGS: the compression kernels must
#: round exactly as their plain versions, so no FMA contraction there
EXTRA_FLAGS = {"quantize": ["-fmad=false"], "choco_fused": ["-fmad=false"],
               "block_topk": ["-fmad=false"]}
#: nvcc's stderr per built library (ptxas register / spill report)
BUILD_LOG: dict[str, str] = {}

_LIBS: dict[str, ctypes.CDLL] = {}
_FUNCS: dict[tuple[str, str], ctypes._CFuncPtr] = {}


class LaunchCounter:
    """Count of kernel launches of one wrapper (CUDA launches only)."""

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        COUNTERS[name] = self

    def add(self) -> None:
        self.count += 1


COUNTERS: dict[str, LaunchCounter] = {}


def reset_launch_counts() -> None:
    for c in COUNTERS.values():
        c.count = 0


def launch_counts() -> dict[str, int]:
    return {name: c.count for name, c in COUNTERS.items()}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")
    return found


def _flags(name: str) -> list[str]:
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, [])


def lib_path(name: str) -> Path:
    digest = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / SOURCES[name]]:
        digest.update(f.name.encode())
        digest.update(f.read_bytes())
    digest.update(" ".join(_flags(name)).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def build(names=None) -> dict[str, float]:
    """Compile the named libraries that are not built yet, all at once.

    Returns seconds per library compiled here (0.0 for one already built).
    Raises ``RuntimeError`` with nvcc's output if any compile fails.
    """
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, seconds = {}, {}
    nvcc = None
    for name in names:
        out = lib_path(name)
        if out.exists():
            seconds[name] = 0.0
            continue
        nvcc = nvcc or _nvcc()
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *_flags(name), "-o", str(tmp), str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                        text=True), tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        stdout, stderr = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        BUILD_LOG[name] = stdout + stderr
        if proc.returncode != 0:
            failed.append(f"{name} (exit {proc.returncode}):\n{stdout}{stderr}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        path = lib_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        _LIBS[name] = lib
    return lib


def function(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """C entry ``symbol`` of library ``name`` with its argument types
    declared (pointers and the stream as ``c_void_p``) and an int result."""
    fn = _FUNCS.get((name, symbol))
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _FUNCS[(name, symbol)] = fn
    return fn


def check_cuda(tensors: dict[str, torch.Tensor], what: str) -> None:
    """Every operand is a CUDA tensor, all on one device."""
    devices = {t.device for t in tensors.values()}
    for name, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{what} {name}: expected a CUDA tensor, got {t.device}")
    if len(devices) != 1:
        raise ValueError(f"{what}: operands on several devices {sorted(map(str, devices))}")


def raise_on_error(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
