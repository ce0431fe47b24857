"""Run one cell of the benchmark:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The last line of standard output is the
result (one JSON object); the compared numbers and their limits are the
last lines of standard error.  Exits 2 without a CUDA card, 3 if the
process holds JAX or the JAX package after the window.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the build and kernel caches of the program stay inside the checkout, at fixed paths
CACHE = ROOT / ".portbench_cache"
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["USE_FLAX"] = "0"
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

if __name__ == "__main__":
    try:
        import repro_torch  # noqa: F401  (the system under test)
    except ImportError as e:
        print(f"portbench: the port is not in this checkout ({e})", file=sys.stderr)
        sys.exit(1)
    from portbench.harness import main

    sys.exit(main(sys.argv[1:], t_start=T_START))
