"""The gossip kernels' share of their roofline, in %: the bytes the cell's
compressor's kernels must move in the profiled rounds (``counting/
gossip_bytes.py``, from the chunk plan) over the HBM peak, divided by those
kernels' device time.  Memory-bound kernels: the bytes bound them."""
from portbench.counting.peaks import HBM_BYTES


def read(run):
    if run.trace is None or run.gossip is None:
        return None
    seconds = run.trace.kernel_s(run.gossip["kernels"])
    if seconds <= 0:
        return None
    return 100.0 * run.gossip["bytes"] * run.profiled_rounds / HBM_BYTES / seconds
