"""The port's kernels -- attention: flash, sliding window, block-sparse,
decode (serving); quantize / dequantize, fused CHOCO round, block top-k
(gossip): CUDA sources in ``csrc/``, each with a wrapper,
a plain PyTorch version and a launch counter.  The model and the gossip
layer call them through ``kernels/ops.py``."""
from repro_torch.kernels._build import COUNTERS, launch_counts, reset_launch_counts

__all__ = ["COUNTERS", "launch_counts", "reset_launch_counts"]
