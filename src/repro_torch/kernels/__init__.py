"""The port's kernels -- attention (serving) and quantize / dequantize /
fused CHOCO round (gossip): CUDA sources in ``csrc/``, each with a wrapper,
a plain PyTorch version and a launch counter.  The model and the gossip
layer call them through ``kernels/ops.py``."""
from repro_torch.kernels._build import COUNTERS, launch_counts, reset_launch_counts

__all__ = ["COUNTERS", "launch_counts", "reset_launch_counts"]
