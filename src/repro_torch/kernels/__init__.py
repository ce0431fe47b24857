"""The port's kernels -- attention: flash, sliding window, block-sparse,
decode (serving); quantize / dequantize, fused CHOCO round, block top-k
(gossip); the MoE dispatch and its backward (``moe_dispatch``, the model):
CUDA sources in ``csrc/``, each with a wrapper,
a plain PyTorch version and a launch counter.  The model and the gossip
layer call them through ``kernels/ops.py``, whose public wrappers this
package exports, as the reference's does (the MoE layer its dispatch
through ``kernels/moe_dispatch.py``).  Importing builds nothing: each
kernel is built with ``nvcc`` at its first launch on a card."""
from repro_torch.kernels._build import COUNTERS, launch_counts, reset_launch_counts
from repro_torch.kernels import moe_dispatch  # noqa: F401  (its launch counters)
from repro_torch.kernels.ops import (
    KernelBlockTopK,
    KernelQuantization,
    block_sparse_attention,
    block_topk,
    decode_attention_kernel,
    dequantize,
    flash_attention,
    quantize,
    quantize_kv,
    sliding_window_attention,
)

__all__ = [
    "COUNTERS",
    "launch_counts",
    "reset_launch_counts",
    "KernelBlockTopK",
    "KernelQuantization",
    "block_sparse_attention",
    "block_topk",
    "decode_attention_kernel",
    "dequantize",
    "flash_attention",
    "quantize",
    "quantize_kv",
    "sliding_window_attention",
]
