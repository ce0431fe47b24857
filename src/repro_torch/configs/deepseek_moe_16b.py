"""deepseek-moe-16b [moe] — fine-grained MoE, 2 shared + 64 routed top-6
[arXiv:2401.06066].

Layer 0 is a dense FFN (the DeepSeekMoE "first dense layer"); layers 1..27
use 64 fine-grained routed experts (d_ff=1408 each) with top-6 routing plus
2 always-on shared experts (``models/moe.py``).  16.1 B parameters: one
card holds the whole model in bf16.

Long contexts (cache beyond 8192) run the sliding-window ring-buffer variant.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,       # fine-grained expert hidden size (also layer-0 dense FFN x 8)
    vocab_size=102400,
    layer_pattern=("attn",),
    num_experts=64,
    num_shared_experts=2,
    experts_per_token=6,
    moe_d_ff=1408,
    first_dense_layers=1,
    long_context_window=8192,
    source="DeepSeekMoE-16B: 2 shared + 64 routed top-6, fine-grained [arXiv:2401.06066]",
)
