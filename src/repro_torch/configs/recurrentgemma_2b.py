"""recurrentgemma-2b [hybrid] — RG-LRU + local attention, 1:2 [arXiv:2402.19427].

Griffin pattern: (rglru, rglru, local_attn) cycled over 26 layers — 8 full
blocks + 2 remainder recurrent layers.  Local attention window 2048, head
dim 256, MQA (10 query heads on one kv head).  The decode state is O(window
+ d) per layer: a 2048-row ring for each local layer, ``{h, conv}`` for each
recurrent one.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    d_ff=7680,
    vocab_size=256000,
    head_dim=256,
    layer_pattern=("rglru", "rglru", "local_attn"),
    sliding_window=2048,
    rglru_width=2560,
    mlp_type="gelu",
    source="RecurrentGemma-2B: RG-LRU + local attn 1:2 [arXiv:2402.19427]",
)
