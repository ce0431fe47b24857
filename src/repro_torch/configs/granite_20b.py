"""granite-20b [dense] — llama-arch code model, MQA [arXiv:2405.04324].

MQA (one kv head): in decode all 48 query heads share one pass over the
cache, which is the decode kernel's widest group.  Long contexts (cache
beyond 8192) run the sliding-window ring-buffer variant.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b",
    family="dense",
    num_layers=52,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,
    d_ff=24576,
    vocab_size=49152,
    head_dim=128,
    layer_pattern=("attn",),
    mlp_type="gelu",  # d_ff = 4*d GELU MLP — matches the 20B parameter count
    long_context_window=8192,
    source="Granite-20B code: llama-arch, MQA [arXiv:2405.04324]",
)
