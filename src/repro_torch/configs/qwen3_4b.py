"""qwen3-4b [dense] — qk_norm + GQA [hf:Qwen/Qwen3-8B family].

Long contexts (cache beyond 8192) run the sliding-window ring-buffer variant.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-4b",
    family="dense",
    num_layers=36,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    d_ff=9728,
    vocab_size=151936,
    head_dim=128,
    qk_norm=True,
    layer_pattern=("attn",),
    long_context_window=8192,
    source="Qwen3-4B: qk_norm, GQA [hf:Qwen/Qwen3-8B]",
)
