"""internvl2-2b [vlm] — InternViT + InternLM2 backbone [arXiv:2404.16821].

The ViT vision encoder and its MLP projector are stubbed: the caller passes
256 precomputed patch embeddings ``patches`` [B, 256, d_model], spliced
over the first 256 token positions (early fusion).  The port implements the
InternLM2-style GQA language decoder that consumes them.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=92553,
    layer_pattern=("attn",),
    mlp_type="swiglu",
    norm_type="rmsnorm",
    num_patches=256,
    source="InternVL2-2B: InternViT-300M + InternLM2-1.8B [arXiv:2404.16821]",
)
