"""whisper-small [audio] — encoder-decoder, conv frontend stubbed [arXiv:2212.04356].

The mel-spectrogram and conv feature extractor are stubbed: the caller
passes 1500 precomputed frame embeddings ``frames`` [B, 1500, 768].  The
port implements the 12-layer encoder (non-causal self-attention) and the
12-layer decoder (causal self-attention + cross-attention), GELU MLPs,
LayerNorm and biases: the Whisper transformer backbone.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="audio",
    num_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    d_ff=3072,
    vocab_size=51865,
    use_bias=True,
    layer_pattern=("attn",),
    mlp_type="gelu",
    norm_type="layernorm",
    encoder_layers=12,
    cross_attention=True,
    encoder_context=1500,
    source="Whisper-small enc-dec backbone [arXiv:2212.04356]",
)
