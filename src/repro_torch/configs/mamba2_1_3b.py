"""mamba2-1.3b [ssm] — SSD (state-space duality) [arXiv:2405.21060].

Attention-free: 48 identical Mamba2 blocks (d_ff=0 -> no interleaved MLP,
as in the Mamba family; ``models/ssm.py``).  Decode state is O(1) per token
(SSM state 128 + conv tail).  Prefill runs whole chunks of 256 tokens.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=16,   # nominal; unused by the SSD mixer
    num_kv_heads=16,
    d_ff=0,         # attn-free Mamba stack: no MLP
    vocab_size=50280,
    layer_pattern=("mamba2",),
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv_width=4,
    ssm_chunk=256,
    source="Mamba2-1.3B SSD [arXiv:2405.21060]",
)
