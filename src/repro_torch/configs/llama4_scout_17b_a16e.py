"""llama4-scout-17b-a16e [moe] — 16 experts top-1 + shared, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E].

Every layer is MoE: one routed expert per token (top-1 of 16) plus one
always-on shared expert (``models/moe.py``).  The early-fusion vision path
is not exercised by the assigned input shapes (text-only tokens); the text
backbone is complete.  About 106.7 B parameters (213 GB in bf16): one
80 GB card runs its full-width layers at a reduced depth, which the dry run
(``launch/dryrun.py``) picks.

long_500k: sliding-window decode variant (window 8192).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    layer_pattern=("attn",),
    num_experts=16,
    num_shared_experts=1,
    experts_per_token=1,
    moe_d_ff=8192,
    long_context_window=8192,
    source="Llama-4-Scout-17B-16E: MoE top-1, early fusion [hf:meta-llama/Llama-4-Scout-17B-16E]",
)
