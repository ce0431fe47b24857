"""command-r-35b [dense] — GQA, no-bias [hf:CohereForAI/c4ai-command-r-v01].

The largest dense config: 30.3 B parameters by ``param_count``, about 61 GB
in bf16, which one 80 GB card holds for serving.  Long contexts (cache
beyond 8192) run the sliding-window ring-buffer variant.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b",
    family="dense",
    num_layers=40,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=22528,
    vocab_size=256000,
    use_bias=False,
    layer_pattern=("attn",),
    long_context_window=8192,
    source="Command-R 35B: GQA, no-bias [hf:CohereForAI/c4ai-command-r-v01]",
)
