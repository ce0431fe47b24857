"""Architecture configuration schema (same fields and defaults as
``repro.models.config.ModelConfig``).

One ``ModelConfig`` describes any family of the reference: dense GQA
decoders, fine-grained MoE, Mamba2 SSD, RG-LRU hybrids, encoder-decoder and
VLM backbones, all of which the port runs (``models/transformer.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Literal

import torch

Family = Literal["dense", "moe", "ssm", "hybrid", "audio", "vlm"]
Mixer = Literal["attn", "local_attn", "mamba2", "rglru"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int | None = None  # default d_model // num_heads

    # attention details
    qk_norm: bool = False
    use_bias: bool = False
    rope_theta: float = 10_000.0
    sliding_window: int | None = None  # window for "local_attn" mixers
    # long-context decode: dense archs switch to a sliding-window ring
    # buffer of this size once the cache would exceed it
    long_context_window: int | None = None

    # layer pattern: cycled to num_layers; default all-attention
    layer_pattern: tuple[Mixer, ...] = ("attn",)

    # MLP
    mlp_type: Literal["swiglu", "gelu"] = "swiglu"
    norm_type: Literal["rmsnorm", "layernorm"] = "rmsnorm"

    # MoE (num_experts == 0 -> dense FFN everywhere)
    num_experts: int = 0
    num_shared_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    first_dense_layers: int = 0

    # SSM (mamba2)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    ssm_chunk: int = 256

    # RG-LRU (hybrid)
    rglru_width: int | None = None

    # encoder-decoder
    encoder_layers: int = 0
    cross_attention: bool = False
    encoder_context: int = 1500

    # VLM early fusion
    num_patches: int = 0

    dtype: str = "bfloat16"
    source: str = ""

    # attention kernel dispatch: None = plain PyTorch attention; "flash"
    # routes causal self-attention through the flash / sliding-window CUDA
    # kernels.  Decode ticks route through the decode kernel whenever the
    # knob is set or the KV cache is quantized.
    attn_kernel: str | None = None
    # int8 KV cache with per-(slot, kv-head) scales, dequantized inside the
    # decode kernel
    quantized_kv: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.num_heads

    @property
    def activation_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def supports_long_context(self) -> bool:
        """True if decode cost/state is sub-quadratic in context length."""
        mixers = {self.mixer_for_layer(i) for i in range(self.num_layers)}
        if "attn" in mixers:
            return self.long_context_window is not None
        return True  # ssm / rglru / local_attn only

    def mixer_for_layer(self, i: int) -> str:
        return self.layer_pattern[i % len(self.layer_pattern)]

    def ffn_is_moe(self, i: int) -> bool:
        return self.num_experts > 0 and i >= self.first_dense_layers

    def reduced(self, layers: int = 2, d_model: int = 256, experts: int = 4) -> "ModelConfig":
        """Tiny same-family variant for CPU smoke tests."""
        heads = max(2, min(4, self.num_heads))
        kv = 1 if self.num_kv_heads == 1 else max(1, heads // 2)
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            num_layers=layers,
            d_model=d_model,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=d_model // heads,
            d_ff=2 * d_model,
            vocab_size=512,
            num_experts=min(self.num_experts, experts) if self.num_experts else 0,
            num_shared_experts=min(self.num_shared_experts, 1),
            experts_per_token=min(self.experts_per_token, 2) if self.experts_per_token else 0,
            moe_d_ff=d_model if self.moe_d_ff else 0,
            ssm_state=min(self.ssm_state, 32) if self.ssm_state else 0,
            ssm_head_dim=32 if self.ssm_state else self.ssm_head_dim,
            ssm_chunk=32,
            rglru_width=d_model if self.rglru_width else None,
            encoder_layers=min(self.encoder_layers, 2),
            encoder_context=32,
            sliding_window=min(self.sliding_window, 16) if self.sliding_window else None,
            long_context_window=min(self.long_context_window, 16) if self.long_context_window else None,
            num_patches=min(self.num_patches, 8) if self.num_patches else 0,
            first_dense_layers=min(self.first_dense_layers, 1),
            dtype="float32",
        )
