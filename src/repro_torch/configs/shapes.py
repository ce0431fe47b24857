"""Assigned input shapes and abstract stand-ins for the dry run (port of
``repro.configs.shapes``).

``SHAPES`` maps shape-id -> (seq_len, global_batch, step_kind).
``input_specs`` returns the inputs each arch's step consumes as tensors on
``torch.device("meta")``: the reference's shapes and dtypes, nothing
allocated.
"""
from __future__ import annotations

import dataclasses

import torch

META = torch.device("meta")


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    step: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def supports_shape(cfg, shape: InputShape) -> bool:
    """long_500k requires sub-quadratic decode (a ring-buffer window, or no
    full-attention layer)."""
    if shape.name == "long_500k":
        return cfg.supports_long_context
    return True


def batch_specs(cfg, batch: int, seq: int, num_nodes: int | None = None) -> dict:
    """Abstract train/prefill batch. With num_nodes, adds a leading node axis."""
    lead = (num_nodes, batch // num_nodes) if num_nodes else (batch,)
    spec = {"tokens": torch.empty(lead + (seq,), dtype=torch.int32, device=META)}
    if cfg.is_encdec:
        spec["frames"] = torch.empty(lead + (cfg.encoder_context, cfg.d_model),
                                     dtype=torch.bfloat16, device=META)
    if cfg.num_patches > 0:
        spec["patches"] = torch.empty(lead + (cfg.num_patches, cfg.d_model),
                                      dtype=torch.bfloat16, device=META)
    return spec


def decode_specs(cfg, batch: int) -> dict:
    """Abstract decode-step inputs: one new token per sequence."""
    return {"tokens": torch.empty((batch, 1), dtype=torch.int32, device=META),
            "pos": torch.empty((), dtype=torch.int32, device=META)}


def input_specs(cfg, shape_name: str, num_nodes: int | None = None) -> dict:
    shape = SHAPES[shape_name]
    if shape.step == "train":
        return batch_specs(cfg, shape.global_batch, shape.seq_len, num_nodes)
    if shape.step == "prefill":
        return batch_specs(cfg, shape.global_batch, shape.seq_len)
    return decode_specs(cfg, shape.global_batch)
