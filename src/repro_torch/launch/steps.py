"""Serving step builders on the consensus model (the serving half of
``repro.launch.steps``; the trainer half waits for the training slice)."""
from __future__ import annotations

from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig

__all__ = ["make_prefill_step", "make_decode_step"]


def make_prefill_step(cfg: ModelConfig, cache_len: int):
    def prefill_step(params, batch):
        return T.prefill(params, batch, cfg, cache_len)

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    def decode_step(params, cache, tokens, pos):
        return T.decode_step(params, tokens, cache, pos, cfg)

    return decode_step
