"""Sliding-window attention: wrapper and plain version.

Replaces ``repro/kernels/sliding_window.py::sliding_window_attention_pallas``.
On the TPU this was a kernel of its own, because the flash kernel held the
whole key sequence in VMEM.  On CUDA the flash kernel's kv loop already loads
only the O(window) live band, so this wrapper launches the same
``flash_attn_fwd`` kernel (``csrc/flash_attn.cu``) with the window set, and
counts its launches separately.
"""
from __future__ import annotations

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import flash_attention_plain, launch_flash

launches = _build.LaunchCounter("sliding_window_attention")


def sliding_window_attention_plain(q, k, v, *, window: int, scale=None):
    """Plain version: causal band attention, materialized softmax."""
    return flash_attention_plain(q, k, v, causal=True, window=window, scale=scale)


def sliding_window_attention(q, k, v, *, window: int, scale=None):
    """Causal sliding-window self-attention over [B, S, H, hd]."""
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if q.device.type == "cpu":
        return sliding_window_attention_plain(q, k, v, window=window, scale=scale)
    return launch_flash(q, k, v, causal=True, window=window, scale=scale, counter=launches)
