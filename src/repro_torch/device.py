"""Device resolution for the port's entry points, and :func:`f32_full`, which
lives here (not in ``kernels/ref.py``, which re-exports it) so that the
modules ``kernels/ops.py`` imports need nothing of the ``kernels`` package."""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``"cuda"``/``"cpu"`` (or a ``torch.device``) -> ``torch.device``.

    Asking for CUDA on a machine without a card raises instead of falling
    back to the CPU.  Float32 products are pinned to full precision (TF32
    off for matmuls and cuDNN) so the card's reference runs keep float32
    semantics.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA device requested but torch.cuda.is_available() is False; "
                "pass device='cpu' to run the plain PyTorch reference path"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}; use 'cuda' or 'cpu'")
    return dev


def f32_full(like: torch.Tensor, value: float) -> torch.Tensor:
    """``value`` rounded to f32, shaped and placed like ``like``."""
    return torch.full(like.shape, value, dtype=torch.float32, device=like.device)
