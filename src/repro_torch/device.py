"""Device resolution for the port's entry points."""
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
