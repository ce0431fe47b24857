"""PyTorch/CUDA port of the AD-GDA system (``repro``): the serving path and
the trainer's main path.

The JAX package ``repro`` is the reference; this package mirrors its module
paths and public layouts and never imports ``jax`` or ``repro``.  Attention
on the serving path, and the quantized CHOCO gossip of the AD-GDA trainer
(``core/``, ``launch/train.py``), run through hand-written CUDA kernels for
Hopper (``csrc/``), built with ``nvcc`` at first use (``kernels/_build.py``).

Entry points take an explicit ``device``; the default is ``"cuda"`` and a
missing card raises (see :func:`resolve_device`).  Tests pass
``device="cpu"``, where each kernel wrapper takes its plain PyTorch version.
"""
from __future__ import annotations

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
