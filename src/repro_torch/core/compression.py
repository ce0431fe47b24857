"""Compression operators Q for compressed consensus (paper Assumption 3.2),
PyTorch port of ``repro.core.compression`` (top-k operators not yet ported).

Every operator satisfies E ||Q(x) - x||^2 <= (1 - delta) ||x||^2.  Operators
act on a whole node axis at once (the reference vmaps them over it):
``encode(x, xi)`` takes ``x`` [m, ...] and the uniform noise ``xi`` of shape
``noise_shape(m, x.shape[1:])`` (``None``: no noise), and ``decode(payload,
shape, dtype)`` returns [m, *shape].  The noise is an argument, drawn by the
gossip layer from the trainer's ``torch.Generator`` (or injected), so two
gossip paths that draw the same shapes in the same order quantize alike.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.kernels.ref import f32_full

__all__ = ["Compressor", "Identity", "RandomQuantization", "make_compressor"]


class Compressor:
    """Base class: Q(x) = decode(encode(x, xi))."""

    delta: float  # contraction factor in (0, 1]

    def noise_shape(self, m: int, inner_shape) -> tuple[int, ...] | None:
        """Shape of the uniform noise one encode of [m, *inner_shape] takes."""
        return None

    def encode(self, x: torch.Tensor, xi: torch.Tensor | None = None) -> Any:
        raise NotImplementedError

    def decode(self, payload: Any, shape, dtype) -> torch.Tensor:
        raise NotImplementedError

    def bits_per_element(self, d: int) -> float:
        """Transmitted bits per original vector element."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class Identity(Compressor):
    delta: float = 1.0

    def encode(self, x, xi=None):
        return x

    def decode(self, payload, shape, dtype):
        return payload.reshape((payload.shape[0],) + tuple(shape)).to(dtype)

    def bits_per_element(self, d):
        return 32.0


@dataclasses.dataclass(frozen=True)
class RandomQuantization(Compressor):
    """b-bit random quantization (paper eq. (2), Alistarh et al. 2017).

    x_b = sign(x) * ||x|| / (2^b * tau) * floor(2^b |x| / ||x|| + xi),
    xi ~ U[0,1]^d;  tau = 1 + min(d / 2^{2b}, sqrt(d) / 2^b);  delta = 1/tau.
    Levels in [0, 2^b] (one more than packs into b bits); the noise has the
    encoded tensor's own shape.
    """

    bits: int = 8

    @property
    def delta(self):  # depends on d; report the conservative d->inf value
        return 0.0  # use delta_for(d)

    def delta_for(self, d: int) -> float:
        return 1.0 / self._tau(d)

    def _tau(self, d: int) -> float:
        lvl = float(2**self.bits)
        return 1.0 + min(d / lvl**2, (d**0.5) / lvl)

    def noise_shape(self, m, inner_shape):
        return (m,) + tuple(inner_shape)

    def encode(self, x, xi=None):
        xf = x.float()
        m = xf.shape[0]
        bcast = (m,) + (1,) * (xf.ndim - 1)
        norm = (xf * xf).reshape(m, -1).sum(1).sqrt()
        lvl = float(2**self.bits)
        safe = torch.where(norm > 0, norm, torch.ones_like(norm)).reshape(bcast)
        q = torch.floor(lvl * xf.abs() / safe + xi)
        q = torch.clamp(q, 0, lvl)  # one extra level possible from +xi
        levels = q.to(torch.uint8 if self.bits <= 7 else torch.int16)
        return {"levels": levels, "signs": torch.signbit(xf), "norm": norm}

    def decode(self, payload, shape, dtype):
        lvl = float(2**self.bits)
        d = int(np.prod(shape)) if len(shape) else 1
        norm = payload["norm"]
        scale = norm / f32_full(norm, lvl * self._tau(d))
        m = norm.shape[0]
        mag = scale.reshape((m,) + (1,) * len(shape)) * payload["levels"].float().reshape(
            (m,) + tuple(shape))
        out = torch.where(payload["signs"].reshape(mag.shape), -mag, mag)
        return out.to(dtype)

    def bits_per_element(self, d):
        # b bits of level + 1 sign bit + amortized 32-bit norm
        return self.bits + 1 + 32.0 / max(d, 1)


def make_compressor(spec: str) -> Compressor:
    """Parse 'none' | 'qXb' (e.g. q4b) | 'kqXb' (CUDA kernel-backed, packed
    wire format, supports the fused gossip round).  Top-k specs ('topK%',
    'btopK%') are not yet ported."""
    spec = spec.lower().strip()
    if spec in ("none", "identity"):
        return Identity()
    if spec.startswith("kq") and spec.endswith("b"):
        # lazy import: kernels.ops imports this module for the Compressor base
        from repro_torch.kernels.ops import KernelQuantization

        bits = int(spec[2:-1])
        if bits not in (1, 2, 4, 8):
            raise ValueError(
                f"kernel quantization needs bits in (1, 2, 4, 8) so levels "
                f"pack into bytes; got {spec!r}"
            )
        return KernelQuantization(bits=bits)
    if spec.startswith("q") and spec.endswith("b"):
        return RandomQuantization(bits=int(spec[1:-1]))
    if spec.startswith("btop") or spec.startswith("top"):
        raise NotImplementedError(
            f"compressor {spec!r} is not yet ported to repro_torch; see ROADMAP.md"
        )
    raise ValueError(f"unknown compressor spec {spec!r}")
