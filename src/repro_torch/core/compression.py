"""Compression operators Q for compressed consensus (paper Assumption 3.2),
PyTorch port of ``repro.core.compression``: identity, random quantization,
global and blockwise top-k.

Every operator satisfies E ||Q(x) - x||^2 <= (1 - delta) ||x||^2.  Operators
act on a whole node axis at once (the reference vmaps them over it):
``encode(x, xi)`` takes ``x`` [m, ...] and the uniform noise ``xi`` of shape
``noise_shape(m, x.shape[1:])`` (``None``: no noise), and ``decode(payload,
shape, dtype)`` returns [m, *shape].  The noise is an argument, drawn by the
gossip layer from the trainer's ``torch.Generator`` (or injected), so two
gossip paths that draw the same shapes in the same order quantize alike.
The top-k operators draw no noise; they select with ``torch.topk``, as the
reference does with ``jax.lax.top_k`` (the two order ties differently).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from repro_torch.device import f32_full
from repro_torch.tree import leaves as tree_leaves
from repro_torch.tree import unflatten

__all__ = ["BlockTopK", "Compressor", "Identity", "RandomQuantization", "TopK",
           "make_compressor", "compress_pytree"]


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


@dataclasses.dataclass(frozen=True)
class TopK(Compressor):
    """Global top-K magnitude sparsification (Stich et al. 2018); delta = K/d.

    Payload per node: the kept ``values`` [m, k] f32 and their flat
    ``indices`` [m, k] int32.
    """

    fraction: float = 0.25

    @property
    def delta(self):
        return self.fraction

    def k_for(self, d: int) -> int:
        return max(1, int(round(self.fraction * d)))

    def encode(self, x, xi=None):
        flat = x.reshape(x.shape[0], -1).float()
        _, idx = torch.topk(flat.abs(), self.k_for(flat.shape[1]), dim=1)
        return {"values": torch.gather(flat, 1, idx), "indices": idx.to(torch.int32)}

    def decode(self, payload, shape, dtype):
        d = int(np.prod(shape)) if len(shape) else 1
        vals = payload["values"]
        out = torch.zeros(vals.shape[0], d, dtype=torch.float32, device=vals.device)
        out.scatter_(1, payload["indices"].long(), vals)
        return out.reshape((vals.shape[0],) + tuple(shape)).to(dtype)

    def bits_per_element(self, d):
        # (32-bit value + 32-bit index) per *actually kept* element: encode
        # transmits k_for(d) pairs, which rounding (and the k >= 1 floor)
        # makes different from fraction*d at small d
        return 64.0 * self.k_for(d) / max(d, 1)


@dataclasses.dataclass(frozen=True)
class BlockTopK(Compressor):
    """Blockwise top-k: keep the top round(fraction*B) magnitudes per block.

    Selection is local to a block, so indices cost log2(B) bits; the
    per-block tail bound gives the same contraction delta = K/d.  Payload
    per node: ``values`` [m, nb, k] f32 and in-block ``indices`` [m, nb, k]
    int32, each node's flat vector zero-padded to nb blocks.
    """

    fraction: float = 0.25
    block: int = 1024

    @property
    def delta(self):
        return self.fraction

    def k_per_block(self) -> int:
        return max(1, int(round(self.fraction * self.block)))

    def encode(self, x, xi=None):
        m = x.shape[0]
        flat = x.reshape(m, -1).float()
        pad = (-flat.shape[1]) % self.block
        if pad:
            flat = torch.nn.functional.pad(flat, (0, pad))
        blocks = flat.reshape(m, -1, self.block)
        _, idx = torch.topk(blocks.abs(), self.k_per_block(), dim=2)
        return {"values": torch.gather(blocks, 2, idx), "indices": idx.to(torch.int32)}

    def decode(self, payload, shape, dtype):
        d = int(np.prod(shape)) if len(shape) else 1
        vals = payload["values"]
        m, nb, _ = vals.shape
        blocks = torch.zeros(m, nb, self.block, dtype=torch.float32, device=vals.device)
        blocks.scatter_(2, payload["indices"].long(), vals)
        return blocks.reshape(m, -1)[:, :d].reshape((m,) + tuple(shape)).to(dtype)

    def bits_per_element(self, d):
        return (32.0 + math.log2(self.block)) * self.fraction


def make_compressor(spec: str) -> Compressor:
    """Parse 'none' | 'qXb' (e.g. q4b) | 'kqXb' (CUDA kernel-backed, packed
    wire format, supports the fused gossip round) | 'topK%' (e.g. top10) |
    'btopK%'."""
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
    if spec.startswith("btop"):
        return BlockTopK(fraction=float(spec[4:]) / 100.0)
    if spec.startswith("top"):
        return TopK(fraction=float(spec[3:]) / 100.0)
    raise ValueError(f"unknown compressor spec {spec!r}")


def compress_pytree(compressor: Compressor, tree, generator: torch.Generator | None = None,
                    noise=None):
    """Apply Q leaf by leaf (each leaf one vector, no node axis): returns
    Q(tree), dense, in the tree's structure.  Each leaf's uniforms, of
    ``noise_shape(1, leaf.shape)``, are drawn from ``generator`` in leaf
    order, or taken from ``noise`` (one array per leaf, in leaf order): the
    reference splits one JAX key per leaf, so tests inject its draws."""
    flat = tree_leaves(tree)
    out = []
    for i, leaf in enumerate(flat):
        shape = compressor.noise_shape(1, tuple(leaf.shape))
        xi = None
        if shape is not None and noise is not None:
            xi = torch.tensor(np.asarray(noise[i], np.float32), device=leaf.device).reshape(shape)
        elif shape is not None:
            if generator is None:
                raise ValueError(f"{type(compressor).__name__} needs a generator or noise=")
            xi = torch.rand(shape, generator=generator, device=leaf.device, dtype=torch.float32)
        q = compressor.decode(compressor.encode(leaf[None], xi), tuple(leaf.shape), leaf.dtype)
        out.append(q[0])
    return unflatten(tree, out)
