"""Public ops over the kernels (``repro.kernels.ops``).

Attention -- prefill: ``[B, S, H, hd]`` with kv heads already repeated
(flash, sliding window, block-sparse over a :class:`BlockSparsePattern`);
decode: a ``[B, 1, H, hd]`` query over a ``[B, L, KV, hd]`` cache, query
heads kv-major (head ``j*G+g`` belongs to kv head ``j``).

Compression -- padding any flat vector to the quantize kernels' ``[rows,
128]`` layout; :class:`KernelQuantization`, the compressor whose wire is
the packed payload and which runs the fused CHOCO round; and block top-k
(:func:`block_topk`, :class:`KernelBlockTopK`), whose payload is the dense
masked residual.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core.compression import Compressor
from repro_torch.kernels import block_sparse as _sparse
from repro_torch.kernels import choco_fused as _fused
from repro_torch.kernels import decode as _decode
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import quantize as _quant
from repro_torch.kernels import sliding_window as _sliding
from repro_torch.kernels import topk as _topk
from repro_torch.kernels.ref import LANES, _rows_for, f32_full, quantize_kv_ref, tau_for


def flash_attention(q, k, v, *, causal: bool = True, window: int | None = None):
    """Flash attention over [B, S, H, hd]; ragged lengths are masked in the
    kernel, which equals the reference wrapper's pad / unpad result."""
    return _flash.flash_attention(q, k, v, causal=causal, window=window)


def sliding_window_attention(q, k, v, *, window: int):
    """Causal sliding-window attention over [B, S, H, hd]."""
    return _sliding.sliding_window_attention(q, k, v, window=window)


def block_sparse_attention(q, k, v, pattern):
    """Block-sparse attention over [B, S, H, hd]; the pattern's bitmap picks
    which (q-block, kv-block) tiles are computed (see kernels/block_sparse.py)."""
    return _sparse.block_sparse_attention(q, k, v, pattern)


def decode_attention_kernel(q, k, v, valid, *, k_scale=None, v_scale=None):
    """Decode attention: q [B, 1, H, hd] over the cache -> [B, 1, H, hd]."""
    B, one, H, hd = q.shape
    if one != 1:
        raise ValueError(f"decode query must be [B, 1, H, hd], got {tuple(q.shape)}")
    KV = k.shape[2]
    qg = q.reshape(B, KV, H // KV, hd)
    out = _decode.decode_attention(qg, k, v, valid, k_scale=k_scale, v_scale=v_scale)
    return out.reshape(B, 1, H, hd)


def quantize_kv(x: torch.Tensor):
    """Per-(position, kv-head) int8 KV quantization; x: [..., hd] ->
    (int8 [..., hd], f32 scales [...])."""
    return quantize_kv_ref(x)


# -------------------------------------------------------------- compression
def _pad_to_rows(flat: torch.Tensor, row_unit: int) -> torch.Tensor:
    d = flat.shape[0]
    pad = (-d) % (row_unit * LANES)
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return flat.reshape(-1, LANES)


def quantize(x: torch.Tensor, xi: torch.Tensor, bits: int = 4):
    """Stochastically quantize a node-stacked tensor [m, ...]; returns the
    packed wire payload {"levels" [m, rows/pack, 128] u8, "signs" [m, rows/8,
    128] u8, "norm" [m] f32}.  ``xi``: [m, rows, 128] f32 uniform noise.
    One kernel launch per node (the reference vmaps one call over them)."""
    m = x.shape[0]
    flat = x.reshape(m, -1).float()
    norms = _fused.node_norms(flat)
    pack = 8 // bits
    levels, signs = [], []
    for i in range(m):
        lvl, sign = _quant.quantize(_pad_to_rows(flat[i], 8 * pack), xi[i], norms[i], bits)
        levels.append(lvl)
        signs.append(sign)
    return {"levels": torch.stack(levels), "signs": torch.stack(signs), "norm": norms}


def dequantize(payload, shape, dtype, bits: int = 4):
    """Inverse of :func:`quantize` -> [m, *shape] in ``dtype``."""
    d = int(np.prod(shape)) if len(shape) else 1
    norms = payload["norm"]
    scales = norms / f32_full(norms, (1 << bits) * tau_for(d, bits))
    outs = [_quant.dequantize(payload["levels"][i], payload["signs"][i], scales[i], bits)
            .reshape(-1)[:d].reshape(shape) for i in range(norms.shape[0])]
    return torch.stack(outs).to(dtype)


def fused_choco_round_leaf(leaf, hat, s, xi, topology, gamma, bits: int):
    """One fused-kernel CHOCO round for a stacked leaf [m, ...] -- see
    kernels/choco_fused.py.  Returns (theta_new, hat_new, s_new)."""
    return _fused.fused_round_leaf(leaf, hat, s, xi, topology.shifts, gamma, bits)


@dataclasses.dataclass(frozen=True)
class KernelQuantization(Compressor):
    """Random quantization on the CUDA kernels (packed wire format).

    The payload that crosses the gossip is the *packed* uint8 levels + uint8
    sign bitmask: (bits + 1)/8 bytes per element instead of 4.  Supports the
    single-pass fused gossip round (``fused_round``).
    """

    bits: int = 4

    # capability flag checked by the gossip layer's fused dispatch
    supports_fused_round = True

    def fused_round(self, leaf, hat, s, xi, topology, gamma):
        return fused_choco_round_leaf(leaf, hat, s, xi, topology, gamma, self.bits)

    def fused_encode(self, theta_new, hat, xi):
        """The faulted round's one-pass encode (the fused kernel's digest
        variant): (payload, hat_new, digest [m] int32) of a stacked chunk."""
        return _fused.fused_encode_leaf(theta_new, hat, xi, self.bits)

    @property
    def delta(self):
        return 0.0  # see delta_for

    def delta_for(self, d: int) -> float:
        lvl = float(2**self.bits)
        return 1.0 / (1.0 + min(d / lvl**2, (d**0.5) / lvl))

    def noise_shape(self, m, inner_shape):
        d = int(np.prod(inner_shape)) if len(inner_shape) else 1
        return (m, _rows_for(d, 8 // self.bits), LANES)

    def encode(self, x, xi=None):
        return quantize(x, xi, self.bits)

    def decode(self, payload, shape, dtype):
        return dequantize(payload, shape, dtype, self.bits)

    def bits_per_element(self, d):
        return self.bits + 1 + 32.0 / max(d, 1)


def block_topk(x: torch.Tensor, fraction: float = 0.25, block: int = 1024) -> torch.Tensor:
    """Dense blockwise top-k sparsification of a node-stacked tensor [m, ...]:
    each node's flat vector in f32, padded to a multiple of ``block``, masked
    to the top ``round(fraction * block)`` magnitudes of each block, unpadded
    and cast back (the reference vmaps its ``block_topk`` over nodes).  All
    nodes' blocks go through one kernel launch."""
    m = x.shape[0]
    flat = x.reshape(m, -1).float()
    d = flat.shape[1]
    pad = (-d) % block
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    k = max(1, int(round(fraction * block)))
    out = _topk.block_topk(flat.reshape(-1, block), k)
    return out.reshape(m, -1)[:, :d].reshape(x.shape).to(x.dtype)


@dataclasses.dataclass(frozen=True)
class KernelBlockTopK(Compressor):
    """Block top-k on the bisection kernel (``kernels/topk.py``).

    ``encode`` returns the dense masked residual [m, ...] (the sparse
    values + indices wire format is :class:`~repro_torch.core.compression.BlockTopK`'s);
    its bit count is that format's, and the contraction factor is
    ``fraction``.
    """

    fraction: float = 0.25
    block: int = 1024

    @property
    def delta(self):
        return self.fraction

    def encode(self, x, xi=None):
        return block_topk(x, self.fraction, self.block)

    def decode(self, payload, shape, dtype):
        return payload.reshape((payload.shape[0],) + tuple(shape)).to(dtype)

    def bits_per_element(self, d):
        return (32.0 + math.log2(self.block)) * self.fraction
