"""Plain PyTorch oracles for the port's kernels (``repro.kernels.ref``).

Attention: exactly what the kernels compute, with materialized scores and the
same finite ``-1e30`` mask sentinel, in float32; block-sparse attention
expands its pattern's block bitmap to an element mask.

Compression: stochastic b-bit quantization with 2^b levels {0..2^b-1} and
bit-packing (``8/bits`` level rows per uint8 row, 8 sign rows per uint8
row), the two fused CHOCO-round passes, and block top-k by threshold
bisection.  Every operation is one IEEE
rounding in the order the reference takes, so the kernels, built without
FMA contraction, equal these bit for bit.  Scalars that enter a division
are device tensors: PyTorch on the card divides by a host scalar as a
multiply by its reciprocal, which rounds differently.
"""
from __future__ import annotations

import math

import torch

from repro_torch.device import f32_full  # noqa: F401  (its home is device.py: see there)

NEG_INF = -1e30
BISECT_ITERS = 20
#: unit roundoff of bf16 (8 significant bits)
BF16_UNIT_ROUNDOFF = 2.0**-8


def flash_attention_ref(q, k, v, *, causal=True, window=None, scale=None):
    """q, k, v: [BH, S, hd] -> [BH, Sq, hd] in q.dtype.

    Plain materialized-softmax attention with causal / sliding-window masks.
    """
    hd = q.shape[-1]
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    s = torch.einsum("bqk,bsk->bqs", q.float(), k.float()) * scale
    qpos = torch.arange(q.shape[1], device=q.device)
    kpos = torch.arange(k.shape[1], device=q.device)
    mask = torch.ones(q.shape[1], k.shape[1], dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos[:, None] >= kpos[None, :]
    if window is not None:
        mask &= qpos[:, None] - kpos[None, :] < window
    s = s.masked_fill(~mask[None], NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqs,bsk->bqk", p, v.float()).to(q.dtype)


def p_rounding_bound(attention, v: torch.Tensor) -> torch.Tensor:
    """Per-element bound, in f32, on what rounding the softmax probabilities
    to bf16 before the PV product moves an attention output.

    The bf16 attention kernels round each p_j once (relative error at most
    u = 2**-8), as the TPU's MXU does to an f32 product at default
    precision; the plain versions keep P in f32.  The change in output i is
    then at most u * sum_j p_j |v_j| / l, which is u times the plain
    attention of |v|: ``attention`` is that plain version with q, k (and
    pattern) bound, taking v.
    """
    return BF16_UNIT_ROUNDOFF * attention(v.abs()).float()


def block_sparse_mask(pattern, device) -> torch.Tensor:
    """The (q, k) pairs a ``BlockSparsePattern`` attends, [Sq, Sk] bool: its
    block bitmap expanded to elements, live blocks AND, for PARTIAL blocks,
    the causal / window mask."""
    block = torch.as_tensor(pattern.bitmap, device=device)  # [nq, nk]

    def expand(b):
        return b.repeat_interleave(pattern.block_q, 0).repeat_interleave(pattern.block_k, 1)

    qpos = torch.arange(pattern.seq_q, device=device)
    kpos = torch.arange(pattern.seq_k, device=device)
    elem = torch.ones(pattern.seq_q, pattern.seq_k, dtype=torch.bool, device=device)
    if pattern.causal:
        elem &= qpos[:, None] >= kpos[None, :]
    if pattern.window is not None:
        elem &= qpos[:, None] - kpos[None, :] < pattern.window
    return expand(block != 0) & (expand(block == 2) | elem)


def block_sparse_attention_ref(q, k, v, pattern, *, scale=None):
    """q, k, v: [BH, S, hd] -> [BH, Sq, hd] in q.dtype, over ``pattern``'s
    (a ``BlockSparsePattern``) block bitmap: materialized-softmax attention
    under :func:`block_sparse_mask`.  Patterns keep the diagonal live, so
    every q row has a live key.
    """
    hd = q.shape[-1]
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    mask = block_sparse_mask(pattern, q.device)
    s = torch.einsum("bqk,bsk->bqs", q.float(), k.float()) * scale
    s = s.masked_fill(~mask[None], NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqs,bsk->bqk", p, v.float()).to(q.dtype)


def quantize_kv_ref(x: torch.Tensor):
    """Per-(position, kv-head) int8 symmetric quantization of a KV tensor.

    x: [..., hd] -> (int8 values [..., hd], f32 scales [...]).  scale =
    absmax/127; all-zero rows get scale 0.  ``torch.round`` rounds half to
    even, as ``jnp.round`` does, so the int8 values match the reference.
    """
    xf = x.float()
    absmax = xf.abs().amax(dim=-1)
    scale = absmax / 127.0
    safe = torch.where(absmax > 0, absmax, torch.ones_like(absmax))
    inv = torch.where(absmax > 0, 127.0 / safe, torch.zeros_like(absmax))
    q = torch.clamp(torch.round(xf * inv[..., None]), -127, 127).to(torch.int8)
    return q, scale


def decode_attention_ref(q, k, v, valid, *, scale=None, k_scale=None, v_scale=None):
    """Single-query grouped-query attention over a KV cache.

      q: [B, KV, G, hd]; k, v: [B, L, KV, hd] (float, or int8 with scales);
      valid: [B, L] bool; k_scale, v_scale: [B, L, KV] f32 -- k_scale scales
      the scores after QK, v_scale scales p before PV.
    Returns [B, KV, G, hd] in q.dtype.
    """
    hd = q.shape[-1]
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    kf, vf = k.float(), v.float()
    s = torch.einsum("bngd,blnd->bngl", q.float() * scale, kf)
    if k_scale is not None:
        s = s * k_scale.permute(0, 2, 1)[:, :, None, :]
    s = s.masked_fill(~valid[:, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    if v_scale is not None:
        p = p * v_scale.permute(0, 2, 1)[:, :, None, :]
    return torch.einsum("bngl,blnd->bngd", p, vf).to(q.dtype)


# ----------------------------------------------------------------- quantize
LANES = 128


def _rows_for(d: int, pack: int) -> int:
    """Pad flat length d up to a multiple of pack*8*LANES and return rows."""
    unit = pack * 8 * LANES  # pack rows x sign rows x lanes alignment
    padded = ((d + unit - 1) // unit) * unit
    return padded // LANES


def tau_for(d: int, bits: int) -> float:
    """Paper eq. (2) normalizer: tau = 1 + min(d/2^2b, sqrt(d)/2^b)."""
    lvl = float(1 << bits)
    return 1.0 + min(d / lvl**2, (d**0.5) / lvl)



def encode_scale(norm: torch.Tensor, bits: int) -> torch.Tensor:
    """2^b / max(norm, 1e-30) in f32, an IEEE quotient."""
    return f32_full(norm, float(1 << bits)) / torch.clamp(norm.float(), min=1e-30)


def _pack(vals: torch.Tensor, per_byte: int, width: int) -> torch.Tensor:
    """[..., rows, 128] small ints -> [..., rows/per_byte, 128] uint8: row
    ``r*per_byte + j`` lands in bits ``j*width`` of packed row ``r``."""
    *lead, rows, lanes = vals.shape
    v = vals.to(torch.int32).reshape(*lead, rows // per_byte, per_byte, lanes)
    sh = torch.arange(per_byte, dtype=torch.int32, device=vals.device) * width
    return (v << sh[:, None]).sum(-2).to(torch.uint8)


def _unpack(packed: torch.Tensor, per_byte: int, width: int) -> torch.Tensor:
    """Inverse of :func:`_pack` -> [..., rows, 128] int32."""
    *lead, prows, lanes = packed.shape
    sh = torch.arange(per_byte, dtype=torch.int32, device=packed.device) * width
    v = (packed.to(torch.int32)[..., None, :] >> sh[:, None]) & ((1 << width) - 1)
    return v.reshape(*lead, prows * per_byte, lanes)


def quantize_ref(x: torch.Tensor, xi: torch.Tensor, norm, bits: int):
    """Quantize a [rows, 128] f32 array (pre-padded; noise xi in [0, 1)).

    Returns (packed_levels [rows/pack, 128] uint8, packed_signs [rows/8, 128]
    uint8).
    """
    assert x.ndim == 2 and x.shape[1] == LANES
    norm = torch.as_tensor(norm, dtype=torch.float32, device=x.device)
    q = torch.floor(x.abs() * encode_scale(norm, bits) + xi)
    lvl = torch.clamp(q, 0, (1 << bits) - 1)
    return _pack(lvl, 8 // bits, bits), _pack(x < 0, 8, 1)


def dequantize_ref(packed_lvl: torch.Tensor, packed_sign: torch.Tensor, scale, bits: int):
    """Inverse of quantize_ref -> [rows, 128] f32; ``scale`` = norm / (2^b tau)."""
    lvl = _unpack(packed_lvl, 8 // bits, bits).float()
    sign = _unpack(packed_sign, 8, 1)
    mag = lvl * torch.as_tensor(scale, dtype=torch.float32, device=lvl.device)
    return torch.where(sign == 1, -mag, mag)


# ---------------------------------------------------- fused CHOCO round oracles
def fused_encode_ref(theta_new, hat, xi, scales, bits: int):
    """theta_new/hat: [m, rows, 128] (leaf dtype), xi: [m, rows, 128] f32,
    scales: [m, 2] f32 (encode scale 2^b/||resid||, dequant scale
    ||resid||/(2^b tau)).  Returns (packed_lvl [m, rows/pack, 128] u8,
    packed_sign [m, rows/8, 128] u8, hat_new [m, rows, 128] in hat.dtype).
    """
    resid = (theta_new - hat).float()
    q = torch.floor(resid.abs() * scales[:, 0, None, None] + xi)
    lvlf = torch.clamp(q, 0, (1 << bits) - 1)
    neg = resid < 0
    mag = lvlf * scales[:, 1, None, None]
    hat_new = (hat.float() + torch.where(neg, -mag, mag)).to(hat.dtype)
    return _pack(lvlf, 8 // bits, bits), _pack(neg, 8, 1), hat_new


def fused_mix_ref(rolled_lvl, rolled_sign, s, wscale, bits: int):
    """rolled_lvl: [K, m, rows/pack, 128] u8, rolled_sign: [K, m, rows/8, 128]
    u8, s: [m, rows, 128], wscale: [K, m] f32.  Returns s_new [m, rows, 128]:
    s + sum_k deq(payload_k) * wscale[k], accumulated in f32 in shift order.
    """
    acc = torch.zeros(s.shape, dtype=torch.float32, device=s.device)
    for k in range(rolled_lvl.shape[0]):
        mag = _unpack(rolled_lvl[k], 8 // bits, bits).float() * wscale[k, :, None, None]
        acc = acc + torch.where(_unpack(rolled_sign[k], 8, 1) == 1, -mag, mag)
    return (s.float() + acc).to(s.dtype)


def digest_ref(x: torch.Tensor) -> torch.Tensor:
    """Per-node int32 wraparound sum of the raw bits ([m, ...] -> [m] int32),
    as ``repro.core.faults.digest``: bitcast to the same-width integer,
    widen to int32, sum."""
    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32}[x.element_size()]
    total = x.reshape(x.shape[0], -1).view(ints).to(torch.int64).sum(1)
    return ((total + 2**31) % 2**32 - 2**31).to(torch.int32)


# ---------------------------------------------------------------- block top-k
def block_topk_ref(x: torch.Tensor, k: int, iters: int = BISECT_ITERS) -> torch.Tensor:
    """Per-row top-k masking via threshold bisection; x: [nb, block] f32.

    Returns x masked to (ties aside) its k largest-|.| entries per row: every
    entry with |x| >= the bisection threshold is kept, so a row with ties
    may keep more than k.  A masked entry is ``x * 0.0`` (``-0.0`` for a
    negative one), as in the reference.
    """
    assert x.ndim == 2
    mag = x.abs()
    hi = mag.amax(dim=1, keepdim=True)
    lo = torch.zeros_like(hi)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        cnt = (mag >= mid).sum(dim=1, keepdim=True)
        too_many = cnt > k
        lo = torch.where(too_many, mid, lo)
        hi = torch.where(too_many, hi, mid)
    mask = mag >= hi
    return x * mask.to(x.dtype)
