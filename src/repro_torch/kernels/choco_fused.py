"""The fused CHOCO gossip round: the ``fused_encode`` / ``fused_mix`` CUDA
kernels' wrappers and plain versions, and ``fused_round_leaf``.

Replaces ``repro/kernels/choco_fused.py`` (``fused_encode_pallas``,
``fused_mix_pallas``, ``fused_round_leaf``):

* ``fused_encode`` -- the residual ``theta_new - hat`` in the leaf dtype,
  stochastic quantization with per-node scales, bit-packing, and
  ``hat <- hat + Q(resid)``, in one pass; optionally (``with_digest``, the
  faulted round's encode, :func:`fused_encode_leaf`) the per-node int32
  wraparound digest of ``hat_new`` (``core.faults.digest``);
* ``fused_mix`` -- decode every neighbour's packed payload and accumulate
  ``s + sum_k w_k deq(payload_k)`` in f32, never materialising a decoded
  neighbour tensor.

``fused_mix`` keeps the reference's signature (``[K, m, ...]`` rolled
payloads); the round itself calls the kernel on the one unrolled payload
with per-shift node offsets (``fused_mix_shifted``), so no rolled copies are
built.  The averaging step, the residual norms, and the scales stay PyTorch
ops, as the reference leaves them to XLA.

CPU tensors take the plain versions; CUDA tensors launch the kernels (built
from ``csrc/choco_fused.cu``) or raise.
"""
from __future__ import annotations

import contextlib
import ctypes
from typing import Sequence

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import (
    LANES,
    digest_ref,
    encode_scale,
    f32_full,
    fused_encode_ref,
    fused_mix_ref,
    tau_for,
)

# max circulant shifts decoded per fused_mix launch (a mesh of m nodes has m
# shifts; they are accumulated in batches, the f32 s grid carried across)
SHIFT_BATCH = 8

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

encode_launches = _build.LaunchCounter("fused_encode")
# the digest variant counts apart: it runs on the faulted round only
encode_digest_launches = _build.LaunchCounter("fused_encode_digest")
mix_launches = _build.LaunchCounter("fused_mix")

_ENC_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                                          ctypes.c_int, ctypes.c_void_p])
_MIX_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.POINTER(ctypes.c_int)]
                 + [ctypes.c_int] * 4 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])


def _check_bits(bits: int, rows: int, what: str) -> None:
    if bits not in (1, 2, 4, 8):
        raise ValueError(f"{what}: bits must be one of (1, 2, 4, 8), got {bits}")
    if rows % (8 * (8 // bits)):
        raise ValueError(f"{what}: rows {rows} not a multiple of {8 * (8 // bits)}")


# ------------------------------------------------------------- fused encode
def fused_encode_plain(theta_new, hat, xi, scales, bits: int, with_digest: bool = False):
    """Plain version of :func:`fused_encode`."""
    lvl, sign, hat_new = fused_encode_ref(theta_new, hat, xi, scales, bits)
    if with_digest:
        return lvl, sign, hat_new, digest_ref(hat_new)
    return lvl, sign, hat_new


def fused_encode(theta_new, hat, xi, scales, bits: int, with_digest: bool = False):
    """theta_new/hat: [m, R, 128] (f32 or bf16), xi: [m, R, 128] f32, scales:
    [m, 2] f32 -- per-node (encode scale, dequant scale).

    Returns (packed_levels [m, R/pack, 128] u8, packed_signs [m, R/8, 128] u8,
    hat_new [m, R, 128] in hat.dtype), plus the per-node int32 digest [m] of
    ``hat_new`` when ``with_digest``.
    """
    if theta_new.device.type == "cpu":
        return fused_encode_plain(theta_new, hat, xi, scales, bits, with_digest)
    _build.check_cuda({"theta_new": theta_new, "hat": hat, "xi": xi, "scales": scales},
                      "fused_encode")
    m, rows, lanes = theta_new.shape
    _check_bits(bits, rows, "fused_encode")
    if (lanes != LANES or hat.shape != theta_new.shape or xi.shape != theta_new.shape
            or tuple(scales.shape) != (m, 2)):
        raise ValueError(f"fused_encode shapes: theta_new {tuple(theta_new.shape)}, hat "
                         f"{tuple(hat.shape)}, xi {tuple(xi.shape)}, scales {tuple(scales.shape)}")
    if (theta_new.dtype not in _DTYPES or hat.dtype != theta_new.dtype
            or xi.dtype != torch.float32 or scales.dtype != torch.float32):
        raise TypeError(f"fused_encode takes f32/bf16 theta_new and hat of one dtype, f32 xi "
                        f"and scales; got {theta_new.dtype}/{hat.dtype}/{xi.dtype}/{scales.dtype}")
    tn, hat, xi, scales = (t.contiguous() for t in (theta_new, hat, xi, scales))
    dev = tn.device
    lvl = torch.empty(m, rows * bits // 8, LANES, dtype=torch.uint8, device=dev)
    sign = torch.empty(m, rows // 8, LANES, dtype=torch.uint8, device=dev)
    hat_new = torch.empty_like(hat)
    dig = torch.zeros(m, dtype=torch.int32, device=dev) if with_digest else None
    fn = _build.function("choco_fused", "repro_fused_encode", _ENC_ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(tn.data_ptr(), hat.data_ptr(), xi.data_ptr(), scales.data_ptr(),
                 lvl.data_ptr(), sign.data_ptr(), hat_new.data_ptr(),
                 dig.data_ptr() if with_digest else None, _DTYPES[tn.dtype], m, rows, bits,
                 _build.stream_ptr(tn))
    _build.raise_on_error(err, "fused_encode")
    (encode_digest_launches if with_digest else encode_launches).add()
    return (lvl, sign, hat_new, dig) if with_digest else (lvl, sign, hat_new)


# --------------------------------------------------------------- fused mix
def _launch_mix(lvl, sign, s, wscale, shifts, kstride, bits, out) -> torch.Tensor:
    m, rows, _ = s.shape
    c_shifts = (ctypes.c_int * len(shifts))(*[int(x) for x in shifts])
    fn = _build.function("choco_fused", "repro_fused_mix", _MIX_ARGTYPES)
    with torch.cuda.device(s.device):
        err = fn(lvl.data_ptr(), sign.data_ptr(), s.data_ptr(), wscale.data_ptr(),
                 out.data_ptr(), c_shifts, len(shifts), kstride, _DTYPES[s.dtype], m, rows,
                 bits, _build.stream_ptr(s))
    _build.raise_on_error(err, "fused_mix")
    mix_launches.add()
    return out


def _check_mix(lvl, sign, s, wscale, nshifts, slabs, bits):
    _build.check_cuda({"levels": lvl, "signs": sign, "s": s, "wscale": wscale}, "fused_mix")
    m, rows, lanes = s.shape
    _check_bits(bits, rows, "fused_mix")
    if not 1 <= nshifts <= SHIFT_BATCH:
        raise ValueError(f"fused_mix takes 1..{SHIFT_BATCH} shifts per launch, got {nshifts}")
    want_l, want_s = (slabs, rows * bits // 8, LANES), (slabs, rows // 8, LANES)
    if (lanes != LANES or tuple(lvl.reshape(-1, *lvl.shape[-2:]).shape) != want_l
            or tuple(sign.reshape(-1, *sign.shape[-2:]).shape) != want_s
            or tuple(wscale.shape) != (nshifts, m)):
        raise ValueError(f"fused_mix shapes: levels {tuple(lvl.shape)}, signs "
                         f"{tuple(sign.shape)}, s {tuple(s.shape)}, wscale {tuple(wscale.shape)}")
    if (lvl.dtype != torch.uint8 or sign.dtype != torch.uint8 or s.dtype not in _DTYPES
            or wscale.dtype != torch.float32):
        raise TypeError(f"fused_mix takes u8 payloads, f32/bf16 s and f32 wscale; got "
                        f"{lvl.dtype}/{sign.dtype}/{s.dtype}/{wscale.dtype}")


def fused_mix_plain(rolled_lvl, rolled_sign, s, wscale, bits: int):
    """Plain version of :func:`fused_mix`."""
    return fused_mix_ref(rolled_lvl, rolled_sign, s, wscale, bits)


def fused_mix(rolled_lvl, rolled_sign, s, wscale, bits: int):
    """rolled_lvl: [K, m, R/pack, 128] u8, rolled_sign: [K, m, R/8, 128] u8,
    s: [m, R, 128] (f32 or bf16), wscale: [K, m] f32 with
    wscale[k, i] = w_k * deq_scale[(i - shift_k) mod m].

    Returns s_new [m, R, 128]: s + sum_k w_k * deq(rolled payload_k).
    """
    if s.device.type == "cpu":
        return fused_mix_plain(rolled_lvl, rolled_sign, s, wscale, bits)
    K, m = rolled_lvl.shape[:2]
    _check_mix(rolled_lvl, rolled_sign, s, wscale, K, K * m, bits)
    lvl, sign, s_c, ws = (t.contiguous() for t in (rolled_lvl, rolled_sign, s, wscale))
    return _launch_mix(lvl, sign, s_c, ws, [0] * K, m, bits, torch.empty_like(s_c))


def fused_mix_shifted(lvl, sign, s, wscale, shifts: Sequence[int], bits: int):
    """``fused_mix`` over the one unrolled payload: lvl [m, R/pack, 128],
    sign [m, R/8, 128]; shift k of node i reads node (i - shifts[k]) mod m.

    Updates the contiguous ``s`` [m, R, 128] in place and returns it.
    """
    if s.device.type == "cpu":
        rolled_lvl = torch.stack([torch.roll(lvl, sh, 0) for sh in shifts])
        rolled_sign = torch.stack([torch.roll(sign, sh, 0) for sh in shifts])
        s.copy_(fused_mix_plain(rolled_lvl, rolled_sign, s, wscale, bits))
        return s
    _check_mix(lvl, sign, s, wscale, len(shifts), s.shape[0], bits)
    if not s.is_contiguous():
        raise ValueError("fused_mix_shifted updates s in place: pass a contiguous s")
    return _launch_mix(lvl.contiguous(), sign.contiguous(), s, wscale.contiguous(), shifts, 0,
                       bits, s)


# ------------------------------------------------------------- leaf round
def dtype_scalar(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype`` (as ``jnp.asarray(value, dtype)``), as a
    Python float: a tensor times it rounds once, as the reference's product
    in the leaf dtype does, with no host-to-device copy."""
    return float(torch.tensor(value, dtype=dtype))


# the node count a block's norms are reduced over (see norms_over)
_NORM_ROWS: list = [None]


@contextlib.contextmanager
def norms_over(rows: int | None):
    """Inside the block, :func:`node_norms` of a block of nodes reduces as a
    call over ``rows`` nodes does: the block is padded with zero rows to
    ``rows``.  A CUDA reduction's order depends on how many rows its call
    holds, so a rank that holds some of the nodes takes its norms, and
    quantizes, bit for bit as the one-process round over all of them."""
    _NORM_ROWS.append(rows)
    try:
        yield
    finally:
        _NORM_ROWS.pop()


def node_norms(resid: torch.Tensor) -> torch.Tensor:
    """Per-node L2 norms of an f32 [m, ...] tensor -> [m] f32.  Both gossip
    paths (packed and fused) take their norms here, so their payloads agree
    bit for bit."""
    flat = resid.reshape(resid.shape[0], -1)
    rows = _NORM_ROWS[-1]
    if rows is not None and rows > flat.shape[0]:
        whole = flat.new_zeros((rows, flat.shape[1]))
        whole[:flat.shape[0]] = flat
        return torch.linalg.vector_norm(whole, dim=1)[:flat.shape[0]]
    return torch.linalg.vector_norm(flat, dim=1)


def _encode_pass(theta_new, hat, xi, bits: int, with_digest: bool):
    """The fused encode of a stacked chunk [m, ...]: residual norms and
    scales as PyTorch ops (the packed path's ``node_norms``, so the payloads
    agree bit for bit), then one ``fused_encode`` over the padded grid.
    Returns (encode outputs, norms, dequant scales, grid3, unpad)."""
    m = theta_new.shape[0]
    inner_shape = tuple(theta_new.shape[1:])
    d = theta_new[0].numel()
    flat_tn = theta_new.reshape(m, -1)
    flat_hat = hat.reshape(m, -1)
    norms = node_norms((flat_tn - flat_hat).float())

    pack = 8 // bits
    unit = 8 * pack * LANES
    pad = (-d) % unit
    rows = (d + pad) // LANES

    def grid3(x):
        if pad:
            x = torch.nn.functional.pad(x, (0, pad))
        return x.reshape(m, rows, LANES)

    def unpad(x):
        return x.reshape(m, -1)[:, :d].reshape((m,) + inner_shape)

    if tuple(xi.shape) != (m, rows, LANES):
        raise ValueError(f"noise for a [{m}, {d}] leaf at {bits} bits must be "
                         f"{(m, rows, LANES)}, got {tuple(xi.shape)}")
    scale_enc = encode_scale(norms, bits)
    scale_deq = norms / f32_full(norms, (1 << bits) * tau_for(d, bits))
    scales = torch.stack([scale_enc, scale_deq], dim=1)
    enc_out = fused_encode(grid3(flat_tn), grid3(flat_hat), xi, scales, bits,
                           with_digest=with_digest)
    return enc_out, norms, scale_deq, grid3, unpad


def fused_encode_leaf(theta_new, hat, xi, bits: int):
    """The faulted round's encode of a stacked chunk [m, ...] on the digest
    variant: one pass gives the packed payload, ``hat_new`` and the
    sender's per-node digest of it.

    Returns (payload {"levels", "signs", "norm"} -- the packed quantizer's,
    bit for bit -- hat_new shaped like ``hat``, digest [m] int32 equal to
    ``core.faults.digest(hat_new)``: the zero padding quantizes to exact
    zeros, so the padded grid digests as the unpadded chunk)."""
    (lvl, sign, hat_new_g, dig), norms, _, _, unpad = _encode_pass(theta_new, hat, xi, bits,
                                                                   True)
    return {"levels": lvl, "signs": sign, "norm": norms}, unpad(hat_new_g), dig


def fused_round_leaf(leaf, hat, s, xi, shifts: Sequence[tuple[int, float]], gamma, bits: int,
                     *, with_digest: bool = False):
    """One CHOCO round for a stacked leaf [m, ...] on the fused path.

    ``xi`` is the [m, rows, 128] f32 uniform noise of the padded grid (the
    same draw the packed path quantizes with), so the payload equals the
    packed path's bit for bit; ``s_new`` agrees to f32 reassociation (the
    kernel multiplies each level by ``w_k * scale`` where the packed path
    takes ``w_k * (level * scale)``).

    Returns (theta_new, hat_new, s_new), all shaped like ``leaf``; with
    ``with_digest`` a fourth element, the per-node int32 digest of
    ``hat_new``.
    """
    m = leaf.shape[0]
    dtype = leaf.dtype
    # averaging step: a PyTorch op, in the leaf dtype
    theta_new = leaf + (s - hat) * dtype_scalar(gamma, dtype)
    enc_out, _, scale_deq, grid3, unpad = _encode_pass(theta_new, hat, xi, bits, with_digest)
    lvl, sign, hat_new_g = enc_out[:3]

    # the f32 s grid is carried across shift batches and cast once at the end
    s_new_g = grid3(s.reshape(m, -1).to(torch.float32, copy=True)).contiguous()
    shifts = tuple(shifts)
    for lo in range(0, len(shifts), SHIFT_BATCH):
        batch = shifts[lo:lo + SHIFT_BATCH]
        wscale = torch.stack([w * torch.roll(scale_deq, sh, 0) for sh, w in batch])
        fused_mix_shifted(lvl, sign, s_new_g, wscale, [sh for sh, _ in batch], bits)

    out = (theta_new, unpad(hat_new_g), unpad(s_new_g).to(dtype))
    return out + (enc_out[3],) if with_digest else out
