"""The MoE layer's dispatch: the ``moe_dispatch`` / ``moe_dispatch_backward``
CUDA kernels' wrappers and plain versions, and :class:`MoEDispatch`, the
autograd op ``models/moe.py::apply_moe`` runs.

Forward: each capacity slot's token row of ``x [G, T, d]`` into the
expert-major ``[E, G*C, d]`` buffer the expert products take (row
``e * G*C + g*C + c`` holds ``x[g, src_tok[g, e, c]]``), zeros for an empty
slot (``src_tok == T``).  Backward: each token's gradient row is the sum of
its kept slots' rows, taken in ascending expert order in f32 and rounded
once to the dtype: the order in which CUDA's sort-based ``index_put_``
backward of a plain gather sums them (its radix sort is stable; in bf16 it
rounds after each add), without its sort, its serial walk over the empty
slots' pad row, or the pad row.
The reference gathers with XLA (``repro/models/moe.py``); no Pallas kernel
is replaced.

CPU tensors take the plain versions; CUDA tensors launch the kernels (built
from ``csrc/moe_dispatch.cu``) or raise.  The kernels take bf16 and f32 rows
whose width is a multiple of 8, and tokens of at most 32 slots.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

MAX_K = 32  # a token's slots: one per lane of the backward's warp
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

dispatch_launches = _build.LaunchCounter("moe_dispatch")
backward_launches = _build.LaunchCounter("moe_dispatch_backward")

_FWD_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_longlong, ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def moe_dispatch_plain(x: torch.Tensor, src_tok: torch.Tensor) -> torch.Tensor:
    """Plain version of the forward: x [G, T, d], src_tok [G, E, C] -> [E, G*C, d]."""
    G, _, d = x.shape
    E, C = src_tok.shape[1:]
    x_pad = torch.cat([x, x.new_zeros(G, 1, d)], 1)
    eb = x_pad[torch.arange(G, device=x.device)[:, None, None], src_tok]  # [G, E, C, d]
    return eb.transpose(0, 1).reshape(E, G * C, d)


def moe_dispatch_backward_plain(grad: torch.Tensor, slot: torch.Tensor,
                                kept: torch.Tensor) -> torch.Tensor:
    """Plain version of the backward: grad [E, G*C, d], slot / kept [G, T, K]
    (each token's slots in ascending expert order) -> [G, T, d], the kept
    slots' rows summed in that order in f32 and rounded once."""
    E, GC, d = grad.shape
    G, T, K = slot.shape
    per_group = grad.reshape(E, G, GC // G, d).transpose(0, 1).reshape(G, -1, d)
    acc_dtype = torch.promote_types(grad.dtype, torch.float32)
    acc = torch.zeros(G, T, d, dtype=acc_dtype, device=grad.device)
    for k in range(K):
        w = torch.gather(per_group, 1, slot[..., k, None].expand(G, T, d)).to(acc_dtype)
        acc = torch.where(kept[..., k, None], acc + w, acc)
    return acc.to(grad.dtype)


def _check(t: torch.Tensor, what: str) -> None:
    if t.dtype not in _DTYPES:
        raise TypeError(f"{what} takes bf16 or f32 rows, got {t.dtype}")
    if t.shape[-1] % 8:
        raise ValueError(f"{what}: row width {t.shape[-1]} is not a multiple of 8")
    if t.data_ptr() % 16:
        raise ValueError(f"{what}: rows must start 16-byte aligned")


def _index(t: torch.Tensor, what: str) -> torch.Tensor:
    if t.dtype != torch.long:
        raise TypeError(f"{what} must be int64, got {t.dtype}")
    return t.contiguous()


def dispatch(x: torch.Tensor, src_tok: torch.Tensor) -> torch.Tensor:
    """x [G, T, d], src_tok [G, E, C] (``T`` for an empty slot) -> [E, G*C, d]."""
    if x.device.type == "cpu":
        return moe_dispatch_plain(x, src_tok)
    _build.check_cuda({"x": x, "src_tok": src_tok}, "moe_dispatch")
    G, T, d = x.shape
    if src_tok.ndim != 3 or src_tok.shape[0] != G:
        raise ValueError(f"moe_dispatch: src_tok {tuple(src_tok.shape)} for x {tuple(x.shape)}")
    E, C = src_tok.shape[1:]
    x, src_tok = x.contiguous(), _index(src_tok, "moe_dispatch src_tok")
    _check(x, "moe_dispatch")
    out = torch.empty(E, G * C, d, dtype=x.dtype, device=x.device)
    fn = _build.function("moe_dispatch", "repro_moe_dispatch", _FWD_ARGTYPES)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), src_tok.data_ptr(), out.data_ptr(), G, T, E, C,
                 d * x.element_size(), _build.stream_ptr(x))
    _build.raise_on_error(err, "moe_dispatch")
    dispatch_launches.add()
    return out


def dispatch_backward(grad: torch.Tensor, slot: torch.Tensor, kept: torch.Tensor) -> torch.Tensor:
    """grad [E, G*C, d], slot / kept [G, T, K] -> the gradient of x, [G, T, d]."""
    if grad.device.type == "cpu":
        return moe_dispatch_backward_plain(grad, slot, kept)
    _build.check_cuda({"grad": grad, "slot": slot, "kept": kept}, "moe_dispatch_backward")
    E, GC, d = grad.shape
    G, T, K = slot.shape
    if GC % G or tuple(kept.shape) != (G, T, K) or kept.dtype != torch.bool:
        raise ValueError(f"moe_dispatch_backward: grad {tuple(grad.shape)}, slot "
                         f"{tuple(slot.shape)}, kept {tuple(kept.shape)} {kept.dtype}")
    if K > MAX_K:
        raise ValueError(f"moe_dispatch_backward: {K} slots a token, the kernel takes {MAX_K}")
    grad, kept = grad.contiguous(), kept.contiguous()
    slot = _index(slot, "moe_dispatch_backward slot")
    _check(grad, "moe_dispatch_backward")
    gx = torch.empty(G, T, d, dtype=grad.dtype, device=grad.device)
    fn = _build.function("moe_dispatch", "repro_moe_dispatch_backward", _BWD_ARGTYPES)
    with torch.cuda.device(grad.device):
        err = fn(grad.data_ptr(), slot.data_ptr(), kept.data_ptr(), gx.data_ptr(), G, T,
                 GC // G, K, d, _DTYPES[grad.dtype], _build.stream_ptr(grad))
    _build.raise_on_error(err, "moe_dispatch_backward")
    backward_launches.add()
    return gx


class MoEDispatch(torch.autograd.Function):
    """``dispatch`` with ``dispatch_backward`` as its gradient.  ``slot`` /
    ``kept`` [G, T, K]: each token's flat slots ``e * C + c`` and whether
    each is within capacity, in ascending expert order (``moe.route``'s
    ``slot_by_expert`` / ``kept_by_expert``)."""

    @staticmethod
    def forward(ctx, x, src_tok, slot, kept):
        ctx.save_for_backward(slot, kept)
        return dispatch(x, src_tok)

    @staticmethod
    def backward(ctx, grad):
        slot, kept = ctx.saved_tensors
        return dispatch_backward(grad, slot, kept), None, None, None


def moe_dispatch(x, src_tok, slot, kept):
    """x [G, T, d] -> [E, G*C, d] under autograd (see :class:`MoEDispatch`)."""
    return MoEDispatch.apply(x, src_tok, slot, kept)
