"""Minimal optimizers + LR schedules, PyTorch port of ``repro.optim``.

The reference's optimizers return an update tree that the trainer adds to
the parameters; at full width that tree (f32, every node) does not fit next
to the trainer's state, so here ``apply_`` updates the parameters in place,
one leaf and one node at a time, with the same arithmetic:
``p <- (f32(p) + (-lr_t * (f32(g) * scale_i))).to(p.dtype)``.

Schedules return the learning rate as a Python float holding the f32 value
the reference computes (f32 arithmetic on the round index).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.device import f32_full

Schedule = Callable[[int], float]


def make_schedule(kind: str, base: float, *, decay: float = 0.995, total_steps: int = 1000,
                  warmup: int = 0) -> Schedule:
    if kind not in ("const", "exp", "cosine"):
        raise ValueError(f"unknown schedule {kind!r}")
    f32 = np.float32

    def sched(step: int) -> float:
        t = f32(step)
        if kind == "const":
            lr = f32(base)
        elif kind == "exp":
            lr = f32(base) * np.power(f32(decay), t)
        else:
            frac = np.clip(t / f32(max(total_steps, 1)), f32(0.0), f32(1.0))
            lr = f32(base) * f32(0.5) * (f32(1.0) + np.cos(f32(np.pi) * frac))
        if warmup > 0:
            lr = lr * np.clip(t / f32(warmup), f32(0.0), f32(1.0))
        return float(f32(lr))

    return sched


@dataclasses.dataclass(frozen=True)
class OptState:
    step: int
    mu: Any  # per-leaf first moment / momentum ([m, ...] f32), or ()
    nu: Any  # per-leaf second moment (adam only), or ()


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """``init(leaves) -> OptState``; ``apply_(params, grads, state, scale) ->
    OptState`` updates ``params`` (stacked [m, ...] leaves) in place from
    ``grads[leaf][node]`` weighted per node by ``scale`` ([m] f32)."""

    init: Callable[[list], OptState]
    apply_: Callable[[list, list, OptState, torch.Tensor], OptState]


def _zeros_f32(params):
    return [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in params]


def _add_(p: torch.Tensor, u: torch.Tensor) -> None:
    p.copy_((p.float() + u).to(p.dtype))


# SGD updates a node's leaf over flat blocks of this many elements: the f32
# temporaries of an embedding-sized leaf stay small (the update is
# elementwise, so the blocks do not change a bit of it)
_SGD_BLOCK = 1 << 24


def _flat_blocks(*xs):
    """Matching flat blocks of same-sized contiguous tensors."""
    flats = [x.reshape(-1) for x in xs]
    for lo in range(0, flats[0].numel(), _SGD_BLOCK):
        yield [f[lo:lo + _SGD_BLOCK] for f in flats]


def sgd(lr: float | Schedule, momentum: float = 0.0, nesterov: bool = False) -> Optimizer:
    sched = lr if callable(lr) else (lambda _: float(np.float32(lr)))

    def init(params):
        return OptState(0, _zeros_f32(params) if momentum != 0 else (), ())

    def apply_(params, grads, state, scale):
        neg_lr = -sched(state.step)
        for j, p in enumerate(params):
            for i in range(p.shape[0]):
                own = [p[i], grads[j][i]] + ([state.mu[j][i]] if momentum != 0 else [])
                for part in _flat_blocks(*own):
                    g = part[1].float() * scale[i]
                    if momentum != 0:
                        mu = part[2]
                        mu.copy_(momentum * mu + g)
                        g = momentum * mu + g if nesterov else mu
                    _add_(part[0], g * neg_lr)
        return OptState(state.step + 1, state.mu, ())

    return Optimizer(init, apply_)


def adam(lr: float | Schedule, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
         weight_decay: float = 0.0) -> Optimizer:
    sched = lr if callable(lr) else (lambda _: float(np.float32(lr)))

    def init(params):
        return OptState(0, _zeros_f32(params), _zeros_f32(params))

    def apply_(params, grads, state, scale):
        t = np.float32(state.step + 1)
        neg_lr = -sched(state.step)
        bc1 = float(np.float32(1.0) - np.power(np.float32(b1), t))
        bc2 = float(np.float32(1.0) - np.power(np.float32(b2), t))
        for j, p in enumerate(params):
            for i in range(p.shape[0]):
                g = grads[j][i].float() * scale[i]
                m, v = state.mu[j][i], state.nu[j][i]
                m.copy_(b1 * m + (1 - b1) * g)
                v.copy_(b2 * v + (1 - b2) * g * g)
                step_ = (m / f32_full(m, bc1)) / (torch.sqrt(v / f32_full(v, bc2)) + eps)
                if weight_decay:
                    step_ = step_ + weight_decay * p[i].float()
                _add_(p[i], step_ * neg_lr)
        return OptState(state.step + 1, state.mu, state.nu)

    return Optimizer(init, apply_)
