"""Distributionally robust optimization primitives (paper §3, eq. (3)),
PyTorch port of ``repro.core.dro``.

    min_theta max_{lambda in simplex}  (1/m) sum_i [ lambda_i f_i(theta) + alpha r(lambda) ]

with r a strongly-concave regularizer: Euclidean projection onto the
simplex (the ascent step of Algorithm 1), the chi^2 and KL regularizers
with their gradients, the dual gradient, and DR-DSGD's closed-form KL
maximizer.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

__all__ = ["project_simplex", "chi2_regularizer", "kl_regularizer", "make_regularizer",
           "kl_closed_form_weights", "dual_gradient", "Regularizer"]


def project_simplex(v: torch.Tensor) -> torch.Tensor:
    """Euclidean projection of v onto the probability simplex (last axis).

    Sort-based algorithm (Held et al. 1974), O(m log m).
    """
    m = v.shape[-1]
    u = torch.sort(v, dim=-1, descending=True).values
    css = torch.cumsum(u, dim=-1) - 1.0
    ind = torch.arange(1, m + 1, dtype=v.dtype, device=v.device)
    cond = u - css / ind > 0
    # rho = largest index where cond holds (guaranteed >= 1)
    rho = torch.amax(torch.where(cond, ind, torch.zeros_like(ind)), dim=-1, keepdim=True)
    theta = torch.gather(css, -1, rho.long() - 1) / rho
    return torch.clamp(v - theta, min=0.0)


@dataclasses.dataclass(frozen=True)
class Regularizer:
    """r(lambda): strongly-concave regularizer, with node-prior pi = n_i/n,
    and its gradient in lambda (closed form)."""

    name: str
    fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    grad_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]

    def __call__(self, lam, prior):
        return self.fn(lam, prior)

    def grad(self, lam, prior):
        return self.grad_fn(lam, prior)


def _chi2(lam, prior):
    """-chi^2(lambda || prior) = -sum_i (lambda_i - pi_i)^2 / pi_i (concave)."""
    return -torch.sum((lam - prior) ** 2 / prior, dim=-1)


def _chi2_grad(lam, prior):
    return (-1.0 / prior) * (2.0 * (lam - prior))


def _kl(lam, prior):
    """-D_KL(lambda || prior) (concave); 0 log 0 := 0."""
    safe = torch.where(lam > 0, lam, torch.ones_like(lam))
    return -torch.sum(torch.where(lam > 0, lam * torch.log(safe / prior), torch.zeros_like(lam)),
                      dim=-1)


def _kl_grad(lam, prior):
    safe = torch.where(lam > 0, lam, torch.ones_like(lam))
    return torch.where(lam > 0, -(torch.log(safe / prior) + 1.0), torch.zeros_like(lam))


chi2_regularizer = Regularizer("chi2", _chi2, _chi2_grad)
kl_regularizer = Regularizer("kl", _kl, _kl_grad)

_REGS = {"chi2": chi2_regularizer, "kl": kl_regularizer}


def make_regularizer(name: str) -> Regularizer:
    if name not in _REGS:
        raise ValueError(f"unknown regularizer {name!r}; choose from {sorted(_REGS)}")
    return _REGS[name]


def kl_closed_form_weights(losses: torch.Tensor, prior: torch.Tensor,
                           alpha: float) -> torch.Tensor:
    """Exact inner maximizer for the KL regularizer (DR-DSGD):
    lambda*_i proportional to pi_i exp(f_i / alpha)."""
    logits = torch.log(prior) + losses / alpha
    return torch.softmax(logits, dim=-1)


def dual_gradient(local_loss, node_index, lam, prior, alpha: float,
                  regularizer: Regularizer) -> torch.Tensor:
    """grad_lambda g_i(theta, lambda) = f_i(theta) e_i + alpha grad r(lambda).

    Node i observes only its own loss; the regularizer gradient is global in
    lambda (which every node stores locally, size m).  Broadcasts over a
    leading node axis: ``local_loss`` [m], ``node_index`` [m], ``lam`` [m, m].
    """
    m = lam.shape[-1]
    idx = torch.as_tensor(node_index, device=lam.device)
    e_i = torch.nn.functional.one_hot(idx, m).to(lam.dtype)
    loss = torch.as_tensor(local_loss, dtype=lam.dtype, device=lam.device)
    return loss[..., None] * e_i + alpha * regularizer.grad(lam, prior)
