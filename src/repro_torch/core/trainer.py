"""Composable decentralized-DRO trainer (paper Algorithm 1 as one loop):
the main-path subset of ``repro.core.trainer`` in PyTorch.

A round is local update, dual update, communication:

* :class:`LocalUpdate` -- the stochastic oracle (one gradient per node per
  round) and the optimizer step, with the dual's per-node gradient weights;
* :class:`ProjectedAscent` (AD-GDA) or :class:`FrozenPrior` (CHOCO-SGD) --
  how the mixture weights lambda evolve;
* :class:`ChocoConsensus` -- the CHOCO compressed round over a static
  topology (``packed`` / ``fused`` dispatch of ``core/gossip.py``).

All decentralized state is *stacked* (every leaf [m, ...]) in the
reference's parameter tree, so the gossip's chunk plan, per-chunk norms,
gamma and bit counts are the reference's.  The oracle runs node by node
(``torch.autograd`` on views of each node's parameters), holds every node's
gradient (the dual weights may read all losses), then the optimizer updates
the parameters in place leaf by leaf; the consensus round updates theta,
theta_hat and s in place chunk by chunk.  So :meth:`DecentralizedTrainer.step`
consumes its input state, as the reference's donating jitted step does.

The trainer owns a ``torch.Generator`` on its device (in the state) for the
quantization noise; ``step(..., noise=...)`` injects it instead (see
``core/gossip.py``).  Microbatching, local steps, the KL and sampled duals,
gradient tracking, exact and federated consensus, schedules and faults are
not yet ported (see ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.core import dro
from repro_torch.core.compression import Compressor
from repro_torch.core.gossip import (
    BLOCK_SCAN_ELEMS,
    CHOCOState,
    _not_ported,
    _scan_plan,
    check_fused,
    choco_init,
    choco_round,
    mix_stacked,
    payload_bits,
)
from repro_torch.core.topology import Topology
from repro_torch.device import resolve_device
from repro_torch.kernels.ref import f32_full
from repro_torch.optim import Optimizer, OptState, Schedule
from repro_torch.tree import leaves as tree_leaves
from repro_torch.tree import tree_map, unflatten

__all__ = [
    "LossFn",
    "TrainerState",
    "LocalUpdate",
    "DualUpdate",
    "ProjectedAscent",
    "FrozenPrior",
    "ChocoConsensus",
    "DecentralizedTrainer",
]

LossFn = Callable[[Any, Any, Any], torch.Tensor]


@dataclasses.dataclass
class TrainerState:
    step: int  # round counter
    theta: Any  # stacked tree [m, ...]
    lam: torch.Tensor  # dual variable: [m, m] per-node copies
    opt: OptState  # optimizer moments + its own step counter
    consensus: Any  # CHOCOState
    theta_avg: Any  # running mean over time of the network mean (theta_o), or ()
    generator: torch.Generator  # the gossip's quantization noise


# ============================================================== local update
@dataclasses.dataclass(frozen=True)
class LocalUpdate:
    """Stochastic oracle + optimizer step on the stacked model: one gradient
    per node per round (microbatching and local steps are not yet ported)."""

    optimizer: Optimizer
    schedule: Schedule

    def init(self, theta_stacked) -> OptState:
        return self.optimizer.init(tree_leaves(theta_stacked))

    def lr(self, opt_state: OptState) -> float:
        return self.schedule(opt_state.step)

    def step(self, loss_fn: LossFn, theta, opt_state: OptState, batch,
             weights_fn: Callable[[torch.Tensor], torch.Tensor]):
        """Run the oracle, then the optimizer on ``theta`` in place.

        Returns (opt_state, losses [m] f32).  ``weights_fn(losses) -> [m]``
        supplies the dual gradient weighting.
        """
        flat = tree_leaves(theta)
        m = flat[0].shape[0]
        grads = [[None] * m for _ in flat]
        losses = []
        with record_function("forward_backward"):
            for i in range(m):
                params_i = [leaf[i].detach().requires_grad_(True) for leaf in flat]
                batch_i = tree_map(lambda b: b[i], batch)
                loss = loss_fn(unflatten(theta, params_i), batch_i, None)
                for j, g in enumerate(torch.autograd.grad(loss, params_i)):
                    grads[j][i] = g
                losses.append(loss.detach().float())
            losses = torch.stack(losses)
        with record_function("optimizer"):
            scale = weights_fn(losses)
            opt_state = self.optimizer.apply_(flat, grads, opt_state, scale)
        return opt_state, losses


# ================================================================ dual update
class DualUpdate:
    """How the mixture weights lambda evolve across rounds."""

    def init(self, m: int, device) -> torch.Tensor:
        raise NotImplementedError

    def grad_weights(self, lam: torch.Tensor, losses: torch.Tensor) -> torch.Tensor:
        return torch.ones_like(losses)

    def update(self, lam: torch.Tensor, losses: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def bits_per_round(self) -> float:
        return 0.0


def _prior_on(prior, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(prior, np.float32), device=device)


@dataclasses.dataclass(frozen=True)
class ProjectedAscent(DualUpdate):
    """AD-GDA's dual: projected gradient ascent + uncompressed lambda gossip.

        lam_i <- sum_j w_ij P_simplex(lam_j + eta_lam (f_j e_j + alpha grad r))

    Every node keeps its own copy of lambda (state [m, m]).
    """

    prior: np.ndarray
    alpha: float
    eta_lambda: float
    regularizer: dro.Regularizer
    topology: Topology

    def init(self, m, device):
        return _prior_on(self.prior, device)[None].expand(m, m).clone()

    def grad_weights(self, lam, losses):
        return (torch.diagonal(lam) / _prior_on(self.prior, lam.device)).float()

    def update(self, lam, losses):
        m = lam.shape[0]
        prior = _prior_on(self.prior, lam.device)
        node_ids = torch.arange(m, device=lam.device)
        dual_grads = dro.dual_gradient(losses, node_ids, lam, prior, self.alpha,
                                       self.regularizer)
        lam_half = dro.project_simplex(lam + self.eta_lambda * dual_grads)
        return mix_stacked(lam_half, self.topology)

    def bits_per_round(self) -> float:
        return 32.0 * int(np.shape(self.prior)[0]) * self.topology.max_degree


@dataclasses.dataclass(frozen=True)
class FrozenPrior(DualUpdate):
    """Non-robust baseline (CHOCO-SGD): lambda frozen at the prior."""

    prior: np.ndarray

    def init(self, m, device):
        return _prior_on(self.prior, device)[None].expand(m, m).clone()

    def update(self, lam, losses):
        return lam


# ================================================================== consensus
class ChocoConsensus:
    """CHOCO-GOSSIP compressed round with the ``packed`` / ``fused``
    dispatch of ``gossip.choco_round``, on a static topology.  ``fused=True``
    with a compressor or topology the fused round cannot take raises (the
    reference silently falls back)."""

    def __init__(self, topology: Topology, compressor: Compressor,
                 gamma: float | str | None = None, *, packed: bool = True,
                 fused: bool = False):
        if not isinstance(topology, Topology):
            raise _not_ported("topology schedules")
        if fused:
            check_fused(topology, compressor)
        self.topology = topology
        self.compressor = compressor
        self.gamma_spec = gamma
        self.packed = packed
        self.fused = fused
        # provisional gamma until init()/mix() see the real leaf sizes
        self.gamma = self._resolve_gamma(4096)

    @staticmethod
    def _encode_dim(theta) -> int:
        """Largest per-node encode size the gossip layer will actually run on
        a *stacked* tree (mirrors ``gossip._scan_plan``'s chunking)."""
        best = 1
        for leaf in tree_leaves(theta):
            inner = int(np.prod(leaf.shape[1:])) if len(leaf.shape) > 1 else 1
            plan = _scan_plan(tuple(leaf.shape), inner, BLOCK_SCAN_ELEMS)
            best = max(best, inner if plan is None else inner // plan[1])
        return best

    def _resolve_gamma(self, d: int) -> float:
        """Consensus step size for the largest single encode of size d:
        ``"theory"`` -> Theorem 4.1, a number -> verbatim, None -> 0.5 delta(d)."""
        delta = getattr(self.compressor, "delta", 1.0)
        if hasattr(self.compressor, "delta_for"):
            delta = self.compressor.delta_for(max(int(d), 1))
        if self.gamma_spec == "theory":
            return self.topology.consensus_step_size(max(delta, 1e-3))
        if self.gamma_spec is not None:
            return float(self.gamma_spec)
        return 0.5 * max(delta, 1e-3)

    def init(self, theta_stacked) -> CHOCOState:
        self.gamma = self._resolve_gamma(self._encode_dim(theta_stacked))
        return choco_init(theta_stacked)

    def mix(self, theta_half, state, generator, *, noise=None):
        gamma = self._resolve_gamma(self._encode_dim(theta_half))
        return choco_round(theta_half, state, self.topology, gamma, self.compressor,
                           generator=generator, noise=noise, packed=self.packed,
                           fused=self.fused)

    def bits_per_round(self, theta_template, *, mode: str = "max") -> float:
        return payload_bits(self.compressor, theta_template, self.topology, mode=mode)


# ==================================================================== trainer
class DecentralizedTrainer:
    """oracle x optimizer x dual x consensus, one round per ``step``::

        trainer = DecentralizedTrainer(loss_fn, num_nodes=m, local=..., dual=...,
                                       consensus=..., device="cuda")
        state = trainer.init(params, seed)
        state, aux = trainer.step(state, batch)   # updates state in place

    ``batch`` leaves are stacked [m, per-node-batch, ...] on the trainer's
    device; ``loss_fn(params, batch, rng)`` is one node's loss (``rng`` is
    None: the losses here draw no randomness).
    """

    def __init__(self, loss_fn: LossFn, *, num_nodes: int, local: LocalUpdate,
                 dual: DualUpdate, consensus: ChocoConsensus, prior=None,
                 track_average: bool = True, config: Any = None, device="cuda"):
        self.device = resolve_device(device)
        self.loss_fn = loss_fn
        self.num_nodes = num_nodes
        self.local = local
        self.dual = dual
        self.consensus = consensus
        self.prior = (np.full((num_nodes,), 1.0 / num_nodes, np.float32) if prior is None
                      else np.asarray(prior, np.float32))
        self.track_average = track_average
        self.config = config

    @property
    def topology(self) -> Topology:
        return self.consensus.topology

    @property
    def compressor(self) -> Compressor:
        return self.consensus.compressor

    @property
    def gamma(self) -> float:
        return self.consensus.gamma

    # ------------------------------------------------------------------ init
    def init(self, params: Any, seed: int = 0) -> TrainerState:
        """Stack ``params`` (one model, any device) to every node on the
        trainer's device; the noise generator is seeded with ``seed``."""
        m = self.num_nodes
        theta = tree_map(
            lambda p: p.to(self.device)[None].expand((m,) + tuple(p.shape)).clone(), params)
        return TrainerState(
            step=0,
            theta=theta,
            lam=self.dual.init(m, self.device),
            opt=self.local.init(theta),
            consensus=self.consensus.init(theta),
            theta_avg=(tree_map(lambda p: p.to(self.device, torch.float32, copy=True), params)
                       if self.track_average else ()),
            generator=torch.Generator(device=self.device).manual_seed(seed),
        )

    # ------------------------------------------------------------------ step
    def step(self, state: TrainerState, batch: Any, *, noise=None) -> tuple[TrainerState, dict]:
        """One round; ``state``'s tensors are updated in place and returned in
        a new :class:`TrainerState` with the aux metrics (device tensors)."""
        eta = self.local.lr(state.opt)
        weights_fn = lambda losses: self.dual.grad_weights(state.lam, losses)
        opt_new, losses = self.local.step(self.loss_fn, state.theta, state.opt, batch,
                                          weights_fn)
        with record_function("dual"):
            lam_new = self.dual.update(state.lam, losses)
        with record_function("consensus"):
            theta_new, cons_new = self.consensus.mix(state.theta, state.consensus,
                                                     state.generator, noise=noise)

        theta_avg = state.theta_avg
        if self.track_average:
            def running(avg, th):
                tt = float(state.step)
                return (avg * tt + th.float().mean(0)) / f32_full(avg, tt + 1.0)

            theta_avg = tree_map(running, state.theta_avg, theta_new)

        with record_function("consensus_err"):
            err = _consensus_error(theta_new)
        aux = {
            "losses": losses,
            "worst_loss": losses.max(),
            "mean_loss": losses.mean(),
            "lambda_mean": lam_new.mean(0),
            "eta_theta": eta,
            "consensus_err": err,
            "bits_realized": self.bits_per_round(state),
        }
        new_state = TrainerState(step=state.step + 1, theta=theta_new, lam=lam_new, opt=opt_new,
                                 consensus=cons_new, theta_avg=theta_avg,
                                 generator=state.generator)
        return new_state, aux

    # ------------------------------------------------------------- utilities
    def network_mean(self, state: TrainerState):
        return tree_map(lambda x: x.float().mean(0), state.theta)

    def bits_per_round(self, state: TrainerState, *, mode: str = "max") -> float:
        """Bits transmitted per communication round by the busiest node
        (model payload + dual traffic)."""
        return self.consensus.bits_per_round(state.theta, mode=mode) + self.dual.bits_per_round()


def _consensus_error(theta_stacked, chunk_elems: int = 1 << 22) -> torch.Tensor:
    """Xi_theta = sum_i ||theta_i - theta_bar||^2 over all leaves (f32), taken
    over column blocks of ``chunk_elems`` per node so no f32 copy of a whole
    leaf is made."""
    err = None
    for leaf in tree_leaves(theta_stacked):
        flat = leaf.reshape(leaf.shape[0], -1)
        for lo in range(0, flat.shape[1], chunk_elems):
            x = flat[:, lo:lo + chunk_elems].float()
            part = torch.sum((x - x.mean(0, keepdim=True)) ** 2)
            err = part if err is None else err + part
    return err
