"""Composable decentralized-DRO trainer (paper Algorithms 1-2 as one loop),
PyTorch port of ``repro.core.trainer``.

A round is local update, dual update, communication:

* :class:`LocalUpdate` -- the stochastic oracle and the optimizer step
  (one gradient per node, ``microbatches`` accumulated, or ``local_steps``
  optimizer steps between communication rounds), with the dual's per-node
  gradient weights;
* a dual -- :class:`ProjectedAscent` (AD-GDA), :class:`FrozenPrior`
  (CHOCO-SGD), :class:`KLClosedForm` (DR-DSGD) or :class:`SampledAscent`
  (DRFA);
* a consensus -- :class:`ChocoConsensus` (CHOCO compressed gossip over a
  topology or a :class:`~repro_torch.core.topology.TopologySchedule`),
  :class:`GradientTrackingConsensus` (a second, tracker lane),
  :class:`ExactConsensus` (uncompressed gossip) or :class:`FedAvg`
  (federated server averaging: the state keeps one server model).

All decentralized state is *stacked* (every leaf [m, ...]) in the
reference's parameter tree, so the gossip's chunk plan, per-chunk norms,
gamma and bit counts are the reference's.  The oracle runs node by node
(``torch.autograd`` on views of each node's parameters), holds every node's
gradient (the dual weights may read all losses), then the optimizer updates
the parameters in place leaf by leaf; the consensus updates theta, theta_hat
and s in place chunk by chunk.  So :meth:`DecentralizedTrainer.step`
consumes its input state, as the reference's donating jitted step does.

Time-varying wires: with a schedule the trainer draws the round's
participation mask, builds its W(t), and threads both into the dual and the
consensus.  A node that sits a round out keeps its theta and its optimizer
moments (only the dropped rows are saved before the local update and put
back after it), skips its dual ascent, and freezes its CHOCO trackers.

Randomness: the state holds one ``torch.Generator`` per stream -- the
gossip's quantization noise (every lane, on the trainer's device), the
dual's client sampling and the participation masks (both on the CPU) --
each drawn in a fixed order and saved in checkpoints.  The reference
splits one JAX key per round instead, so the tests inject its draws:
``step(..., noise=, mask=, sampled=)``.

Faults and the ``ppermute`` backend are not yet ported (see ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.core import dro, wire
from repro_torch.core.compression import Compressor, Identity
from repro_torch.core.gossip import (
    BLOCK_SCAN_ELEMS,
    CHOCOState,
    LaneRound,
    _not_ported,
    _scan_plan,
    check_fused,
    choco_init,
    choco_round,
    choco_round_lanes,
    mix_stacked,
    mix_stacked_with,
    payload_bits,
    payload_total_bits,
)
from repro_torch.core.topology import Topology, TopologySchedule
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
    "KLClosedForm",
    "SampledAscent",
    "Consensus",
    "ChocoConsensus",
    "GTState",
    "GradientTrackingConsensus",
    "ExactConsensus",
    "FedAvg",
    "DecentralizedTrainer",
]

LossFn = Callable[[Any, Any, Any], torch.Tensor]


@dataclasses.dataclass
class TrainerState:
    step: int  # round counter
    theta: Any  # stacked tree [m, ...] (federated: the server tree, no node axis)
    lam: torch.Tensor  # dual variable: [m, m] per-node copies, or [m]
    opt: OptState  # optimizer moments + its own step counter
    consensus: Any  # CHOCOState, GTState or ()
    theta_avg: Any  # running mean over time of the network mean (theta_o), or ()
    generator: torch.Generator  # the gossip's quantization noise (every lane)
    dual_generator: torch.Generator  # the dual's sampling (DRFA's clients), CPU
    mask_generator: torch.Generator  # participation masks (dropout), CPU


def _batch_slice(batch, k: int, n: int, layout: str):
    """Part ``k`` of ``n`` of every [m, ...] batch leaf: ``"flat"`` cuts the
    per-node batch axis into n contiguous parts, ``"stacked"`` indexes a
    dedicated axis 1."""
    if layout == "stacked":
        return tree_map(lambda x: x[:, k], batch)

    def part(x):
        if x.shape[1] % n:
            raise ValueError(f"per-node batch {x.shape[1]} not divisible by {n}")
        b = x.shape[1] // n
        return x[:, k * b:(k + 1) * b]

    return tree_map(part, batch)


# ============================================================== local update
@dataclasses.dataclass(frozen=True)
class LocalUpdate:
    """Stochastic oracle + optimizer step on the stacked model, in one of
    three shapes sharing the dual weighting and the optimizer:

    * one gradient and one optimizer update per round;
    * ``microbatches = k > 1``: gradients accumulated over k microbatches in
      ``grad_accum_dtype``, then one update;
    * ``local_steps = K > 1``: K updates between communication rounds; the
      schedule (and Adam's bias correction) sees the round's step count at
      every inner step, and the count advances once per round.

    ``batch_layout``: ``"flat"`` packs the K (or k) parts along the per-node
    batch axis, ``"stacked"`` gives them axis 1 (DRFA).
    """

    optimizer: Optimizer
    schedule: Schedule
    microbatches: int = 1
    local_steps: int = 1
    grad_accum_dtype: str = "float32"
    batch_layout: str = "flat"

    def __post_init__(self):
        if self.local_steps > 1 and self.microbatches > 1:
            raise ValueError("local_steps and microbatches do not compose")
        if self.batch_layout not in ("flat", "stacked"):
            raise ValueError(f"unknown batch_layout {self.batch_layout!r}")

    def init(self, theta_stacked) -> OptState:
        return self.optimizer.init(tree_leaves(theta_stacked))

    def lr(self, opt_state: OptState) -> float:
        return self.schedule(opt_state.step)

    @staticmethod
    def _oracle(loss_fn: LossFn, theta, batch):
        """Every node's loss and gradient: (losses [m] f32, grads[leaf][node])."""
        flat = tree_leaves(theta)
        m = flat[0].shape[0]
        grads = [[None] * m for _ in flat]
        losses = []
        for i in range(m):
            params_i = [leaf[i].detach().requires_grad_(True) for leaf in flat]
            batch_i = tree_map(lambda b: b[i], batch)
            loss = loss_fn(unflatten(theta, params_i), batch_i, None)
            for j, g in enumerate(torch.autograd.grad(loss, params_i)):
                grads[j][i] = g
            losses.append(loss.detach().float())
        return torch.stack(losses), grads

    def _microbatched(self, loss_fn, theta, batch):
        k = self.microbatches
        acc_dt = getattr(torch, self.grad_accum_dtype)
        acc_l, acc_g = None, None
        for j in range(k):
            losses, grads = self._oracle(loss_fn, theta, _batch_slice(batch, j, k, "flat"))
            part = [[g.to(acc_dt) / k for g in row] for row in grads]
            if acc_g is None:
                acc_l = torch.zeros_like(losses) + losses / k
                acc_g = [[torch.zeros_like(g) + g for g in row] for row in part]
            else:
                acc_l = acc_l + losses / k
                acc_g = [[a + g for a, g in zip(ra, rg)] for ra, rg in zip(acc_g, part)]
        return acc_l, acc_g

    def step(self, loss_fn: LossFn, theta, opt_state: OptState, batch,
             weights_fn: Callable[[torch.Tensor], torch.Tensor]):
        """Run the oracle, then the optimizer on ``theta`` in place.

        Returns (opt_state, losses [m] f32; with local steps the mean over
        the K steps).  ``weights_fn(losses) -> [m]`` supplies the dual
        gradient weighting, after every loss evaluation.
        """
        flat = tree_leaves(theta)
        if self.local_steps > 1:
            return self._local_steps(loss_fn, theta, flat, opt_state, batch, weights_fn)
        with record_function("forward_backward"):
            if self.microbatches > 1:
                losses, grads = self._microbatched(loss_fn, theta, batch)
            else:
                losses, grads = self._oracle(loss_fn, theta, batch)
        with record_function("optimizer"):
            opt_state = self.optimizer.apply_(flat, grads, opt_state, weights_fn(losses))
        return opt_state, losses

    def _local_steps(self, loss_fn, theta, flat, opt_state, batch, weights_fn):
        K, round_step = self.local_steps, opt_state.step
        losses_k = []
        for k in range(K):
            with record_function("forward_backward"):
                losses, grads = self._oracle(
                    loss_fn, theta, _batch_slice(batch, k, K, self.batch_layout))
            with record_function("optimizer"):
                inner = OptState(round_step, opt_state.mu, opt_state.nu)
                opt_state = self.optimizer.apply_(flat, grads, inner, weights_fn(losses))
            del grads
            losses_k.append(losses)
        return (OptState(round_step + 1, opt_state.mu, opt_state.nu),
                torch.stack(losses_k).mean(0))


# ================================================================ dual update
class DualUpdate:
    """How the mixture weights lambda evolve across rounds.  ``begin`` draws
    the round's randomness (DRFA's client sampling) and shares it with the
    consensus as ``ctx``."""

    def init(self, m: int, device) -> torch.Tensor:
        raise NotImplementedError

    def begin(self, lam: torch.Tensor, generator: torch.Generator | None, inject=None):
        return None

    def grad_weights(self, lam: torch.Tensor, losses: torch.Tensor) -> torch.Tensor:
        return torch.ones_like(losses)

    def update(self, lam: torch.Tensor, losses: torch.Tensor, ctx=None, *, mixing=None,
               mask=None) -> torch.Tensor:
        """Advance lambda; a time-varying round passes its dense W(t) and
        participation mask (duals that do not gossip ignore them)."""
        raise NotImplementedError

    def bits_per_round(self) -> float:
        return 0.0


def _prior_on(prior, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(prior, np.float32), device=device)


@dataclasses.dataclass(frozen=True)
class ProjectedAscent(DualUpdate):
    """AD-GDA's dual: projected gradient ascent + uncompressed lambda gossip.

        lam_i <- sum_j w_ij P_simplex(lam_j + eta_lam (f_j e_j + alpha grad r))

    Every node keeps its own copy of lambda (state [m, m]); a dropped node
    skips its ascent step, and a time-varying round mixes with W(t).
    """

    prior: np.ndarray
    alpha: float
    eta_lambda: float
    regularizer: dro.Regularizer
    topology: Topology | TopologySchedule

    def init(self, m, device):
        return _prior_on(self.prior, device)[None].expand(m, m).clone()

    def grad_weights(self, lam, losses):
        return (torch.diagonal(lam) / _prior_on(self.prior, lam.device)).float()

    def update(self, lam, losses, ctx=None, *, mixing=None, mask=None):
        m = lam.shape[0]
        prior = _prior_on(self.prior, lam.device)
        node_ids = torch.arange(m, device=lam.device)
        dual_grads = dro.dual_gradient(losses, node_ids, lam, prior, self.alpha,
                                       self.regularizer)
        lam_half = dro.project_simplex(lam + self.eta_lambda * dual_grads)
        if mask is not None:
            lam_half = torch.where((mask > 0).reshape(m, 1), lam_half, lam)
        if mixing is not None:
            return mix_stacked_with(lam_half, mixing)
        return mix_stacked(lam_half, self.topology)

    def bits_per_round(self) -> float:
        return 32.0 * int(np.shape(self.prior)[0]) * self.topology.max_degree


@dataclasses.dataclass(frozen=True)
class FrozenPrior(DualUpdate):
    """Non-robust baseline (CHOCO-SGD): lambda frozen at the prior."""

    prior: np.ndarray

    def init(self, m, device):
        return _prior_on(self.prior, device)[None].expand(m, m).clone()

    def update(self, lam, losses, ctx=None, **_):
        return lam


@dataclasses.dataclass(frozen=True)
class KLClosedForm(DualUpdate):
    """DR-DSGD's dual: the KL inner max in closed form, lambda_i proportional
    to pi_i e^{f_i / alpha}, recomputed from every round's losses (state [m],
    kept for logging)."""

    prior: np.ndarray
    alpha: float

    def init(self, m, device):
        return _prior_on(self.prior, device)

    def grad_weights(self, lam, losses):
        prior = _prior_on(self.prior, losses.device)
        return (dro.kl_closed_form_weights(losses, prior, self.alpha) / prior).float()

    def update(self, lam, losses, ctx=None, **_):
        return dro.kl_closed_form_weights(losses, _prior_on(self.prior, losses.device),
                                          self.alpha)


@dataclasses.dataclass(frozen=True)
class SampledAscent(DualUpdate):
    """DRFA's dual: sample |U| clients ~ lambda (Gumbel top-k, no
    replacement), run the round on them, then projected ascent on the
    importance-corrected observed losses.  The sampling mask is the round's
    ``ctx``, shared with :class:`FedAvg`."""

    prior: np.ndarray
    eta_lambda: float
    local_steps: int
    num_sampled: int

    def init(self, m, device):
        return _prior_on(self.prior, device)

    def begin(self, lam, generator, inject=None):
        """The round's [m] 0/1 sampling mask: ``inject`` if given, else
        Gumbel top-k of log(lambda) with the uniforms from ``generator``."""
        m = lam.shape[0]
        if inject is not None:
            return torch.as_tensor(inject, dtype=torch.float32).to(lam.device)
        u = torch.rand(m, generator=generator, dtype=torch.float32).to(lam.device)
        gumbel = -torch.log(-torch.log(u + 1e-20) + 1e-20)
        scores = torch.log(lam + 1e-20) + gumbel
        sampled = torch.topk(scores, self.num_sampled).indices
        return torch.zeros(m, dtype=torch.float32, device=lam.device).index_fill_(0, sampled,
                                                                                   1.0)

    def update(self, lam, losses, ctx=None, **_):
        sampled = ctx
        m = lam.shape[0]
        wsum = sampled.sum()
        loss_vec = losses * sampled * (m / torch.clamp(wsum, min=1.0))
        return dro.project_simplex(lam + self.eta_lambda * self.local_steps * loss_vec)


# ================================================================== consensus
class Consensus:
    """How the half-step models travel the wire.  ``schedule`` is set when
    the wire is time-varying; the trainer then passes the round index, the
    participation ``mask`` and the round's dense ``mixing`` to :meth:`mix`."""

    needs_theta_prev: bool = False  # gradient tracking reads the pre-update theta
    federated: bool = False  # True -> state.theta has no node axis
    schedule: TopologySchedule | None = None

    def init(self, theta_stacked):
        return ()

    def mix(self, theta_half, state, generator, ctx=None, *, step=None, mask=None, mixing=None,
            noise=None, theta_prev=None):
        raise NotImplementedError

    @property
    def wire_format(self) -> wire.WireFormat:
        return wire.DENSE

    def bits_per_round(self, theta_template, *, mode: str = "max", step=None,
                       mask=None) -> float:
        raise NotImplementedError

    def bits_realized(self, theta_template, step, mask, consensus_state=None) -> float:
        """This round's wire bits (the busiest node's realized links)."""
        return float(np.float32(self.bits_per_round(theta_template, mode="max")))


def _check_wire(backend: str, faults) -> None:
    if backend != "rolled":
        raise _not_ported(f"gossip backend {backend!r}")
    if faults is not None:
        raise _not_ported("wire faults (fault_spec)")


def _split_schedule(topology):
    """(representative topology, schedule or None, gamma source): a static
    schedule unwraps to its topology, so the circulant packed / fused paths
    run as on a plain topology."""
    if isinstance(topology, TopologySchedule):
        sched = None if topology.is_static else topology
        return topology.topology_at(0), sched, (sched or topology.topology_at(0))
    return topology, None, topology


def _realized_bits(total: float, degree: float) -> float:
    return float(np.float32(total) * np.float32(degree))


class ChocoConsensus(Consensus):
    """CHOCO-GOSSIP compressed round with the ``packed`` / ``fused``
    dispatch of ``gossip.choco_round``, on a topology or a schedule.  A
    time-varying schedule runs the masked round; ``fused=True`` with it, or
    with a compressor or topology the fused round cannot take, raises (the
    reference silently falls back)."""

    def __init__(self, topology: Topology | TopologySchedule, compressor: Compressor,
                 gamma: float | str | None = None, *, packed: bool = True,
                 fused: bool = False, backend: str = "rolled", faults=None):
        _check_wire(backend, faults)
        self.topology, self.schedule, self._gamma_topology = _split_schedule(topology)
        if fused and self.schedule is not None:
            raise ValueError(
                f"fused gossip runs a static circulant round; the time-varying wire "
                f"{self.schedule.name!r} (a schedule or dropout) runs the masked path, "
                f"which has no fused form: drop --fused-gossip")
        if fused:
            check_fused(self.topology, compressor)
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
        ``"theory"`` -> Theorem 4.1 (the worst phase of a schedule), a
        number -> verbatim, None -> 0.5 delta(d)."""
        delta = getattr(self.compressor, "delta", 1.0)
        if hasattr(self.compressor, "delta_for"):
            delta = self.compressor.delta_for(max(int(d), 1))
        if self.gamma_spec == "theory":
            return self._gamma_topology.consensus_step_size(max(delta, 1e-3))
        if self.gamma_spec is not None:
            return float(self.gamma_spec)
        return 0.5 * max(delta, 1e-3)

    def init(self, theta_stacked) -> CHOCOState:
        self.gamma = self._resolve_gamma(self._encode_dim(theta_stacked))
        return choco_init(theta_stacked)

    def _round_mixing(self, step, mask, mixing):
        if self.schedule is not None and mixing is None:
            return self.schedule.mixing_at(0 if step is None else step, mask)
        return mixing

    def mix(self, theta_half, state, generator, ctx=None, *, step=None, mask=None, mixing=None,
            noise=None, theta_prev=None):
        gamma = self._resolve_gamma(self._encode_dim(theta_half))
        return choco_round(theta_half, state, self.topology, gamma, self.compressor,
                           generator=generator, noise=noise, packed=self.packed,
                           fused=self.fused, mixing=self._round_mixing(step, mask, mixing),
                           mask=mask)

    @property
    def wire_format(self) -> wire.WireFormat:
        if isinstance(self.compressor, Identity) or not self.packed:
            return wire.DENSE
        return wire.PAYLOAD

    def bits_per_round(self, theta_template, *, mode: str = "max", step=None, mask=None,
                       compressor=None) -> float:
        comp = compressor if compressor is not None else self.compressor
        return payload_bits(comp, theta_template, self.schedule or self.topology, mode=mode,
                            step=step, mask=mask)

    def bits_per_lane(self, theta_template, *, mode: str = "max", step=None,
                      mask=None) -> dict:
        """Busiest-node bits per :attr:`wire_format` lane, keyed by name."""
        one = ChocoConsensus.bits_per_round(self, theta_template, mode=mode, step=step,
                                            mask=mask)
        return {lane.name: one for lane in self.wire_format}

    def bits_realized(self, theta_template, step, mask, consensus_state=None):
        total = payload_total_bits(self.compressor, theta_template)
        topo = self.schedule or self.topology
        return _realized_bits(total, topo.realized_degree_traced(step, mask))


@dataclasses.dataclass
class GTState:
    """Gradient-tracking consensus state: one :class:`CHOCOState` per lane,
    the tracker ``y`` (each node's gossiped estimate of the network-average
    local displacement) and ``d_prev``, the node's own last displacement."""

    model: CHOCOState
    tracker: CHOCOState
    y: Any  # stacked tree [m, ...], theta-shaped
    d_prev: Any  # stacked tree [m, ...], theta-shaped


# f32 temporaries of the tracker update are made over column blocks of this
# many elements per node, never over a whole leaf
_GT_CHUNK = 1 << 22


def _gt_update_(theta_half, theta_prev, y, d_prev, alive) -> None:
    """The tracker update, leaf by leaf and block by block, in place:
    ``theta_half`` <- x_half, ``y`` <- y_half, ``d_prev`` <- d (see
    :class:`GradientTrackingConsensus`); ``alive`` is the [m] mask or None."""
    for h, p, yl, dl in zip(*(tree_leaves(t) for t in (theta_half, theta_prev, y, d_prev))):
        m = h.shape[0]
        hv, pv, yv, dv = (x.view(m, -1) for x in (h, p, yl, dl))
        a = None if alive is None else alive.reshape(m, 1)
        for lo in range(0, hv.shape[1], _GT_CHUNK):
            hh, pp, yy, dd = (x[:, lo:lo + _GT_CHUNK] for x in (hv, pv, yv, dv))
            d = hh.float() - pp.float()
            if a is not None:
                y_half = yy.float() + a * (d - dd.float())
                d_new = a * d + (1.0 - a) * dd.float()
                x_half = hh.float() + a * (y_half - d)
            else:
                y_half = yy.float() + d - dd.float()
                d_new = d
                x_half = pp.float() + y_half
            hh.copy_(x_half)
            yy.copy_(y_half)
            dd.copy_(d_new)


class GradientTrackingConsensus(ChocoConsensus):
    """CHOCO-compressed gossip with gradient tracking for K local steps
    (arXiv 2405.00965, in CHOCO displacement form).  With ``d_i =
    theta_half_i - theta_prev_i`` the node's K-step displacement::

        y_half_i = y_i + d_i - d_prev_i            # tracker update
        x_half_i = theta_prev_i + y_half_i         # drift-corrected iterate
        theta    <- CHOCO-round(x_half, model lane)
        y        <- CHOCO-round(y_half, tracker lane)
        d_prev_i <- d_i

    The lanes ride one round (:func:`~repro_torch.core.gossip.choco_round_lanes`),
    each with its own trackers; the tracker lane may use its own compressor
    and gamma.  A dropped node keeps ``y`` and ``d_prev``.  ``tracker=False``
    is :class:`ChocoConsensus` exactly.  The update runs in place over
    column blocks, so only the pre-update theta (``theta_prev``, one copy
    the trainer keeps) adds a theta-sized tree.  ``noise`` is a pair, the
    model lane's and the tracker lane's.
    """

    def __init__(self, topology, compressor, gamma=None, *, tracker: bool = True,
                 tracker_gamma: float | None = None,
                 tracker_compressor: Compressor | str | None = None, **kw):
        super().__init__(topology, compressor, gamma, **kw)
        self.tracker = tracker
        self.tracker_gamma_spec = tracker_gamma
        if isinstance(tracker_compressor, str):
            from repro_torch.core.compression import make_compressor

            tracker_compressor = make_compressor(tracker_compressor)
        if (self.fused and tracker_compressor is not None
                and not getattr(tracker_compressor, "supports_fused_round", False)):
            check_fused(self.topology, tracker_compressor)
        self.tracker_compressor = tracker_compressor

    @property
    def needs_theta_prev(self) -> bool:
        return self.tracker

    @property
    def _tracker_comp(self) -> Compressor:
        return (self.tracker_compressor if self.tracker_compressor is not None
                else self.compressor)

    def _resolve_tracker_gamma(self, gamma: float, d: int) -> float:
        """An explicit ``tracker_gamma``; else the model's gamma when the
        lanes share a compressor; else 0.5 delta of the tracker's."""
        if self.tracker_gamma_spec is not None:
            return float(self.tracker_gamma_spec)
        if self.tracker_compressor is None:
            return gamma
        comp = self.tracker_compressor
        delta = getattr(comp, "delta", 1.0)
        if hasattr(comp, "delta_for"):
            delta = comp.delta_for(max(int(d), 1))
        return 0.5 * max(delta, 1e-3)

    def init(self, theta_stacked):
        base = super().init(theta_stacked)
        if not self.tracker:
            return base
        zeros = lambda: tree_map(torch.zeros_like, theta_stacked)
        return GTState(model=base, tracker=choco_init(theta_stacked), y=zeros(), d_prev=zeros())

    def mix(self, theta_half, state, generator, ctx=None, *, step=None, mask=None, mixing=None,
            noise=None, theta_prev=None):
        if not self.tracker:
            return super().mix(theta_half, state, generator, ctx, step=step, mask=mask,
                               mixing=mixing, noise=noise)
        if theta_prev is None:
            raise ValueError("GradientTrackingConsensus.mix needs theta_prev (the round's "
                             "pre-local-update theta)")
        d = self._encode_dim(theta_half)
        gamma = self._resolve_gamma(d)
        tgamma = self._resolve_tracker_gamma(gamma, d)
        _gt_update_(theta_half, theta_prev, state.y, state.d_prev, mask)
        (x_new, y_new), (model_new, tracker_new) = choco_round_lanes(
            (LaneRound(theta_half, state.model, gamma, self.compressor),
             LaneRound(state.y, state.tracker, tgamma, self._tracker_comp)),
            self.topology, generator, noises=noise, packed=self.packed, fused=self.fused,
            mixing=self._round_mixing(step, mask, mixing), mask=mask)
        return x_new, GTState(model=model_new, tracker=tracker_new, y=y_new,
                              d_prev=state.d_prev)

    @property
    def wire_format(self) -> wire.WireFormat:
        base = super().wire_format
        if not self.tracker:
            return base
        kind = tkind = base.lanes[0].kind
        if self.tracker_compressor is not None:
            tkind = (wire.DENSE.lanes[0].kind
                     if isinstance(self.tracker_compressor, Identity) or not self.packed
                     else kind)
        return wire.WireFormat((wire.Lane(kind, "model"), wire.Lane(tkind, "tracker")))

    def bits_per_round(self, theta_template, *, mode: str = "max", step=None, mask=None,
                       compressor=None) -> float:
        if compressor is not None:
            return super().bits_per_round(theta_template, mode=mode, step=step, mask=mask,
                                          compressor=compressor)
        return sum(self.bits_per_lane(theta_template, mode=mode, step=step,
                                      mask=mask).values())

    def bits_per_lane(self, theta_template, *, mode: str = "max", step=None,
                      mask=None) -> dict:
        """Each lane priced at its own compressor."""
        if not self.tracker:
            return super().bits_per_lane(theta_template, mode=mode, step=step, mask=mask)
        comps = {"model": self.compressor, "tracker": self._tracker_comp}
        return {lane.name: ChocoConsensus.bits_per_round(self, theta_template, mode=mode,
                                                         step=step, mask=mask,
                                                         compressor=comps[lane.name])
                for lane in self.wire_format}

    def bits_realized(self, theta_template, step, mask, consensus_state=None):
        one = super().bits_realized(theta_template, step, mask)
        if not self.tracker:
            return one
        scale = 2.0
        if self.tracker_compressor is not None:
            model_total = payload_total_bits(self.compressor, theta_template)
            scale = 1.0 + (payload_total_bits(self.tracker_compressor, theta_template)
                           / model_total if model_total else 1.0)
        return float(np.float32(scale) * np.float32(one))


class ExactConsensus(Consensus):
    """Uncompressed gossip: theta_i <- sum_j w_ij theta_j (DR-DSGD's wire),
    on a topology or a schedule (W(t), dropped nodes hold their model)."""

    def __init__(self, topology: Topology | TopologySchedule, *, backend: str = "rolled",
                 faults=None):
        _check_wire(backend, faults)
        self.topology, self.schedule, _ = _split_schedule(topology)

    def mix(self, theta_half, state, generator, ctx=None, *, step=None, mask=None, mixing=None,
            noise=None, theta_prev=None):
        if self.schedule is not None and mixing is None:
            mixing = self.schedule.mixing_at(0 if step is None else step, mask)
        if mixing is not None:
            return mix_stacked_with(theta_half, mixing), state
        return mix_stacked(theta_half, self.topology), state

    def bits_per_round(self, theta_template, *, mode: str = "max", step=None,
                       mask=None) -> float:
        return payload_bits(Identity(), theta_template, self.schedule or self.topology,
                            mode=mode, step=step, mask=mask)

    def bits_realized(self, theta_template, step, mask, consensus_state=None):
        total = payload_total_bits(Identity(), theta_template)
        topo = self.schedule or self.topology
        return _realized_bits(total, topo.realized_degree_traced(step, mask))


class FedAvg(Consensus):
    """Federated server averaging over the sampled clients (DRFA's wire):
    stacked local models in, the single server model out (the trainer
    broadcasts it next round).  With no sampling ``ctx`` every client is
    averaged."""

    federated = True

    def __init__(self, num_sampled: int, *, backend: str = "rolled"):
        _check_wire(backend, None)
        self.num_sampled = num_sampled

    def mix(self, theta_locals, state, generator, ctx=None, *, step=None, mask=None,
            mixing=None, noise=None, theta_prev=None):
        m = tree_leaves(theta_locals)[0].shape[0]
        sampled = ctx
        if sampled is None:
            sampled = torch.ones(m, dtype=torch.float32,
                                 device=tree_leaves(theta_locals)[0].device)
        wsum = sampled.sum()
        theta_new = tree_map(
            lambda x: ((x.float() * sampled.reshape((m,) + (1,) * (x.ndim - 1))).sum(0)
                       / wsum).to(x.dtype), theta_locals)
        return theta_new, state

    def bits_per_round(self, theta_template, *, mode: str = "max", step=None,
                       mask=None) -> float:
        """The server: |U| models down and |U| up, f32; the template is the
        server model (no node axis)."""
        d = sum(int(np.prod(x.shape)) for x in tree_leaves(theta_template))
        return 2.0 * self.num_sampled * d * 32.0


# ==================================================================== trainer
def _rows(mask) -> list[int]:
    return [i for i, a in enumerate(mask.tolist()) if a <= 0]


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
                 dual: DualUpdate, consensus: Consensus, prior=None,
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
        self.federated = consensus.federated

    @property
    def topology(self) -> Topology | None:
        return getattr(self.consensus, "topology", None)

    @property
    def schedule(self) -> TopologySchedule | None:
        """The time-varying schedule, or None when the wire is static."""
        return getattr(self.consensus, "schedule", None)

    @property
    def compressor(self) -> Compressor | None:
        return getattr(self.consensus, "compressor", None)

    @property
    def gamma(self) -> float | None:
        return getattr(self.consensus, "gamma", None)

    def _stacked(self, params):
        m = self.num_nodes
        return tree_map(
            lambda p: p.to(self.device)[None].expand((m,) + tuple(p.shape)).clone(), params)

    # ------------------------------------------------------------------ init
    def init(self, params: Any, seed: int = 0) -> TrainerState:
        """Stack ``params`` (one model, any device) to every node on the
        trainer's device (federated: keep one server copy).  The generators
        are seeded from ``seed``: gossip ``seed``, dual ``seed + 2**32``,
        mask ``seed + 2**33``."""
        stacked = self._stacked(params)
        theta0 = (tree_map(lambda p: p.to(self.device, copy=True), params) if self.federated
                  else stacked)
        return TrainerState(
            step=0,
            theta=theta0,
            lam=self.dual.init(self.num_nodes, self.device),
            opt=self.local.init(stacked),
            consensus=self.consensus.init(stacked),
            theta_avg=(tree_map(lambda p: p.to(self.device, torch.float32, copy=True), params)
                       if self.track_average else ()),
            generator=torch.Generator(device=self.device).manual_seed(seed),
            dual_generator=torch.Generator().manual_seed(seed + (1 << 32)),
            mask_generator=torch.Generator().manual_seed(seed + (2 << 32)),
        )

    # ------------------------------------------------------------------ step
    def step(self, state: TrainerState, batch: Any, *, noise=None, mask=None,
             sampled=None) -> tuple[TrainerState, dict]:
        """One round; ``state``'s tensors are updated in place and returned in
        a new :class:`TrainerState` with the aux metrics (device tensors).
        ``noise`` / ``mask`` / ``sampled`` inject the gossip noise, the
        participation mask and the dual's client sample in place of draws."""
        schedule = self.schedule
        needs_mask = schedule is not None and schedule.dropout_rate > 0
        if mask is not None and not needs_mask:
            raise ValueError("mask= needs a wire with dropout")
        if needs_mask:
            mask = (schedule.mask_at(state.mask_generator, state.step) if mask is None
                    else torch.tensor(np.asarray(mask, np.float32)))
        mixing = (schedule.mixing_at(state.step, mask).to(self.device)
                  if schedule is not None else None)
        mask_dev = None if mask is None else mask.to(self.device)
        ctx = self.dual.begin(state.lam, state.dual_generator, inject=sampled)

        theta = self._stacked(state.theta) if self.federated else state.theta
        flat = tree_leaves(theta)
        theta_prev = (tree_map(lambda x: x.clone(), theta)
                      if self.consensus.needs_theta_prev else None)
        dropped = _rows(mask) if mask is not None else []
        if dropped:  # the dropped rows only: theta and the per-node moments
            rows = torch.tensor(dropped, device=self.device)
            moments = [x for part in (state.opt.mu, state.opt.nu) for x in part]
            saved = [x.index_select(0, rows) for x in flat + moments]

        eta = self.local.lr(state.opt)
        weights_fn = lambda losses: self.dual.grad_weights(state.lam, losses)
        opt_new, losses = self.local.step(self.loss_fn, theta, state.opt, batch, weights_fn)
        if dropped:  # a node that sat the round out resumes where it left off
            moments = [x for part in (opt_new.mu, opt_new.nu) for x in part]
            for x, old in zip(flat + moments, saved):
                x.index_copy_(0, rows, old)
            del saved
        with record_function("dual"):
            lam_new = self.dual.update(state.lam, losses, ctx, mixing=mixing, mask=mask_dev)
        with record_function("consensus"):
            theta_new, cons_new = self.consensus.mix(
                theta, state.consensus, state.generator, ctx, step=state.step, mask=mask_dev,
                mixing=mixing, noise=noise, theta_prev=theta_prev)
        del theta_prev

        theta_avg = state.theta_avg
        if self.track_average:
            mean = (lambda th: th.float()) if self.federated else (lambda th: th.float().mean(0))

            def running(avg, th):
                tt = float(state.step)
                return (avg * tt + mean(th)) / f32_full(avg, tt + 1.0)

            theta_avg = tree_map(running, state.theta_avg, theta_new)

        aux = {
            "losses": losses,
            "worst_loss": losses.max(),
            "mean_loss": losses.mean(),
            "lambda_mean": lam_new.mean(0) if lam_new.ndim == 2 else lam_new,
            "eta_theta": eta,
        }
        if not self.federated:
            with record_function("consensus_err"):
                aux["consensus_err"] = _consensus_error(theta_new)
        if mask is not None:
            aux["participation"] = mask
        aux["bits_realized"] = float(
            np.float32(self.consensus.bits_realized(theta_new, state.step, mask))
            + np.float32(self.dual.bits_per_round()))
        new_state = dataclasses.replace(state, step=state.step + 1, theta=theta_new,
                                        lam=lam_new, opt=opt_new, consensus=cons_new,
                                        theta_avg=theta_avg)
        return new_state, aux

    # ------------------------------------------------------------- utilities
    def network_mean(self, state: TrainerState):
        if self.federated:
            return tree_map(lambda x: x.float(), state.theta)
        return tree_map(lambda x: x.float().mean(0), state.theta)

    def bits_per_round(self, state: TrainerState, per_iteration: bool = False, *,
                       mode: str = "max", step=None, mask=None) -> float:
        """Bits sent per round by the busiest node (model payload + the
        dual's traffic); ``per_iteration=True`` divides by ``local_steps``.
        ``mode`` bills the payload at the max, expected or realized degree
        (the dual's m floats stay at their upper bound)."""
        bits = (self.consensus.bits_per_round(state.theta, mode=mode, step=step, mask=mask)
                + self.dual.bits_per_round())
        if per_iteration:
            bits /= self.local.local_steps
        return bits


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
