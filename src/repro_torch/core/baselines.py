"""Baselines the paper compares against (Table 1, §5.2), PyTorch port of
``repro.core.baselines``:

* CHOCO-SGD -- AD-GDA with the dual frozen at the prior;
* DR-DSGD (Issaid et al. 2022) -- the KL dual in closed form
  (lambda_i proportional to pi_i exp(f_i / alpha)) over uncompressed gossip;
* DRFA (Deng et al. 2021) -- federated: each round the server samples |U| =
  round(participation m) clients by lambda, they run K local SGD steps, the
  server averages them and takes a projected ascent step on lambda.

All three are compositions of :class:`~repro_torch.core.trainer.DecentralizedTrainer`.
The reference's deprecated ``DRDSGD`` / ``DRFA`` shim classes are not yet
ported (see ROADMAP.md); the factories are what they wrap.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.adgda import ADGDAConfig, LossFn, adgda_trainer
from repro_torch.core.gossip import _not_ported
from repro_torch.core.topology import make_topology
from repro_torch.core.trainer import (
    DecentralizedTrainer,
    ExactConsensus,
    FedAvg,
    KLClosedForm,
    LocalUpdate,
    SampledAscent,
)
from repro_torch.optim import make_schedule, sgd

__all__ = ["choco_sgd", "DRDSGDConfig", "drdsgd_trainer", "DRFAConfig", "drfa_trainer"]


def choco_sgd(config: ADGDAConfig, loss_fn: LossFn, prior=None, *, mesh=None,
              node_axes="data", device="cuda") -> DecentralizedTrainer:
    """CHOCO-SGD = AD-GDA with the dual frozen at the prior."""
    return adgda_trainer(dataclasses.replace(config, robust=False), loss_fn, prior, mesh=mesh,
                         node_axes=node_axes, device=device)


def _prior(m: int, prior) -> np.ndarray:
    return np.full((m,), 1.0 / m, np.float32) if prior is None else np.asarray(prior, np.float32)


@dataclasses.dataclass(frozen=True)
class DRDSGDConfig:
    num_nodes: int = 8
    topology: str = "ring"
    alpha: float = 6.0  # KL temperature (the paper's alpha = 6)
    eta_theta: float = 0.1
    lr_decay: float = 1.0
    momentum: float = 0.0
    gossip_backend: str = "rolled"  # "ppermute" not yet ported
    fault_spec: str | None = None  # not yet ported
    track_average: bool = True


def drdsgd_trainer(config: DRDSGDConfig, loss_fn: LossFn, prior=None, *, mesh=None,
                   node_axes="data", device="cuda") -> DecentralizedTrainer:
    """Compose DR-DSGD: closed-form KL dual x exact (uncompressed) gossip."""
    if mesh is not None:
        raise _not_ported("mesh placement")
    m = config.num_nodes
    prior = _prior(m, prior)
    sched = make_schedule("exp", config.eta_theta, decay=config.lr_decay)
    return DecentralizedTrainer(
        loss_fn, num_nodes=m,
        local=LocalUpdate(optimizer=sgd(sched, momentum=config.momentum), schedule=sched),
        dual=KLClosedForm(prior=prior, alpha=config.alpha),
        consensus=ExactConsensus(make_topology(config.topology, m),
                                 backend=config.gossip_backend, faults=config.fault_spec),
        prior=prior, track_average=config.track_average, config=config, device=device)


@dataclasses.dataclass(frozen=True)
class DRFAConfig:
    num_nodes: int = 8
    participation: float = 0.5  # fraction of clients sampled per round
    local_steps: int = 10  # K
    eta_theta: float = 0.1
    eta_lambda: float = 0.1
    lr_decay: float = 1.0
    momentum: float = 0.0
    gossip_backend: str = "rolled"  # "ppermute" not yet ported
    track_average: bool = True


def drfa_trainer(config: DRFAConfig, loss_fn: LossFn, prior=None, *, mesh=None,
                 node_axes="data", device="cuda") -> DecentralizedTrainer:
    """Compose DRFA: K-local-step oracle x sampled dual ascent x server
    averaging.  ``batch`` leaves are [m, K, ...]: every client runs the K
    steps; only the sampled ones enter the average and the ascent."""
    if mesh is not None:
        raise _not_ported("mesh placement")
    m = config.num_nodes
    prior = _prior(m, prior)
    num_sampled = max(1, int(round(config.participation * m)))
    sched = make_schedule("exp", config.eta_theta, decay=config.lr_decay)
    return DecentralizedTrainer(
        loss_fn, num_nodes=m,
        local=LocalUpdate(optimizer=sgd(sched, momentum=config.momentum), schedule=sched,
                          local_steps=config.local_steps, batch_layout="stacked"),
        dual=SampledAscent(prior=prior, eta_lambda=config.eta_lambda,
                           local_steps=config.local_steps, num_sampled=num_sampled),
        consensus=FedAvg(num_sampled, backend=config.gossip_backend),
        prior=prior, track_average=config.track_average, config=config, device=device)
