"""AD-GDA -- Agnostic Decentralized GDA with compressed communication
(paper Algorithm 1), PyTorch port of ``repro.core.adgda``.

One step:

  theta_i^{t+1/2} = theta_i - eta_th * lam_i[i] / pi_i * grad f_i(theta_i)   # descent
  lam_i^{t+1/2}   = P_simplex(lam_i + eta_lam * (f_i e_i + alpha grad r(lam_i)))
  theta, hat, s   = CHOCO round (compressed gossip)                          # wire
  lam_i^{t+1}     = sum_j w_ij lam_j^{t+1/2}                                 # wire (m floats)

:func:`adgda_trainer` assembles a :class:`DecentralizedTrainer` from an
:class:`ADGDAConfig` (same fields and defaults as the reference).  Settings
outside the ported path raise when set to a non-default value.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import dro
from repro_torch.core.compression import Compressor, make_compressor
from repro_torch.core.gossip import _not_ported
from repro_torch.core.topology import Topology, make_topology
from repro_torch.core.trainer import (
    ChocoConsensus,
    DecentralizedTrainer,
    FrozenPrior,
    LocalUpdate,
    LossFn,
    ProjectedAscent,
)
from repro_torch.optim import adam, make_schedule, sgd

__all__ = ["ADGDAConfig", "adgda_trainer"]


@dataclasses.dataclass(frozen=True)
class ADGDAConfig:
    num_nodes: int = 8
    topology: str = "ring"
    topology_schedule: str | None = None  # not yet ported
    dropout: float = 0.0  # not yet ported
    topology_p: float | None = None  # edge probability for erdos_renyi
    topology_seed: int = 0  # graph-sampling seed (erdos_renyi)
    compressor: str | Compressor = "q8b"  # a spec, or a Compressor object
    regularizer: str = "chi2"
    alpha: float = 0.01
    eta_theta: float = 0.1
    eta_lambda: float = 0.01
    lr_decay: float = 1.0  # eta_t = lr_decay^t * eta_0
    gamma: float | str | None = None  # None -> 0.5*delta; "theory" -> Thm 4.1 value
    momentum: float = 0.0
    gossip_backend: str = "rolled"  # "ppermute" not yet ported
    packed_gossip: bool = True
    fused_gossip: bool = False  # the fused CUDA round; needs a kq*b compressor
    robust: bool = True  # False -> CHOCO-SGD (fixed lambda = prior)
    track_average: bool = True  # f32 running mean of the network mean (theta_o)
    microbatches: int = 1  # > 1 not yet ported
    grad_accum_dtype: str = "float32"
    local_steps: int = 1  # > 1 not yet ported
    consensus: str = "choco"  # "gt" not yet ported
    tracker_gamma: float | None = None  # gt only
    tracker_compressor: str | None = None  # gt only
    fault_spec: str | None = None  # not yet ported
    spmd_axis_name: tuple | str | None = None  # no meaning here (one device)
    optimizer: str = "sgd"  # "sgd" (momentum/nesterov) or "adam"
    schedule: str = "exp"  # "const" | "exp" | "cosine"
    warmup: int = 0
    total_steps: int = 1000
    nesterov: bool = False

    def check_ported(self) -> None:
        """Raise for any setting outside the ported main path."""
        unported = {
            "topology_schedule": self.topology_schedule is not None,
            "dropout": self.dropout != 0.0,
            "fault_spec": self.fault_spec is not None,
            f"consensus={self.consensus!r}": self.consensus != "choco",
            f"gossip_backend={self.gossip_backend!r}": self.gossip_backend != "rolled",
            "microbatches > 1": self.microbatches != 1,
            "local_steps > 1": self.local_steps != 1,
            "tracker_gamma / tracker_compressor": (self.tracker_gamma is not None
                                                   or self.tracker_compressor is not None),
        }
        bad = [name for name, on in unported.items() if on]
        if bad:
            raise _not_ported(", ".join(bad))

    def build(self) -> tuple[Topology, Compressor]:
        """(topology, compressor) for the consensus layer."""
        comp = (self.compressor if isinstance(self.compressor, Compressor)
                else make_compressor(self.compressor))
        kw = {}
        if self.topology == "erdos_renyi":
            if self.topology_p is not None:
                kw["p"] = self.topology_p
            kw["seed"] = self.topology_seed
        return make_topology(self.topology, self.num_nodes, **kw), comp

    def make_optimizer(self):
        """(optimizer, schedule) from the config -- the primal update rule."""
        sched = make_schedule(self.schedule, self.eta_theta, decay=self.lr_decay,
                              total_steps=self.total_steps, warmup=self.warmup)
        if self.optimizer == "sgd":
            return sgd(sched, momentum=self.momentum, nesterov=self.nesterov), sched
        if self.optimizer == "adam":
            if self.momentum != 0.0 or self.nesterov:
                raise ValueError("momentum/nesterov only apply to optimizer='sgd'")
            return adam(sched), sched
        raise ValueError(f"unknown optimizer {self.optimizer!r}; choose sgd or adam")


def adgda_trainer(config: ADGDAConfig, loss_fn: LossFn, prior=None, *, mesh=None,
                  node_axes="data", device="cuda") -> DecentralizedTrainer:
    """Compose AD-GDA (paper Algorithm 1) as a :class:`DecentralizedTrainer`
    on ``device``.  ``robust=False`` yields CHOCO-SGD (dual frozen at the
    prior) -- same wire, same oracle."""
    config.check_ported()
    if mesh is not None:
        raise _not_ported("mesh placement")
    m = config.num_nodes
    topology, compressor = config.build()
    prior = (np.full((m,), 1.0 / m, np.float32) if prior is None
             else np.asarray(prior, np.float32))
    optimizer, schedule = config.make_optimizer()
    local = LocalUpdate(optimizer=optimizer, schedule=schedule)
    consensus = ChocoConsensus(topology, compressor, config.gamma,
                               packed=config.packed_gossip, fused=config.fused_gossip)
    if config.robust:
        dual = ProjectedAscent(prior=prior, alpha=config.alpha, eta_lambda=config.eta_lambda,
                               regularizer=dro.make_regularizer(config.regularizer),
                               topology=topology)
    else:
        dual = FrozenPrior(prior=prior)
    return DecentralizedTrainer(loss_fn, num_nodes=m, local=local, dual=dual,
                                consensus=consensus, prior=prior,
                                track_average=config.track_average, config=config,
                                device=device)
