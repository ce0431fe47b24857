"""AD-GDA -- Agnostic Decentralized GDA with compressed communication
(paper Algorithm 1), PyTorch port of ``repro.core.adgda``.

One step:

  theta_i^{t+1/2} = theta_i - eta_th * lam_i[i] / pi_i * grad f_i(theta_i)   # descent
  lam_i^{t+1/2}   = P_simplex(lam_i + eta_lam * (f_i e_i + alpha grad r(lam_i)))
  theta, hat, s   = CHOCO round (compressed gossip)                          # wire
  lam_i^{t+1}     = sum_j w_ij lam_j^{t+1/2}                                 # wire (m floats)

:func:`adgda_trainer` assembles a :class:`DecentralizedTrainer` from an
:class:`ADGDAConfig` (same fields and defaults as the reference): a static
topology or a time-varying schedule with dropout, CHOCO or gradient-tracking
consensus, microbatches or local steps.  Wire faults and the ``ppermute``
backend raise (not yet ported).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import dro
from repro_torch.core.compression import Compressor, make_compressor
from repro_torch.core.gossip import _not_ported
from repro_torch.core.topology import (
    Topology,
    TopologySchedule,
    make_topology,
    make_topology_schedule,
)
from repro_torch.core.trainer import (
    ChocoConsensus,
    DecentralizedTrainer,
    FrozenPrior,
    GradientTrackingConsensus,
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
    topology_schedule: str | None = None  # "roundrobin:a,b" | "matching[:P]" | a name
    dropout: float = 0.0  # per-round Bernoulli node-dropout probability
    topology_p: float | None = None  # edge probability for erdos_renyi
    topology_seed: int = 0  # graph-sampling seed (erdos_renyi, matchings)
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
    microbatches: int = 1  # gradient accumulation over k microbatches
    grad_accum_dtype: str = "float32"
    local_steps: int = 1  # K optimizer steps between gossip rounds (K x the batch)
    consensus: str = "choco"  # "choco" or "gt" (gradient tracking, a second lane)
    tracker_gamma: float | None = None  # gt only: the tracker lane's step size
    tracker_compressor: str | None = None  # gt only: the tracker lane's compressor
    fault_spec: str | None = None  # not yet ported
    spmd_axis_name: tuple | str | None = None  # no meaning here (one device)
    optimizer: str = "sgd"  # "sgd" (momentum/nesterov) or "adam"
    schedule: str = "exp"  # "const" | "exp" | "cosine"
    warmup: int = 0
    total_steps: int = 1000
    nesterov: bool = False

    def check_ported(self) -> None:
        """Raise for a setting outside the port: wire faults and the
        ``ppermute`` backend."""
        unported = {
            "fault_spec": self.fault_spec is not None,
            f"gossip_backend={self.gossip_backend!r}": self.gossip_backend != "rolled",
        }
        bad = [name for name, on in unported.items() if on]
        if bad:
            raise _not_ported(", ".join(bad))

    def build(self) -> tuple[Topology | TopologySchedule, Compressor]:
        """(topology-or-schedule, compressor) for the consensus layer: a plain
        :class:`Topology` unless ``topology_schedule`` or ``dropout`` asks
        for time variation."""
        comp = (self.compressor if isinstance(self.compressor, Compressor)
                else make_compressor(self.compressor))
        spec = self.topology_schedule or self.topology
        kw = {}
        if spec == "erdos_renyi" and self.topology_p is not None:
            kw["p"] = self.topology_p
        if self.topology_schedule is not None or self.dropout > 0.0:
            return make_topology_schedule(spec, self.num_nodes, dropout=self.dropout,
                                          seed=self.topology_seed, **kw), comp
        if self.topology == "erdos_renyi":
            kw.setdefault("seed", self.topology_seed)
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
    local = LocalUpdate(optimizer=optimizer, schedule=schedule,
                        microbatches=config.microbatches, local_steps=config.local_steps,
                        grad_accum_dtype=config.grad_accum_dtype)
    if config.tracker_compressor is not None and config.consensus != "gt":
        raise ValueError("tracker_compressor only applies to consensus='gt' (there is no "
                         f"tracker lane under consensus={config.consensus!r})")
    if config.consensus == "gt":
        consensus = GradientTrackingConsensus(
            topology, compressor, config.gamma, tracker_gamma=config.tracker_gamma,
            tracker_compressor=config.tracker_compressor, packed=config.packed_gossip,
            fused=config.fused_gossip)
    elif config.consensus == "choco":
        consensus = ChocoConsensus(topology, compressor, config.gamma,
                                   packed=config.packed_gossip, fused=config.fused_gossip)
    else:
        raise ValueError(f"unknown consensus {config.consensus!r}; choose choco or gt")
    # the dual's own gossip: a static schedule unwraps to its topology; a
    # time-varying one stays whole and the trainer passes each round's W(t)
    dual_topology = (topology.topology_at(0)
                     if isinstance(topology, TopologySchedule) and topology.is_static
                     else topology)
    if config.robust:
        dual = ProjectedAscent(prior=prior, alpha=config.alpha, eta_lambda=config.eta_lambda,
                               regularizer=dro.make_regularizer(config.regularizer),
                               topology=dual_topology)
    else:
        dual = FrozenPrior(prior=prior)
    return DecentralizedTrainer(loss_fn, num_nodes=m, local=local, dual=dual,
                                consensus=consensus, prior=prior,
                                track_average=config.track_average, config=config,
                                device=device)
