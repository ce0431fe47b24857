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
consensus, microbatches or local steps, and wire faults (``fault_spec``: the
cached union round with digests and resync; the lambda gossip rides the
same faulted messages), and the ``ppermute`` backend (``mesh=``: each
``torch.distributed`` rank trains its block of the nodes, and only
compressed payloads travel between neighbours; the lambda gossip rides the
same sends).  :class:`ADGDA` is the reference's deprecated shim over it.
"""
from __future__ import annotations

import dataclasses
import warnings

import numpy as np

from repro_torch.core import dro
from repro_torch.core.compression import Compressor, make_compressor
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
    TrainerState,
)
from repro_torch.optim import adam, make_schedule, sgd

__all__ = ["ADGDAConfig", "ADGDAState", "ADGDA", "adgda_trainer"]

# Deprecated alias, as the reference's: the composed trainer's state replaced
# the monolithic ADGDAState
ADGDAState = TrainerState


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
    gossip_backend: str = "rolled"  # "rolled" (one process) or "ppermute" (needs a mesh)
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
    fault_spec: str | None = None  # wire faults, e.g. "drop:0.05,corrupt:0.01,stale:2"
    spmd_axis_name: tuple | str | None = None  # no meaning here (nodes are rows, not a vmap)
    optimizer: str = "sgd"  # "sgd" (momentum/nesterov) or "adam"
    schedule: str = "exp"  # "const" | "exp" | "cosine"
    warmup: int = 0
    total_steps: int = 1000
    nesterov: bool = False

    def check_ported(self, mesh=None, node_axes="data") -> None:
        """Raise for a setting the port cannot run: an unknown backend,
        ``ppermute`` without a mesh, a mesh of several ranks on the rolled
        backend, or a node count the mesh's ranks do not divide."""
        if self.gossip_backend not in ("rolled", "ppermute"):
            raise ValueError(f"unknown gossip backend {self.gossip_backend!r}; choose rolled "
                             "or ppermute")
        if self.gossip_backend == "ppermute" and mesh is None:
            raise ValueError("backend='ppermute' requires a mesh (see "
                             "launch.mesh.make_node_mesh)")
        if mesh is not None:
            from repro_torch.core.exchange import node_mesh_info

            node_mesh_info(mesh, node_axes, self.num_nodes)

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
    prior) -- same wire, same oracle.  ``mesh`` / ``node_axes`` place the
    nodes for ``gossip_backend="ppermute"`` (``launch.mesh``): the model
    consensus and the lambda gossip then run on the ranks, on the mesh's
    device."""
    config.check_ported(mesh, node_axes)
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
    wire = dict(backend=config.gossip_backend, mesh=mesh, node_axes=node_axes,
                faults=config.fault_spec)
    if config.consensus == "gt":
        consensus = GradientTrackingConsensus(
            topology, compressor, config.gamma, tracker_gamma=config.tracker_gamma,
            tracker_compressor=config.tracker_compressor, packed=config.packed_gossip,
            fused=config.fused_gossip, **wire)
    elif config.consensus == "choco":
        consensus = ChocoConsensus(topology, compressor, config.gamma,
                                   packed=config.packed_gossip, fused=config.fused_gossip,
                                   **wire)
    else:
        raise ValueError(f"unknown consensus {config.consensus!r}; choose choco or gt")
    # the dual's own gossip: a static schedule unwraps to its topology; a
    # time-varying one stays whole and the trainer passes each round's W(t)
    dual_topology = (topology.topology_at(0)
                     if isinstance(topology, TopologySchedule) and topology.is_static
                     else topology)
    if config.robust:
        # on the ppermute backend, or under faults, the lambda gossip rides
        # the consensus's own sends (its faulted messages)
        wire_dual = config.gossip_backend == "ppermute" or consensus.faults is not None
        dual = ProjectedAscent(prior=prior, alpha=config.alpha, eta_lambda=config.eta_lambda,
                               regularizer=dro.make_regularizer(config.regularizer),
                               topology=dual_topology,
                               mix_fn=consensus.wire_mix if wire_dual else None)
    else:
        dual = FrozenPrior(prior=prior)
    return DecentralizedTrainer(loss_fn, num_nodes=m, local=local, dual=dual,
                                consensus=consensus, prior=prior,
                                track_average=config.track_average, config=config,
                                device=device, mesh=mesh)


class ADGDA(DecentralizedTrainer):
    """Deprecated shim: the pre-refactor monolithic trainer's signature.

    ``ADGDA(config, loss_fn, prior)`` composes a :class:`DecentralizedTrainer`
    (see :func:`adgda_trainer`) on ``device``; ``init`` / ``step`` /
    ``network_mean`` / ``bits_per_round`` behave identically.
    """

    def __init__(self, config: ADGDAConfig, loss_fn: LossFn, prior=None, *, device="cuda"):
        warnings.warn(
            "repro.core.ADGDA is deprecated; compose a trainer with "
            "repro.core.adgda.adgda_trainer(config, loss_fn) instead",
            DeprecationWarning,
            stacklevel=2,
        )
        self._init_as(adgda_trainer(config, loss_fn, prior, device=device))
        self.regularizer = dro.make_regularizer(config.regularizer)
