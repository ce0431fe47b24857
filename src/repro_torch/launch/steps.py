"""Step-function builders: the glue between the model zoo and the trainers
(PyTorch port of ``repro.launch.steps``).

``make_trainer(cfg, num_nodes, ...)`` wires an architecture's ``lm_loss``
into a composed AD-GDA :class:`~repro_torch.core.trainer.DecentralizedTrainer`
(paper Algorithm 1) with the reference's keyword defaults;
``make_prefill_step`` / ``make_decode_step`` build the serving entry points
on the consensus model (no node axis).
"""
from __future__ import annotations

from repro_torch.core.adgda import ADGDAConfig, adgda_trainer
from repro_torch.core.compression import Compressor
from repro_torch.core.trainer import DecentralizedTrainer
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig

__all__ = ["make_trainer", "make_prefill_step", "make_decode_step"]


def make_trainer(
    cfg: ModelConfig,
    num_nodes: int,
    *,
    topology: str = "ring",
    topology_schedule: str | None = None,
    dropout: float = 0.0,
    topology_p: float | None = None,
    topology_seed: int = 0,
    fault_spec: str | None = None,
    compressor: str | Compressor = "q4b",
    alpha: float = 0.01,
    eta_theta: float = 0.1,
    eta_lambda: float = 0.01,
    track_average: bool = False,
    packed_gossip: bool = True,
    fused_gossip: bool = False,
    gossip_backend: str = "rolled",
    mesh=None,
    node_axes="data",
    robust: bool = True,
    microbatches: int = 1,
    grad_accum_dtype: str = "float32",
    local_steps: int = 1,
    consensus: str = "choco",
    tracker_gamma: float | None = None,
    tracker_compressor: str | None = None,
    optimizer: str = "sgd",
    schedule: str = "exp",
    lr_decay: float = 1.0,
    warmup: int = 0,
    total_steps: int = 1000,
    momentum: float = 0.0,
    nesterov: bool = False,
    spmd_axis_name=None,
    device="cuda",
) -> DecentralizedTrainer:
    def loss_fn(params, batch, rng):
        return T.lm_loss(params, batch, cfg, rng)

    adgda_cfg = ADGDAConfig(
        num_nodes=num_nodes,
        topology=topology,
        topology_schedule=topology_schedule,
        dropout=dropout,
        topology_p=topology_p,
        topology_seed=topology_seed,
        fault_spec=fault_spec,
        compressor=compressor,
        alpha=alpha,
        eta_theta=eta_theta,
        eta_lambda=eta_lambda,
        track_average=track_average,
        packed_gossip=packed_gossip,
        fused_gossip=fused_gossip,
        gossip_backend=gossip_backend,
        robust=robust,
        microbatches=microbatches,
        grad_accum_dtype=grad_accum_dtype,
        local_steps=local_steps,
        consensus=consensus,
        tracker_gamma=tracker_gamma,
        tracker_compressor=tracker_compressor,
        optimizer=optimizer,
        schedule=schedule,
        lr_decay=lr_decay,
        warmup=warmup,
        total_steps=total_steps,
        momentum=momentum,
        nesterov=nesterov,
        spmd_axis_name=spmd_axis_name,
    )
    return adgda_trainer(adgda_cfg, loss_fn, mesh=mesh, node_axes=node_axes, device=device)


def make_prefill_step(cfg: ModelConfig, cache_len: int):
    """``prefill_step(params, batch)``: ``batch`` holds ``tokens`` and, for
    whisper / internvl2, ``frames`` / ``patches`` (``serve.stub_inputs``)."""
    def prefill_step(params, batch):
        return T.prefill(params, batch, cfg, cache_len)

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    def decode_step(params, cache, tokens, pos):
        return T.decode_step(params, tokens, cache, pos, cfg)

    return decode_step

