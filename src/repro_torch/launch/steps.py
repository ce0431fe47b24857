"""Step-function builders: the glue between the model zoo and the trainers
(PyTorch port of ``repro.launch.steps``).

``make_trainer(cfg, num_nodes, ...)`` wires an architecture's ``lm_loss``
into a composed AD-GDA :class:`~repro_torch.core.trainer.DecentralizedTrainer`
(paper Algorithm 1) with the reference's keyword defaults;
``make_prefill_step`` / ``make_decode_step`` build the serving entry points
on the consensus model (no node axis).

``abstract_params`` / ``abstract_cache`` / ``abstract_trainer_state`` are
the reference's ``jax.eval_shape`` trees, leaf for leaf (names, shapes,
dtypes), with nothing allocated: tensors on ``torch.device("meta")`` (the
trainer state's on a ``FakeTensorMode``, whose tensors name the trainer's
device).  ``serving_cache`` turns the reference's stacked cache layout into
the port's one dict per layer (views, no copy).
"""
from __future__ import annotations

import torch

from repro_torch.core.adgda import ADGDAConfig, adgda_trainer
from repro_torch.core.compression import Compressor
from repro_torch.core.trainer import DecentralizedTrainer
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig

__all__ = [
    "make_trainer",
    "make_prefill_step",
    "make_decode_step",
    "abstract_params",
    "abstract_cache",
    "abstract_trainer_state",
    "serving_cache",
]

META = torch.device("meta")


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
    """``prefill_step(params, batch, cache=None)``: ``batch`` holds
    ``tokens`` and, for whisper / internvl2, ``frames`` / ``patches``
    (``serve.stub_inputs``); ``cache`` an empty cache to fill (the dry run
    passes one placed on its mesh), else a fresh ``init_cache``."""
    def prefill_step(params, batch, cache=None):
        return T.prefill(params, batch, cfg, cache_len, cache=cache)

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    def decode_step(params, cache, tokens, pos):
        return T.decode_step(params, tokens, cache, pos, cfg)

    return decode_step


def abstract_params(cfg: ModelConfig):
    """The reference's parameter tree (``init_model``'s, stacked pattern
    blocks) as meta tensors."""
    return T.abstract_train_params(cfg)


def _layer_cache(cfg: ModelConfig, kind: str, batch: int, length: int) -> dict:
    """One layer's cache in the reference's layout (whisper's cross K/V
    live apart, under ``cross_kv``)."""
    cache = T._init_layer_cache(cfg, kind, batch, length, META)
    cache.pop("cross_k", None)
    cache.pop("cross_v", None)
    return cache


def abstract_cache(cfg: ModelConfig, batch: int, length: int) -> dict:
    """The reference's ``init_cache`` tree as meta tensors: ``prefix`` /
    ``blocks`` (leaves stacked ``[n_blocks, ...]``) / ``suffix``, as the
    parameters, and whisper's ``cross_kv``, one (k, v) pair per layer."""
    pre, nb, suf = T._pattern_split(cfg)
    p_len = len(cfg.layer_pattern)

    def layer(i):
        return _layer_cache(cfg, cfg.mixer_for_layer(i), batch, length)

    cache: dict = {}
    if pre:
        cache["prefix"] = [layer(i) for i in range(pre)]
    if nb:
        cache["blocks"] = []
        for pos in range(p_len):
            per = [layer(pre + b * p_len + pos) for b in range(nb)]
            cache["blocks"].append({k: torch.stack([c[k] for c in per]) for k in per[0]})
    if suf:
        cache["suffix"] = [layer(pre + nb * p_len + s) for s in range(suf)]
    if cfg.is_encdec:
        shape = (batch, cfg.encoder_context, cfg.num_kv_heads, cfg.hd)
        cache["cross_kv"] = [tuple(torch.empty(shape, dtype=cfg.activation_dtype, device=META)
                                   for _ in range(2)) for _ in range(cfg.num_layers)]
    return cache


def serving_cache(tree: dict, cfg: ModelConfig) -> list:
    """A cache in the reference's layout -> the port's list with one dict per
    layer (``transformer.init_cache``'s): stacked leaves unbind into views of
    the same storage, whisper's ``cross_kv`` pairs become each layer's
    ``cross_k`` / ``cross_v``."""
    pre, nb, suf = T._pattern_split(cfg)
    p_len = len(cfg.layer_pattern)
    layers: list = [None] * cfg.num_layers
    for i, c in enumerate(tree.get("prefix", [])):
        layers[i] = dict(c)
    for pos, stacked in enumerate(tree.get("blocks", [])):
        unbound = {k: v.unbind(0) for k, v in stacked.items()}
        for b in range(nb):
            layers[pre + b * p_len + pos] = {k: v[b] for k, v in unbound.items()}
    for s, c in enumerate(tree.get("suffix", [])):
        layers[pre + nb * p_len + s] = dict(c)
    for layer, (k, v) in zip(layers, tree.get("cross_kv", [])):
        layer.update(cross_k=k, cross_v=v)
    return layers


def abstract_trainer_state(trainer: DecentralizedTrainer, cfg: ModelConfig):
    """``trainer.init`` on the abstract parameters under a ``FakeTensorMode``:
    the node-stacked state's shapes and dtypes, nothing allocated.  Its
    reference-named tree is ``checkpoint.npz.state_tree(state)`` (the
    reference's ``rng`` key has no counterpart: the port's generators are
    not leaves)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode(allow_non_fake_inputs=True):
        params = T._map_tree(abstract_params(cfg), lambda t: torch.empty(
            t.shape, dtype=t.dtype, device=trainer.device))
        return trainer.init(params)


# deprecated alias (pre-refactor name)
abstract_adgda_state = abstract_trainer_state
