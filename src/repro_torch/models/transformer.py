"""Model assembly (PyTorch port of ``repro.models.transformer``): dense,
``local_attn`` and ``rglru`` (the RG-LRU hybrid) layers.

Parameters are plain dicts of tensors:

    params = {
      "embed": {"table": [V, d]},          # tied unembedding
      "layers": [layer_0, ..., layer_{n-1}],
      "final_norm": {"scale": [d]},
    }

The reference stacks repeated pattern blocks for ``jax.lax.scan``; here the
layers are a Python list in global order (``params_from_jax`` unstacks).
Caches are a list with one dict per layer, every leaf with the batch on
axis 0.

Entry points: ``prefill(params, batch, cfg, cache_len) -> (logits, cache)``
and ``decode_step(params, tokens, cache, pos, cfg) -> (logits, cache)``,
where ``pos`` is an int or a ``[B]`` long tensor (one position per row, as
the reference engine's per-slot vmap gives).  An ``rglru`` layer's cache
is ``{h, conv}`` (f32 state, the conv's last inputs), also under
``quantized_kv``, which quantizes attention caches only.  MoE, mamba2,
encoder-decoder and VLM families raise ``NotImplementedError``.

Training keeps the reference's own tree, which the decentralized trainer
stacks per node and gossips leaf by leaf (the chunk plan and the bit counts
follow its leaves):

    tree = {
      "embed": {"table": [V, d]},
      "prefix": [layer, ...],                 # first_dense_layers, if any
      "blocks": [stacked_pos_0, ...],         # leaves [n_blocks, ...]
      "suffix": [layer, ...],                 # num_layers % p remainder
      "final_norm": {"scale": [d]},
    }

``init_train_params`` builds it, ``forward`` / ``lm_loss`` run it (layer
``b`` of a block reads the views ``leaf[b]``; each block is rematerialised
with ``torch.utils.checkpoint`` as the reference wraps it in
``jax.checkpoint``), and ``params_from_jax`` unstacks it for serving.
Training attention is the plain ``_attend`` with autograd: a training call
with ``attn_kernel`` set raises until the attention kernels have backward
kernels.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import configs
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    apply_attention,
    apply_mlp,
    apply_norm,
    decode_attention,
    embed,
    init_attention,
    init_attn_cache,
    init_embedding,
    init_mlp,
    init_norm,
    row_positions,
    unembed,
)
from repro_torch.models.rglru import (
    CONV_WIDTH,
    LAMB_INIT,
    apply_rglru,
    decode_rglru,
    init_rglru,
    init_rglru_cache,
)

__all__ = [
    "abstract_train_params",
    "forward",
    "init_model",
    "init_train_params",
    "lm_loss",
    "init_cache",
    "prefill",
    "decode_step",
    "param_count",
    "params_from_jax",
]


def _check_supported(cfg: ModelConfig) -> None:
    unported = []
    if cfg.num_experts > 0:
        unported.append("MoE")
    mixers = {cfg.mixer_for_layer(i) for i in range(cfg.num_layers)}
    unported += sorted(mixers & {"mamba2"})
    if cfg.is_encdec:
        unported.append("encoder-decoder")
    if cfg.num_patches > 0:
        unported.append("VLM")
    if unported:
        ported = ", ".join(configs.NAMES[n] for n in configs.PORTED)
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(unported)} not yet ported to repro_torch; see ROADMAP.md "
            f"(ported: {ported}; not yet: {', '.join(configs.waiting())})"
        )


def _pattern_split(cfg: ModelConfig) -> tuple[int, int, int]:
    """-> (prefix_layers, n_blocks, suffix_layers), as the reference stacks them."""
    p = len(cfg.layer_pattern)
    body = cfg.num_layers - cfg.first_dense_layers
    return cfg.first_dense_layers, body // p, body % p


# -------------------------------------------------------------------- init
def init_model(cfg: ModelConfig, *, seed: int = 0, generator: torch.Generator | None = None,
               device="cuda"):
    """Random weights (normal / sqrt(fan_in), ones for norms) from a seeded
    ``torch.Generator`` on ``device``."""
    _check_supported(cfg)
    dev = resolve_device(device)
    gen = generator or torch.Generator(device=dev).manual_seed(seed)
    layers = []
    for i in range(cfg.num_layers):
        mixer = init_rglru if cfg.mixer_for_layer(i) == "rglru" else init_attention
        layer = {"norm1": init_norm(cfg, dev), "mixer": mixer(gen, cfg, dev)}
        if cfg.d_ff > 0:
            layer["norm2"] = init_norm(cfg, dev)
            layer["ffn"] = init_mlp(gen, cfg, dev)
        layers.append(layer)
    return {"embed": init_embedding(gen, cfg, dev), "layers": layers,
            "final_norm": init_norm(cfg, dev)}


def param_count(cfg: ModelConfig) -> int:
    """Parameter count of the model ``init_model`` builds (no allocation)."""
    total = 0

    def add(shape, init):
        nonlocal total
        total += math.prod(shape)

    _map_specs(_train_specs(cfg), add)
    return total


# ------------------------------------------------------------------- cache
def _layer_cache_len(cfg: ModelConfig, kind: str, length: int) -> int:
    if kind == "local_attn":
        return min(cfg.sliding_window, length)
    if cfg.long_context_window is not None and length > cfg.long_context_window:
        return cfg.long_context_window
    return length


def init_cache(cfg: ModelConfig, batch: int, length: int, device="cuda"):
    """Decode cache for ``length`` context: one dict per layer."""
    _check_supported(cfg)
    dev = resolve_device(device)
    cache = []
    for i in range(cfg.num_layers):
        kind = cfg.mixer_for_layer(i)
        cache.append(init_rglru_cache(cfg, batch, dev) if kind == "rglru" else
                     init_attn_cache(cfg, batch, _layer_cache_len(cfg, kind, length), dev))
    return cache


# ----------------------------------------------------------------- forward
def _decode_window(cfg: ModelConfig, kind: str, cache: dict) -> int | None:
    if kind == "local_attn":
        return cfg.sliding_window
    return cache["k"].shape[1] if cfg.long_context_window is not None else None


def decode_step(params, tokens, cache, pos, cfg: ModelConfig):
    """One-token decode.  tokens: [B, 1]; pos: int or [B] long (context
    length so far, per row).  Returns (logits [B, 1, V], cache) with the
    cache updated in place."""
    x = embed(params["embed"], tokens).to(cfg.activation_dtype)
    pos = row_positions(pos, x.shape[0], x.device)
    for i, (p, c) in enumerate(zip(params["layers"], cache)):
        kind = cfg.mixer_for_layer(i)
        h = apply_norm(p["norm1"], x)
        if kind == "rglru":
            y, _ = decode_rglru(p["mixer"], h, c, cfg)
        else:
            y, _ = decode_attention(p["mixer"], h, c, pos, cfg,
                                    window=_decode_window(cfg, kind, c))
        x = x + y
        if "ffn" in p:
            x = x + apply_mlp(p["ffn"], apply_norm(p["norm2"], x))
    x = apply_norm(params["final_norm"], x)
    return unembed(params["embed"], x), cache


def _prefill_window(cfg: ModelConfig, kind: str, cache_len: int) -> int | None:
    if kind == "local_attn":
        return cfg.sliding_window
    lcw = cfg.long_context_window
    return lcw if lcw is not None and cache_len > lcw else None


def _store_prompt(c: dict, k: torch.Tensor, v: torch.Tensor) -> None:
    """Write prompt K/V [B, S, KV, hd] into a fresh layer cache, in place.

    Quantized caches store int8 values and scales.  A prompt longer than the
    ring buffer keeps its last L keys, rolled by S % L so that absolute
    position p sits in slot p % L.
    """
    S, L = k.shape[1], c["k"].shape[1]
    if "k_scale" in c:
        (k, k_sc), (v, v_sc) = ops.quantize_kv(k), ops.quantize_kv(v)
        leaves = {"k": k, "v": v, "k_scale": k_sc, "v_scale": v_sc}
    else:
        leaves = {"k": k, "v": v}
    for name, src in leaves.items():
        dst = c[name]
        if S <= L:
            dst[:, :S] = src.to(dst.dtype)
        else:
            dst.copy_(torch.roll(src[:, S - L:].to(dst.dtype), S % L, dims=1))


def prefill(params, batch, cfg: ModelConfig, cache_len: int):
    """Full forward over the prompt that also returns a primed decode cache.

    batch["tokens"]: [B, S <= cache_len].  Attention layers write the
    prompt's K/V into their caches, recurrent layers their final state.
    Returns (logits [B, S, V], cache).
    """
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = embed(params["embed"], tokens).to(cfg.activation_dtype)
    cache = init_cache(cfg, B, cache_len, device=tokens.device)
    for i, (p, c) in enumerate(zip(params["layers"], cache)):
        kind = cfg.mixer_for_layer(i)
        h = apply_norm(p["norm1"], x)
        if kind == "rglru":  # the state after the last prompt token
            y, state = apply_rglru(p["mixer"], h, cfg, return_state=True)
            for name, t in state.items():
                c[name].copy_(t)
        else:
            y, (k, v) = apply_attention(p["mixer"], h, cfg, causal=True,
                                        window=_prefill_window(cfg, kind, cache_len),
                                        return_kv=True)
            _store_prompt(c, k, v)
        x = x + y
        if "ffn" in p:
            x = x + apply_mlp(p["ffn"], apply_norm(p["norm2"], x))
    x = apply_norm(params["final_norm"], x)
    return unembed(params["embed"], x), cache


# -------------------------------------------------------- reference params
def _to_tensor(arr, device) -> torch.Tensor:
    """numpy (or tensor) leaf -> tensor on ``device``; bf16 numpy leaves
    (ml_dtypes ``bfloat16``, or the 2-byte void type ``np.load`` gives
    without ml_dtypes) are reinterpreted through int16, so ml_dtypes is not
    needed."""
    if isinstance(arr, torch.Tensor):
        return arr.to(device)
    arr = np.array(arr)  # a writable, contiguous copy
    if arr.dtype.itemsize == 2 and (arr.dtype.kind == "V" or arr.dtype.name == "bfloat16"):
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device)


def _map_tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_tree(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_tree(v, fn) for v in tree]
    return fn(tree)


def params_from_jax(tree, cfg: ModelConfig, device="cuda"):
    """The reference's parameter tree (leaves as numpy arrays, or the
    training tree's tensors) -> the port's serving layout.

    Stacked ``blocks[pos]`` leaves [n_blocks, ...] unstack into global layer
    ``pre + b * p_len + pos``; ``prefix`` and ``suffix`` layers keep their
    places.
    """
    _check_supported(cfg)
    dev = resolve_device(device)
    want = (cfg.vocab_size, cfg.d_model)
    if tuple(np.shape(tree["embed"]["table"])) != want:
        raise ValueError(f"embed.table shape {np.shape(tree['embed']['table'])} != {want} "
                         f"of {cfg.name}: the checkpoint is of another model")
    pre, nb, suf = _pattern_split(cfg)
    p_len = len(cfg.layer_pattern)
    layers: list = [None] * cfg.num_layers
    for i, p in enumerate(tree.get("prefix", [])):
        layers[i] = _map_tree(p, lambda a: _to_tensor(a, dev))
    if nb > 0:
        for pos, stacked in enumerate(tree["blocks"]):
            for b in range(nb):
                layers[pre + b * p_len + pos] = _map_tree(stacked, lambda a, b=b: _to_tensor(a[b], dev))
    for s, p in enumerate(tree.get("suffix", [])):
        layers[pre + nb * p_len + s] = _map_tree(p, lambda a: _to_tensor(a, dev))
    return {
        "embed": _map_tree(tree["embed"], lambda a: _to_tensor(a, dev)),
        "layers": layers,
        "final_norm": _map_tree(tree["final_norm"], lambda a: _to_tensor(a, dev)),
    }


# ------------------------------------------------------------- training
def _layer_specs(cfg: ModelConfig, kind: str) -> dict:
    """One layer's parameters as (shape, fan_in | "ones" | "zeros" | "lamb")."""
    d, H, KV, hd, f = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd, cfg.d_ff

    def norm():
        p = {"scale": ((d,), "ones")}
        if cfg.norm_type == "layernorm":
            p["bias"] = ((d,), "zeros")
        return p

    if kind == "rglru":
        dr, W = cfg.rglru_width or d, CONV_WIDTH
        mixer = {"w_gate_branch": ((d, dr), d), "w_in": ((d, dr), d), "conv_w": ((W, dr), W),
                 "conv_b": ((dr,), "zeros"), "w_a": ((dr, dr), dr), "w_x": ((dr, dr), dr),
                 "lamb": ((dr,), "lamb"), "w_out": ((dr, d), dr)}
    else:
        mixer = {"wq": ((d, H, hd), d), "wk": ((d, KV, hd), d), "wv": ((d, KV, hd), d),
                 "wo": ((H, hd, d), H * hd)}
        if cfg.use_bias:
            mixer.update(bq=((H, hd), "zeros"), bk=((KV, hd), "zeros"),
                         bv=((KV, hd), "zeros"), bo=((d,), "zeros"))
        if cfg.qk_norm:
            mixer.update(q_norm=((hd,), "ones"), k_norm=((hd,), "ones"))
    layer = {"norm1": norm(), "mixer": mixer}
    if f > 0:
        if cfg.mlp_type == "swiglu":
            ffn = {"w_gate": ((d, f), d), "w_up": ((d, f), d), "w_down": ((f, d), f)}
        else:
            ffn = {"w1": ((d, f), d), "w2": ((f, d), f)}
            if cfg.use_bias:
                ffn.update(b1=((f,), "zeros"), b2=((d,), "zeros"))
        layer.update(norm2=norm(), ffn=ffn)
    return layer


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and len(x) == 2 and isinstance(x[0], tuple)


def _map_specs(tree, fn):
    if _is_spec(tree):
        return fn(*tree)
    if isinstance(tree, dict):
        return {k: _map_specs(v, fn) for k, v in tree.items()}
    return [_map_specs(v, fn) for v in tree]


def _train_specs(cfg: ModelConfig) -> dict:
    _check_supported(cfg)
    pre, nb, suf = _pattern_split(cfg)
    p_len = len(cfg.layer_pattern)

    def layer(i):
        return _layer_specs(cfg, cfg.mixer_for_layer(i))

    specs = {"embed": {"table": ((cfg.vocab_size, cfg.d_model), cfg.d_model)}}
    if pre:
        specs["prefix"] = [layer(i) for i in range(pre)]
    if nb:
        specs["blocks"] = [_map_specs(layer(pre + pos), lambda shape, init: ((nb,) + shape, init))
                           for pos in range(p_len)]
    if suf:
        specs["suffix"] = [layer(pre + nb * p_len + s) for s in range(suf)]
    specs["final_norm"] = {"scale": ((cfg.d_model,), "ones")}
    if cfg.norm_type == "layernorm":
        specs["final_norm"]["bias"] = ((cfg.d_model,), "zeros")
    return specs


def init_train_params(cfg: ModelConfig, *, seed: int = 0,
                      generator: torch.Generator | None = None, device="cuda"):
    """Random weights in the reference's training tree (normal / sqrt(fan_in),
    ones for norm scales, zeros for biases) from a seeded ``torch.Generator``
    on ``device``."""
    dev = resolve_device(device)
    gen = generator or torch.Generator(device=dev).manual_seed(seed)
    dt = cfg.activation_dtype

    def make(shape, init):
        if init == "ones":
            return torch.ones(shape, dtype=dt, device=dev)
        if init == "zeros":
            return torch.zeros(shape, dtype=dt, device=dev)
        if init == "lamb":  # the RG-LRU's f32 decay parameter
            return torch.full(shape, LAMB_INIT, dtype=torch.float32, device=dev)
        w = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
        return (w * (1.0 / math.sqrt(init))).to(dt)

    return _map_specs(_train_specs(cfg), make)


def abstract_train_params(cfg: ModelConfig):
    """The training tree as shapes only (meta tensors, nothing allocated)."""
    dt = cfg.activation_dtype
    return _map_specs(_train_specs(cfg), lambda shape, init: torch.empty(
        shape, dtype=torch.float32 if init == "lamb" else dt, device="meta"))


def _train_layer(p, x, cfg: ModelConfig, kind: str):
    h = apply_norm(p["norm1"], x)
    if kind == "rglru":
        x = x + apply_rglru(p["mixer"], h, cfg)
    else:
        window = cfg.sliding_window if kind == "local_attn" else None
        x = x + apply_attention(p["mixer"], h, cfg, causal=True, window=window)
    if "ffn" in p:
        x = x + apply_mlp(p["ffn"], apply_norm(p["norm2"], x))
    return x


def _train_block(x, layers, cfg: ModelConfig, kinds):
    for p, kind in zip(layers, kinds):
        x = _train_layer(p, x, cfg, kind)
    return x


def _layer_at(unbound, b: int):
    """Layer ``b`` of a block whose leaves were unbound into per-layer tuples."""
    if isinstance(unbound, dict):
        return {k: _layer_at(v, b) for k, v in unbound.items()}
    return unbound[b]


def forward(params, batch, cfg: ModelConfig):
    """Training/eval forward over the training tree.  batch: {"tokens":
    [B, S]}.  Returns (logits [B, S, V], aux_loss), aux 0 for dense models."""
    if cfg.attn_kernel is not None:
        raise NotImplementedError(
            f"training with attn_kernel={cfg.attn_kernel!r}: backward kernels not yet ported "
            f"to repro_torch; see ROADMAP.md"
        )
    _check_supported(cfg)
    pre, nb, suf = _pattern_split(cfg)
    p_len = len(cfg.layer_pattern)
    x = embed(params["embed"], batch["tokens"]).to(cfg.activation_dtype)
    for i, p in enumerate(params.get("prefix", [])):
        x = _train_layer(p, x, cfg, cfg.mixer_for_layer(i))
    if nb > 0:
        kinds = [cfg.mixer_for_layer(pre + pos) for pos in range(p_len)]
        # unbind once: its backward stacks the layers' gradients in one pass,
        # where indexing leaf[b] per block would add a full-size zero-padded
        # gradient per layer (quadratic in depth)
        unbound = [_map_tree(stacked, lambda a: a.unbind(0)) for stacked in params["blocks"]]
        for b in range(nb):
            layers = [_layer_at(u, b) for u in unbound]
            # remat: backward recomputes the block's activations
            x = checkpoint(_train_block, x, layers, cfg, kinds, use_reentrant=False)
    for s, p in enumerate(params.get("suffix", [])):
        x = _train_layer(p, x, cfg, cfg.mixer_for_layer(pre + nb * p_len + s))
    x = apply_norm(params["final_norm"], x)
    return unembed(params["embed"], x), torch.zeros((), dtype=torch.float32, device=x.device)


def lm_loss(params, batch, cfg: ModelConfig, rng=None):
    """Next-token cross entropy (f32), masking pad positions (``loss_mask``)."""
    logits, aux = forward(params, batch, cfg)
    targets = batch["tokens"][:, 1:].long()
    logits = logits[:, :-1].float()
    mask = torch.ones(targets.shape, dtype=torch.float32, device=logits.device)
    if "loss_mask" in batch:
        mask = mask * batch["loss_mask"][:, 1:]
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None])[..., 0]
    nll = (logz - gold) * mask
    loss = nll.sum() / torch.clamp(mask.sum(), min=1.0)
    return loss + cfg.router_aux_weight * aux
