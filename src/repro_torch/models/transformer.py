"""Model assembly (PyTorch port of ``repro.models.transformer``): every
family of the reference.  A layer's mixer is ``attn``, ``local_attn``,
``rglru`` (the RG-LRU hybrid) or ``mamba2`` (SSD); its FFN is dense or MoE
(``cfg.ffn_is_moe``); whisper's decoder layers add ``norm_cross`` /
``cross`` attention over the encoder output.

Parameters are plain dicts of tensors:

    params = {
      "embed": {"table": [V, d]},          # tied unembedding
      "layers": [layer_0, ..., layer_{n-1}],
      "final_norm": {"scale": [d]},
      "encoder": {"layers": [...], "final_norm": {...}},   # whisper only
    }

The modality frontends are stubs, as in the reference: ``batch`` carries
precomputed ``frames`` [B, encoder_context, d] (whisper's encoder input) or
``patches`` [B, num_patches, d] (internvl2's, spliced over the first
``num_patches`` positions) beside the tokens.

The reference stacks repeated pattern blocks for ``jax.lax.scan``; here the
layers are a Python list in global order (``params_from_jax`` unstacks).
Caches are a list with one dict per layer, every leaf with the batch on
axis 0.

Entry points: ``prefill(params, batch, cfg, cache_len) -> (logits, cache)``
and ``decode_step(params, tokens, cache, pos, cfg) -> (logits, cache)``,
where ``pos`` is an int or a ``[B]`` long tensor (one position per row, as
the reference engine's per-slot vmap gives).  An ``rglru`` layer's cache
is ``{h, conv}`` and a ``mamba2`` layer's ``{ssm, conv}`` (f32 state, the
conv's last inputs), also under ``quantized_kv``, which quantizes
attention caches only.  Whisper's attention caches also hold ``cross_k`` /
``cross_v`` [B, encoder_context, KV, hd], the encoder's K/V computed once at
prefill (never quantized).  Decode routes MoE per batch row (the
reference engine's per-slot vmap), prefill over the whole batch.

Training keeps the reference's own tree, which the decentralized trainer
stacks per node and gossips leaf by leaf (the chunk plan and the bit counts
follow its leaves):

    tree = {
      "embed": {"table": [V, d]},
      "prefix": [layer, ...],                 # first_dense_layers, if any
      "blocks": [stacked_pos_0, ...],         # leaves [n_blocks, ...]
      "suffix": [layer, ...],                 # num_layers % p remainder
      "final_norm": {"scale": [d]},
      "encoder": {"blocks": stacked, "final_norm": ...},   # whisper only
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

from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.moe import apply_moe, init_moe
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
from repro_torch.models.ssm import (
    DT_BIAS_INIT,
    decode_mamba2,
    dims,
    init_mamba2,
    init_mamba2_cache,
    mamba2_scan,
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
    "active_param_count",
    "params_from_jax",
]


def _pattern_split(cfg: ModelConfig) -> tuple[int, int, int]:
    """-> (prefix_layers, n_blocks, suffix_layers), as the reference stacks them."""
    p = len(cfg.layer_pattern)
    body = cfg.num_layers - cfg.first_dense_layers
    return cfg.first_dense_layers, body // p, body % p


# -------------------------------------------------------------------- init
def _init_layer(gen, cfg: ModelConfig, dev, kind: str, moe: bool, cross: bool) -> dict:
    mixer = {"rglru": init_rglru, "mamba2": init_mamba2}.get(kind, init_attention)
    layer = {"norm1": init_norm(cfg, dev), "mixer": mixer(gen, cfg, dev)}
    if cross:
        layer["norm_cross"] = init_norm(cfg, dev)
        layer["cross"] = init_attention(gen, cfg, dev, cross=True)
    if cfg.d_ff > 0 or moe:
        layer["norm2"] = init_norm(cfg, dev)
        layer["ffn"] = init_moe(gen, cfg, dev) if moe else init_mlp(gen, cfg, dev)
    return layer


def init_model(cfg: ModelConfig, *, seed: int = 0, generator: torch.Generator | None = None,
               device="cuda"):
    """Random weights (normal / sqrt(fan_in), ones for norms) from a seeded
    ``torch.Generator`` on ``device``."""
    dev = resolve_device(device)
    gen = generator or torch.Generator(device=dev).manual_seed(seed)
    layers = [_init_layer(gen, cfg, dev, cfg.mixer_for_layer(i), cfg.ffn_is_moe(i), cfg.is_encdec)
              for i in range(cfg.num_layers)]
    params = {"embed": init_embedding(gen, cfg, dev), "layers": layers,
              "final_norm": init_norm(cfg, dev)}
    if cfg.is_encdec:
        params["encoder"] = {
            "layers": [_init_layer(gen, cfg, dev, "attn", False, False)
                       for _ in range(cfg.encoder_layers)],
            "final_norm": init_norm(cfg, dev)}
    return params


def param_count(cfg: ModelConfig) -> int:
    """Parameter count of the model ``init_model`` builds (no allocation)."""
    total = 0

    def add(shape, *_):
        nonlocal total
        total += math.prod(shape)

    _map_specs(_train_specs(cfg), add)
    return total


def active_param_count(cfg: ModelConfig) -> int:
    """Parameters touched per token (MoE: the top-k routed experts and the
    shared ones)."""
    total = param_count(cfg)
    if cfg.num_experts == 0:
        return total
    per_expert = 3 * cfg.d_model * (cfg.moe_d_ff or cfg.d_ff)
    moe_layers = sum(cfg.ffn_is_moe(i) for i in range(cfg.num_layers))
    return total - moe_layers * (cfg.num_experts - cfg.experts_per_token) * per_expert


# ------------------------------------------------------------------- cache
def _layer_cache_len(cfg: ModelConfig, kind: str, length: int) -> int:
    if kind == "local_attn":
        return min(cfg.sliding_window, length)
    if cfg.long_context_window is not None and length > cfg.long_context_window:
        return cfg.long_context_window
    return length


def _init_layer_cache(cfg: ModelConfig, kind: str, batch: int, length: int, dev) -> dict:
    if kind == "rglru":
        return init_rglru_cache(cfg, batch, dev)
    if kind == "mamba2":
        return init_mamba2_cache(cfg, batch, dev)
    c = init_attn_cache(cfg, batch, _layer_cache_len(cfg, kind, length), dev)
    if cfg.is_encdec:
        shape = (batch, cfg.encoder_context, cfg.num_kv_heads, cfg.hd)
        c["cross_k"] = torch.zeros(shape, dtype=cfg.activation_dtype, device=dev)
        c["cross_v"] = torch.zeros(shape, dtype=cfg.activation_dtype, device=dev)
    return c


def init_cache(cfg: ModelConfig, batch: int, length: int, device="cuda"):
    """Decode cache for ``length`` context: one dict per layer."""
    dev = resolve_device(device)
    return [_init_layer_cache(cfg, cfg.mixer_for_layer(i), batch, length, dev)
            for i in range(cfg.num_layers)]


# ----------------------------------------------------------------- forward
def _decode_window(cfg: ModelConfig, kind: str, cache: dict) -> int | None:
    if kind == "local_attn":
        return cfg.sliding_window
    return cache["k"].shape[1] if cfg.long_context_window is not None else None


def _ffn(p, x, cfg: ModelConfig, moe: bool, per_row: bool = False):
    """The layer's FFN on ``norm2(x)`` -> (y, router aux loss)."""
    h = apply_norm(p["norm2"], x)
    if moe:
        return apply_moe(p["ffn"], h, cfg, per_row=per_row)
    return apply_mlp(p["ffn"], h), None


def decode_step(params, tokens, cache, pos, cfg: ModelConfig):
    """One-token decode.  tokens: [B, 1]; pos: int or [B] long (context
    length so far, per row).  Returns (logits [B, 1, V], cache) with the
    cache updated in place.  MoE layers route each row on its own (the
    capacity of one token), as the reference engine's per-slot decode does."""
    x = embed(params["embed"], tokens).to(cfg.activation_dtype)
    pos = row_positions(pos, x.shape[0], x.device)
    for i, (p, c) in enumerate(zip(params["layers"], cache)):
        kind = cfg.mixer_for_layer(i)
        h = apply_norm(p["norm1"], x)
        if kind == "rglru":
            y, _ = decode_rglru(p["mixer"], h, c, cfg)
        elif kind == "mamba2":
            y, _ = decode_mamba2(p["mixer"], h, c, cfg)
        else:
            y, _ = decode_attention(p["mixer"], h, c, pos, cfg,
                                    window=_decode_window(cfg, kind, c))
        x = x + y
        if "cross" in p:
            y, _ = decode_attention(p["cross"], apply_norm(p["norm_cross"], x), c, pos, cfg,
                                    cross_kv=(c["cross_k"], c["cross_v"]))
            x = x + y
        if "ffn" in p:
            x = x + _ffn(p, x, cfg, cfg.ffn_is_moe(i), per_row=True)[0]
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


def _encode(layers, final_norm, frames, cfg: ModelConfig):
    """Whisper's encoder over precomputed frame embeddings (the conv
    frontend is a stub): non-causal self-attention layers, plain attention
    (only causal self-attention takes a kernel, as in the reference)."""
    x = frames.to(cfg.activation_dtype)
    for p in layers:
        x = x + apply_attention(p["mixer"], apply_norm(p["norm1"], x), cfg, causal=False)
        x = x + _ffn(p, x, cfg, False)[0]
    return apply_norm(final_norm, x)


def _fuse_inputs(params, batch, cfg: ModelConfig):
    """Token embedding and the modality inputs -> (x, encoder output or
    None).  internvl2's patches replace the first ``num_patches`` positions,
    as the reference concatenates them."""
    x = embed(params["embed"], batch["tokens"]).to(cfg.activation_dtype)
    enc_out = None
    if cfg.is_encdec:
        enc = params["encoder"]
        enc_out = _encode(enc["layers"], enc["final_norm"], batch["frames"], cfg)
    if cfg.num_patches > 0 and "patches" in batch:
        x = torch.cat([batch["patches"].to(x.dtype), x[:, cfg.num_patches:]], dim=1)
    return x, enc_out


def prefill(params, batch, cfg: ModelConfig, cache_len: int, cache=None):
    """Full forward over the prompt that also returns a primed decode cache.

    batch["tokens"]: [B, S <= cache_len] (and ``frames`` / ``patches`` for
    whisper / internvl2).  Attention layers write the prompt's K/V into their
    caches (whisper's also the encoder's K/V), recurrent layers their final
    state.  MoE layers route all ``B * S`` tokens together, pad rows and
    positions included, as the reference's prefill does.  ``cache``: an
    empty cache of ``init_cache``'s layout to fill in place (the dry run
    places one on its mesh); default a fresh ``init_cache``.  Returns (logits
    [B, S, V], cache).
    """
    tokens = batch["tokens"]
    x, enc_out = _fuse_inputs(params, batch, cfg)
    if cache is None:
        cache = init_cache(cfg, tokens.shape[0], cache_len, device=tokens.device)
    for i, (p, c) in enumerate(zip(params["layers"], cache)):
        kind = cfg.mixer_for_layer(i)
        h = apply_norm(p["norm1"], x)
        if kind in ("rglru", "mamba2"):  # the state after the last prompt token
            if kind == "rglru":
                y, state = apply_rglru(p["mixer"], h, cfg, return_state=True)
            else:
                y, state = mamba2_scan(p["mixer"], h, cfg, return_state=True)
            for name, t in state.items():
                c[name].copy_(t)
        else:
            y, (k, v) = apply_attention(p["mixer"], h, cfg, causal=True,
                                        window=_prefill_window(cfg, kind, cache_len),
                                        return_kv=True)
            _store_prompt(c, k, v)
        x = x + y
        if "cross" in p:
            y, (k, v) = apply_attention(p["cross"], apply_norm(p["norm_cross"], x), cfg,
                                        causal=False, kv_src=enc_out, return_kv=True)
            c["cross_k"].copy_(k)
            c["cross_v"].copy_(v)
            x = x + y
        if "ffn" in p:
            x = x + _ffn(p, x, cfg, cfg.ffn_is_moe(i))[0]
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
    places; whisper's stacked ``encoder.blocks`` unstack into
    ``encoder.layers``.
    """
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
    params = {
        "embed": _map_tree(tree["embed"], lambda a: _to_tensor(a, dev)),
        "layers": layers,
        "final_norm": _map_tree(tree["final_norm"], lambda a: _to_tensor(a, dev)),
    }
    if cfg.is_encdec:
        enc = tree["encoder"]
        params["encoder"] = {
            "layers": [_map_tree(enc["blocks"], lambda a, b=b: _to_tensor(a[b], dev))
                       for b in range(cfg.encoder_layers)],
            "final_norm": _map_tree(enc["final_norm"], lambda a: _to_tensor(a, dev))}
    return params


# ------------------------------------------------------------- training
#: spec inits filled with one value (f32 leaves of the recurrent mixers)
_FILL = {"lamb": LAMB_INIT, "dt_bias": DT_BIAS_INIT}
F32 = torch.float32


def _norm_specs(cfg: ModelConfig) -> dict:
    p = {"scale": ((cfg.d_model,), "ones")}
    if cfg.norm_type == "layernorm":
        p["bias"] = ((cfg.d_model,), "zeros")
    return p


def _mlp_specs(cfg: ModelConfig, f: int) -> dict:
    d = cfg.d_model
    if cfg.mlp_type == "swiglu":
        return {"w_gate": ((d, f), d), "w_up": ((d, f), d), "w_down": ((f, d), f)}
    ffn = {"w1": ((d, f), d), "w2": ((f, d), f)}
    if cfg.use_bias:
        ffn.update(b1=((f,), "zeros"), b2=((d,), "zeros"))
    return ffn


def _attention_specs(cfg: ModelConfig, cross: bool = False) -> dict:
    d, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    p = {"wq": ((d, H, hd), d), "wk": ((d, KV, hd), d), "wv": ((d, KV, hd), d),
         "wo": ((H, hd, d), H * hd)}
    if cfg.use_bias:
        p.update(bq=((H, hd), "zeros"), bk=((KV, hd), "zeros"), bv=((KV, hd), "zeros"),
                 bo=((d,), "zeros"))
    if cfg.qk_norm and not cross:
        p.update(q_norm=((hd,), "ones"), k_norm=((hd,), "ones"))
    return p


def _layer_specs(cfg: ModelConfig, kind: str, moe: bool = False, cross: bool = False) -> dict:
    """One layer's parameters as (shape, fan_in | "ones" | "zeros" | "lamb" |
    "dt_bias"[, dtype]); the dtype defaults to the activation dtype."""
    d = cfg.d_model
    if kind == "rglru":
        dr, W = cfg.rglru_width or d, CONV_WIDTH
        mixer = {"w_gate_branch": ((d, dr), d), "w_in": ((d, dr), d), "conv_w": ((W, dr), W),
                 "conv_b": ((dr,), "zeros"), "w_a": ((dr, dr), dr), "w_x": ((dr, dr), dr),
                 "lamb": ((dr,), "lamb", F32), "w_out": ((dr, d), dr)}
    elif kind == "mamba2":
        di, H, N, conv_ch = dims(cfg)
        W = cfg.ssm_conv_width
        mixer = {"in_proj": ((d, 2 * di + 2 * N + H), d), "conv_w": ((W, conv_ch), W),
                 "conv_b": ((conv_ch,), "zeros"), "A_log": ((H,), "zeros", F32),
                 "D": ((H,), "ones", F32), "dt_bias": ((H,), "dt_bias", F32),
                 "norm_scale": ((di,), "ones"), "out_proj": ((di, d), di)}
    else:
        mixer = _attention_specs(cfg)
    layer = {"norm1": _norm_specs(cfg), "mixer": mixer}
    if cross:
        layer.update(norm_cross=_norm_specs(cfg), cross=_attention_specs(cfg, cross=True))
    if moe:
        E, f = cfg.num_experts, cfg.moe_d_ff or cfg.d_ff
        ffn = {"router": ((d, E), d, F32), "w_gate": ((E, d, f), d), "w_up": ((E, d, f), d),
               "w_down": ((E, f, d), f)}
        if cfg.num_shared_experts > 0:
            ffn["shared"] = _mlp_specs(cfg, f * cfg.num_shared_experts)
        layer.update(norm2=_norm_specs(cfg), ffn=ffn)
    elif cfg.d_ff > 0:
        layer.update(norm2=_norm_specs(cfg), ffn=_mlp_specs(cfg, cfg.d_ff))
    return layer


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and len(x) in (2, 3) and isinstance(x[0], tuple)


def _map_specs(tree, fn):
    if _is_spec(tree):
        return fn(*tree)
    if isinstance(tree, dict):
        return {k: _map_specs(v, fn) for k, v in tree.items()}
    return [_map_specs(v, fn) for v in tree]


def _stacked(spec, n: int):
    return _map_specs(spec, lambda shape, *rest: ((n,) + shape, *rest))


def _train_specs(cfg: ModelConfig) -> dict:
    pre, nb, suf = _pattern_split(cfg)
    p_len = len(cfg.layer_pattern)

    def layer(i):
        return _layer_specs(cfg, cfg.mixer_for_layer(i), cfg.ffn_is_moe(i), cfg.is_encdec)

    specs = {"embed": {"table": ((cfg.vocab_size, cfg.d_model), cfg.d_model)}}
    if pre:
        specs["prefix"] = [layer(i) for i in range(pre)]
    if nb:
        specs["blocks"] = [_stacked(layer(pre + pos), nb) for pos in range(p_len)]
    if suf:
        specs["suffix"] = [layer(pre + nb * p_len + s) for s in range(suf)]
    specs["final_norm"] = _norm_specs(cfg)
    if cfg.is_encdec:
        specs["encoder"] = {"blocks": _stacked(_layer_specs(cfg, "attn"), cfg.encoder_layers),
                            "final_norm": _norm_specs(cfg)}
    return specs


def init_train_params(cfg: ModelConfig, *, seed: int = 0,
                      generator: torch.Generator | None = None, device="cuda"):
    """Random weights in the reference's training tree (normal / sqrt(fan_in),
    ones for norm scales, zeros for biases; the f32 leaves as the reference
    initialises them) from a seeded ``torch.Generator`` on ``device``."""
    dev = resolve_device(device)
    gen = generator or torch.Generator(device=dev).manual_seed(seed)

    def make(shape, init, dtype=cfg.activation_dtype):
        if init == "ones":
            return torch.ones(shape, dtype=dtype, device=dev)
        if init == "zeros":
            return torch.zeros(shape, dtype=dtype, device=dev)
        if init in _FILL:
            return torch.full(shape, _FILL[init], dtype=dtype, device=dev)
        w = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
        return (w * (1.0 / math.sqrt(init))).to(dtype)

    return _map_specs(_train_specs(cfg), make)


def abstract_train_params(cfg: ModelConfig):
    """The training tree as shapes only (meta tensors, nothing allocated)."""
    return _map_specs(_train_specs(cfg), lambda shape, init, dtype=cfg.activation_dtype:
                      torch.empty(shape, dtype=dtype, device="meta"))


def _train_layer(p, x, cfg: ModelConfig, kind: str, moe: bool, enc_out):
    """One layer of the training forward -> (x, router aux loss or None)."""
    h = apply_norm(p["norm1"], x)
    if kind == "rglru":
        x = x + apply_rglru(p["mixer"], h, cfg)
    elif kind == "mamba2":
        x = x + mamba2_scan(p["mixer"], h, cfg, return_state=False)[0]
    else:
        window = cfg.sliding_window if kind == "local_attn" else None
        x = x + apply_attention(p["mixer"], h, cfg, causal=True, window=window)
    if "cross" in p:
        x = x + apply_attention(p["cross"], apply_norm(p["norm_cross"], x), cfg, causal=False,
                                kv_src=enc_out)
    aux = None
    if "ffn" in p:
        y, aux = _ffn(p, x, cfg, moe)
        x = x + y
    return x, aux


def _train_block(x, aux, layers, cfg: ModelConfig, kinds, moes, enc_out):
    for p, kind, moe in zip(layers, kinds, moes):
        x, a = _train_layer(p, x, cfg, kind, moe, enc_out)
        if a is not None:
            aux = aux + a
    return x, aux


def _layer_at(unbound, b: int):
    """Layer ``b`` of a block whose leaves were unbound into per-layer tuples."""
    if isinstance(unbound, dict):
        return {k: _layer_at(v, b) for k, v in unbound.items()}
    return unbound[b]


def forward(params, batch, cfg: ModelConfig):
    """Training/eval forward over the training tree.  batch: {"tokens":
    [B, S]} (and ``frames`` / ``patches``).  Returns (logits [B, S, V],
    aux_loss): the router aux loss summed over the MoE layers, 0 for models
    without them."""
    if cfg.attn_kernel is not None:
        raise NotImplementedError(
            f"training with attn_kernel={cfg.attn_kernel!r}: backward kernels not yet ported "
            f"to repro_torch; see ROADMAP.md"
        )
    pre, nb, suf = _pattern_split(cfg)
    p_len = len(cfg.layer_pattern)
    fused = params
    if cfg.is_encdec:  # the stacked encoder as a list of layers
        enc = _map_tree(params["encoder"]["blocks"], lambda a: a.unbind(0))
        fused = dict(params, encoder={"layers": [_layer_at(enc, b)
                                                 for b in range(cfg.encoder_layers)],
                                      "final_norm": params["encoder"]["final_norm"]})
    x, enc_out = _fuse_inputs(fused, batch, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def run(p, x, aux, i):
        return _train_block(x, aux, [p], cfg, [cfg.mixer_for_layer(i)], [cfg.ffn_is_moe(i)],
                            enc_out)

    for i, p in enumerate(params.get("prefix", [])):
        x, aux = run(p, x, aux, i)
    if nb > 0:
        kinds = [cfg.mixer_for_layer(pre + pos) for pos in range(p_len)]
        moes = [cfg.ffn_is_moe(pre + pos) for pos in range(p_len)]
        # unbind once: its backward stacks the layers' gradients in one pass,
        # where indexing leaf[b] per block would add a full-size zero-padded
        # gradient per layer (quadratic in depth)
        unbound = [_map_tree(stacked, lambda a: a.unbind(0)) for stacked in params["blocks"]]
        for b in range(nb):
            layers = [_layer_at(u, b) for u in unbound]
            # remat: backward recomputes the block's activations
            x, aux = checkpoint(_train_block, x, aux, layers, cfg, kinds, moes, enc_out,
                                use_reentrant=False)
    for s, p in enumerate(params.get("suffix", [])):
        x, aux = run(p, x, aux, pre + nb * p_len + s)
    x = apply_norm(params["final_norm"], x)
    return unembed(params["embed"], x), aux


def lm_loss(params, batch, cfg: ModelConfig, rng=None):
    """Next-token cross entropy (f32), masking pad positions (``loss_mask``)
    and internvl2's patch positions, plus ``router_aux_weight`` times the
    router aux loss."""
    logits, aux = forward(params, batch, cfg)
    targets = batch["tokens"][:, 1:].long()
    logits = logits[:, :-1].float()
    mask = torch.ones(targets.shape, dtype=torch.float32, device=logits.device)
    if cfg.num_patches > 0:
        pos = torch.arange(targets.shape[1], device=logits.device)
        mask = mask * (pos[None, :] >= cfg.num_patches).float()
    if "loss_mask" in batch:
        mask = mask * batch["loss_mask"][:, 1:]
    logz = torch.logsumexp(logits, dim=-1)
    # the gold logit's trailing dim dropped after the difference: a gather
    # from vocab-sharded logits (the dry run's) is a masked pending sum, and
    # its mask fits the gather's own shape
    nll = (logz[..., None] - torch.gather(logits, -1, targets[..., None]))[..., 0] * mask
    loss = nll.sum() / torch.clamp(mask.sum(), min=1.0)
    return loss + cfg.router_aux_weight * aux
