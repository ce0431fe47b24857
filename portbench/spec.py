"""The benchmark's data: ``BENCHMARK.json``, a configuration file
(``configs/<config>.json``) and a cell's workload file
(``workloads/<traffic>.json``), found by name, and the frozen layout of the
training parameter tree that the weights are made in.

A configuration file holds the model's sizes as they are run (every key of
the port's ``ModelConfig`` it sets, under ``"model"``) beside its source,
``reduced``, ``assumed`` and the deployment it stands for.  A workload file
holds the trainer's arguments, the nodes, the batch, the sequence, the
compressor, the cell's ``why`` and the limits of its correctness check.
"""
from __future__ import annotations

import json
import math
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

#: the keys every workload file sets: the trainer's arguments, the nodes,
#: the batch, the sequence, the token stream's skew, the rounds checked
#: against the reference, the window's pool of batches, ``why``, ``limits``
WORKLOAD_KEYS = ("nodes", "batch_per_node", "seq", "topology", "compressor", "alpha",
                 "eta_theta", "eta_lambda", "fused_gossip", "zipf_a", "checked_rounds", "pool",
                 "why", "limits")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(bench_path: Path | None = None) -> dict:
    return load_json(bench_path or ROOT / "BENCHMARK.json")


def find_cell(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                   f"choose from {[c['name'] for c in bench['workloads']]}")


def cell_metrics(bench: dict, cell: str, kind: str) -> list[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics the cell reports."""
    return [m for m in bench[kind] if cell in m.get("workloads", [cell])]


def load_config(name: str, data_root: Path | None = None) -> dict:
    return load_json((data_root or HERE) / "configs" / f"{name}.json")


def load_workload(traffic: str, data_root: Path | None = None) -> dict:
    wl = load_json((data_root or HERE) / "workloads" / f"{traffic}.json")
    missing = [k for k in WORKLOAD_KEYS if k not in wl]
    if missing:
        raise KeyError(f"workload {traffic!r} does not set {missing}")
    return wl


def model_config(conf: dict):
    """The port's ``ModelConfig`` from a configuration file."""
    from repro_torch.models.config import ModelConfig

    model = dict(conf["model"])
    for key in ("layer_pattern",):
        if key in model:
            model[key] = tuple(model[key])
    return ModelConfig(**model)


# ---------------------------------------------------------------- leaf layout
def head_dim(m: dict) -> int:
    return m.get("head_dim") or m["d_model"] // m["num_heads"]


def _norm(m: dict) -> dict:
    p = {"scale": ((m["d_model"],), "ones")}
    if m.get("norm_type", "rmsnorm") == "layernorm":
        p["bias"] = ((m["d_model"],), "zeros")
    return p


def _mlp(m: dict, f: int) -> dict:
    d = m["d_model"]
    if m.get("mlp_type", "swiglu") == "swiglu":
        return {"w_gate": ((d, f), d), "w_up": ((d, f), d), "w_down": ((f, d), f)}
    p = {"w1": ((d, f), d), "w2": ((f, d), f)}
    if m.get("use_bias"):
        p.update(b1=((f,), "zeros"), b2=((d,), "zeros"))
    return p


def _attention(m: dict) -> dict:
    d, H, KV, hd = m["d_model"], m["num_heads"], m["num_kv_heads"], head_dim(m)
    p = {"wq": ((d, H, hd), d), "wk": ((d, KV, hd), d), "wv": ((d, KV, hd), d),
         "wo": ((H, hd, d), H * hd)}
    if m.get("use_bias"):
        p.update(bq=((H, hd), "zeros"), bk=((KV, hd), "zeros"), bv=((KV, hd), "zeros"),
                 bo=((d,), "zeros"))
    if m.get("qk_norm"):
        p.update(q_norm=((hd,), "ones"), k_norm=((hd,), "ones"))
    return p


def is_moe_layer(m: dict, i: int) -> bool:
    return m.get("num_experts", 0) > 0 and i >= m.get("first_dense_layers", 0)


def _layer(m: dict, moe: bool) -> dict:
    layer = {"norm1": _norm(m), "mixer": _attention(m), "norm2": _norm(m)}
    if moe:
        d, E, f = m["d_model"], m["num_experts"], m.get("moe_d_ff") or m["d_ff"]
        ffn = {"router": ((d, E), d, "float32"), "w_gate": ((E, d, f), d),
               "w_up": ((E, d, f), d), "w_down": ((E, f, d), f)}
        if m.get("num_shared_experts", 0) > 0:
            ffn["shared"] = _mlp(m, f * m["num_shared_experts"])
        layer["ffn"] = ffn
    else:
        layer["ffn"] = _mlp(m, m["d_ff"])
    return layer


def _stack(tree, n: int):
    if isinstance(tree, dict):
        return {k: _stack(v, n) for k, v in tree.items()}
    shape, *rest = tree
    return ((n,) + shape, *rest)


def tree_specs(m: dict) -> dict:
    """The training tree of an all-attention dense or MoE model: ``embed``,
    the leading dense layers under ``prefix``, the rest stacked under
    ``blocks[0]`` (leaves ``[n_blocks, ...]``), ``final_norm``.  Each leaf
    is ``(shape, fan_in | "ones" | "zeros"[, dtype])``."""
    if tuple(m.get("layer_pattern", ("attn",))) != ("attn",):
        raise ValueError("the benchmark's layout covers all-attention models only")
    pre = m.get("first_dense_layers", 0)
    body = m["num_layers"] - pre
    tree = {"embed": {"table": ((m["vocab_size"], m["d_model"]), m["d_model"])}}
    if pre:
        tree["prefix"] = [_layer(m, False) for _ in range(pre)]
    if body:
        tree["blocks"] = [_stack(_layer(m, is_moe_layer(m, pre)), body)]
    tree["final_norm"] = _norm(m)
    return tree


def leaf_list(m: dict) -> list[tuple[str, tuple, object, str]]:
    """``(path, shape, init, dtype)`` of every leaf, in the flatten order
    the port's trainer gossips them (dict keys sorted, lists in order)."""
    out = []

    def walk(t, path):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], f"{path}.{k}" if path else k)
        elif isinstance(t, list):
            for i, v in enumerate(t):
                walk(v, f"{path}.{i}")
        else:
            shape, init, *dt = t
            out.append((path, tuple(shape), init, dt[0] if dt else m.get("dtype", "bfloat16")))

    walk(tree_specs(m), "")
    return out


def param_total(m: dict) -> int:
    return sum(math.prod(shape) for _, shape, _, _ in leaf_list(m))


def nest(flat: dict):
    """``{"a.b.0.c": x}`` -> nested dicts and lists, as the port's tree."""
    root: dict = {}
    for path, value in flat.items():
        *keys, last = path.split(".")
        node = root
        for k in keys:
            node = node.setdefault(k, {})
        node[last] = value

    def fix(t):
        if isinstance(t, dict):
            if t and all(k.isdigit() for k in t):
                return [fix(t[str(i)]) for i in range(len(t))]
            return {k: fix(v) for k, v in t.items()}
        return t

    return fix(root)


def paths_of(tree) -> list[tuple[str, object]]:
    """``(path, leaf)`` of a nested tree, in :func:`leaf_list`'s order."""
    out = []

    def walk(t, path):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], f"{path}.{k}" if path else k)
        elif isinstance(t, (list, tuple)):
            for i, v in enumerate(t):
                walk(v, f"{path}.{i}")
        elif t is not None:
            out.append((path, t))

    walk(tree, "")
    return out
