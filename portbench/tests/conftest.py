"""Helpers of the benchmark's CPU tests: small models cut from the real
configurations (a dense GELU/MQA model and a MoE model, every kind of layer
kept) and a benchmark written at test time whose cells run through the
harness on the CPU."""
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from portbench import spec  # noqa: E402

torch.set_num_threads(1)


def small_model(base: str, **over) -> dict:
    """A configuration file's ``model`` cut to CPU size, its kinds of
    layer kept."""
    model = dict(spec.load_config(base)["model"])
    model.update(num_layers=3 if model.get("num_experts") else 2, d_model=64, head_dim=16,
                 num_heads=4, num_kv_heads=1 if model["num_kv_heads"] == 1 else 4,
                 d_ff=96, vocab_size=128)
    if model.get("num_experts"):
        model.update(num_experts=8, experts_per_token=2, moe_d_ff=32, num_shared_experts=2)
    model.update(over)
    return model


COMPRESSORS = {"kq4b": ({"spec": "kq4b"}, True),
               "btopk": ({"kind": "block_topk", "fraction": 0.25, "block": 64}, False)}


def write_bench(root: Path, cells: dict, limits: dict | None = None) -> Path:
    """``cells``: name -> (model dict, compressor key, seq).  Writes the
    configurations, the workloads and a BENCHMARK.json under ``root``."""
    (root / "configs").mkdir(parents=True, exist_ok=True)
    (root / "workloads").mkdir(parents=True, exist_ok=True)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"], bench["configs"] = [], []
    for name, (model, comp, seq) in cells.items():
        cfg = f"{name}-config"
        (root / "configs" / f"{cfg}.json").write_text(json.dumps({"name": cfg, "model": model}))
        compressor, fused = COMPRESSORS[comp]
        wl = {"nodes": 4, "batch_per_node": 2, "seq": seq, "topology": "ring",
              "compressor": compressor, "alpha": 0.01, "eta_theta": 0.05, "eta_lambda": 0.01,
              "fused_gossip": fused, "zipf_a": 1.2, "checked_rounds": 3, "pool": 2,
              "why": "a CPU test",
              "limits": limits or {k: 1e-3 for k in
                                   ("loss_gap", "grad_gap", "delta_gap", "hat_gap", "s_gap",
                                    "cerr_gap", "lambda_gap")} | {"bits_gap": 0.01}}
        (root / "workloads" / f"{name}.json").write_text(json.dumps(wl))
        bench["workloads"].append({"name": name, "config": cfg, "traffic": name, "chips": 1,
                                   "why": "a CPU test"})
        bench["configs"].append({"name": cfg, "source": "test", "file": "x", "reduced": [],
                                 "why": "a CPU test"})
    # the test's cells report each quantity once, under its base name
    for kind in ("end_to_end", "per_layer"):
        bench[kind] = [m for m in bench[kind] if "." not in m["name"]]
        for m in bench[kind]:
            m.pop("workloads", None)
    path = root / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    return path
