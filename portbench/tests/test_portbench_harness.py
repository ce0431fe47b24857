"""The benchmark as data: every cell, configuration and metric of
BENCHMARK.json loads, a cell written at test time runs through the harness
with no other file edited, the result line has its keys in order, and
nothing the harness runs imports JAX or the JAX package."""
import ast
import json
import math
from pathlib import Path

import pytest
import torch

from conftest import ROOT, small_model, write_bench
from portbench import harness, spec
from portbench.metrics import reader

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [c["name"] for c in BENCH["workloads"]]


def test_benchmark_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"][1].startswith("portbench/")
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names)) and "setup_s" in names
    for m in BENCH["per_layer"]:
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_loads(cell):
    c = spec.find_cell(BENCH, cell)
    conf = spec.load_config(c["config"])
    wl = spec.load_workload(c["traffic"])
    assert conf["source"] == next(x["source"] for x in BENCH["configs"]
                                  if x["name"] == c["config"])
    assert wl["why"] == c["why"] and len(c["why"]) <= 200
    assert set(wl["limits"]) >= {"loss_gap", "grad_gap", "delta_gap", "bits_gap"}
    spec.model_config(conf)  # the port's ModelConfig takes every key
    assert spec.cell_metrics(BENCH, cell, "end_to_end")
    assert spec.cell_metrics(BENCH, cell, "per_layer")


@pytest.mark.parametrize("name", [m["name"] for m in BENCH["per_layer"]])
def test_every_metric_has_a_reader(name):
    read = reader(name)
    blank = harness.Traced(None, 2, 0.0, 0, 0.0, 0.0, None, False)
    assert read(blank) is None  # nothing to read: the metric is left out


@pytest.mark.parametrize("conf", [c["name"] for c in BENCH["configs"]])
def test_layout_matches_the_port(conf):
    from repro_torch.models import transformer as T

    model = spec.load_config(conf)["model"]
    from portbench.weights import check_layout

    check_layout(model, T.abstract_train_params(spec.model_config({"model": model})))


def _run(capsys, root, bench_path, cell, seed=2**31 + 11, trace=0):
    rc = harness.main(["--workload", cell, "--seed", str(seed), "--seconds", "0.2", "--trace",
                       str(trace)], device="cpu", bench_path=bench_path, data_root=root)
    out = capsys.readouterr()
    return rc, json.loads(out.out.strip().splitlines()[-1]), out.err


def test_a_cell_written_at_test_time_runs(tmp_path, capsys):
    model = small_model("granite-20b", dtype="float32")
    bench_path = write_bench(tmp_path, {"new.cell": (model, "kq4b", 16)})
    rc, line, err = _run(capsys, tmp_path, bench_path, "new.cell")
    assert rc == 0
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    assert set(line["metrics"]) == {"train_tokens_per_s", "setup_s"}
    assert all(set(v) == {"value", "unit"} for v in line["metrics"].values())
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    tail = err.strip().splitlines()[-len(line["checks"]):]
    assert [t.split()[1] for t in tail] == list(line["checks"])
    assert all(" limit " in t for t in tail)


def test_traced_line_on_the_cpu_leaves_device_metrics_out(tmp_path, capsys):
    model = small_model("granite-20b", dtype="float32")
    bench_path = write_bench(tmp_path, {"new.cell": (model, "kq4b", 16)})
    rc, line, _ = _run(capsys, tmp_path, bench_path, "new.cell", trace=1)
    assert rc == 0 and line["correct"] is True
    # no device events on the CPU: only the meter's count is read
    assert set(line["metrics"]) == {"bits_per_round"}


def test_no_card_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = harness.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "repro_torch_like", types.ModuleType("repro_torch_like"))
    monkeypatch.delitem(sys.modules, "repro", raising=False)
    assert "repro" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core", types.ModuleType("repro.core"))
    assert harness.forbidden_modules() == ["repro"]


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(p.relative_to(ROOT).as_posix()
                                        for p in (ROOT / "portbench").rglob("*.py")))
def test_no_jax_nor_jax_package_imported(path):
    names = _imports(ROOT / path)
    assert not names & set(harness.FORBIDDEN)
    if path.startswith("portbench/reference/"):
        assert "repro_torch" not in names  # the reference takes nothing of the port


def test_whole_run_leaves_no_forbidden_module(tmp_path, capsys):
    model = small_model("deepseek-moe-16b", dtype="float32")
    bench_path = write_bench(tmp_path, {"moe": (model, "kq4b", 16)})
    rc, line, _ = _run(capsys, tmp_path, bench_path, "moe")
    assert rc == 0 and line["correct"] is True
    assert harness.forbidden_modules() == []


def test_seeds_past_32_bits(tmp_path, capsys):
    model = small_model("granite-20b", dtype="float32")
    bench_path = write_bench(tmp_path, {"c": (model, "btopk", 16)})
    rc, a, _ = _run(capsys, tmp_path, bench_path, "c", seed=2**32 + 2**31 + 3)
    assert rc == 0 and a["correct"] is True
    assert math.isfinite(a["metrics"]["train_tokens_per_s"]["value"])
