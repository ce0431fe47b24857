"""On the card: the first cell, traced, through the benchmark's command.
Skips without a CUDA card (decided inside the fixture)."""
import json
import subprocess
import sys

import pytest
import torch

from conftest import ROOT

CELL = "granite-20b.ring4.b4s128"


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_first_cell_traced_on_the_card(card):
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", CELL, "--seed",
                          "4000000007", "--seconds", "3", "--trace", "1"], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    want = {m["name"] for m in bench["per_layer"] if CELL in m.get("workloads", [CELL])}
    assert set(line["metrics"]) == want
    assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
    roofline = next(v for k, v in line["metrics"].items() if k.startswith("gossip_kernels_roofline"))
    assert 0 < roofline["value"] <= 105
