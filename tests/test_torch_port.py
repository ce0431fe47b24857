"""The port's standing rules: no JAX and nothing of ``repro`` inside
``repro_torch`` or ``chip_smoke.py``, the card as the default device,
reference checkpoints (bf16 leaves included) restoring without ml_dtypes,
and ``chip_smoke.py`` failing without a card or without the repo."""
import dataclasses
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import save as jax_save
from repro.configs import get_config as jax_config
from repro.models import transformer as JT
from repro_torch.checkpoint import restore, restore_jax_params, save
from repro_torch.configs import get_config as torch_config
from repro_torch.core import ADGDAConfig, adgda_trainer
from repro_torch.launch import quickstart as tquick
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.launch.mesh import make_node_mesh
from repro_torch.models import transformer as TT
from repro_torch.serving import ServeEngine
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
MODULES = sorted(
    ".".join(p.relative_to(ROOT / "src").with_suffix("").parts).removesuffix(".__init__")
    for p in PKG.rglob("*.py")
)
IMPORT_RE = re.compile(r"^\s*(?:import|from)\s+(jax|jaxlib|repro)(?:\.|\s|$)", re.M)


def _env():
    return {**os.environ, "PYTHONPATH": str(ROOT / "src")}


def test_port_sources_import_no_jax_and_no_reference():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    # the training slice's modules are among those checked here and below
    assert {"repro_torch.core.gossip", "repro_torch.core.trainer", "repro_torch.core.adgda",
            "repro_torch.kernels.quantize", "repro_torch.kernels.choco_fused",
            "repro_torch.optim.sgd", "repro_torch.data.synthetic", "repro_torch.launch.train",
            "repro_torch.launch.quickstart"} <= set(MODULES)
    offenders = {str(f.relative_to(ROOT)): m for f in files
                 if (m := IMPORT_RE.findall(f.read_text()))}
    assert offenders == {}


def test_port_imports_with_jax_blocked(tmp_path):
    """Every module and chip_smoke.py import with jax and ml_dtypes blocked,
    and a JAX-written bf16 checkpoint restores there."""
    cfg = dataclasses.replace(jax_config("qwen3-1.7b").reduced(layers=2, d_model=64),
                              dtype="bfloat16")
    jp = JT.init_model(jax.random.PRNGKey(0), cfg)
    fname = jax_save(str(tmp_path / "bf16"), jp)
    want = float(np.asarray(jp["blocks"][0]["mixer"]["wq"][1], np.float32).sum())
    code = f"""
import importlib, sys
for name in ("jax", "jaxlib", "ml_dtypes", "repro"):
    sys.modules[name] = None
sys.path.insert(0, {str(ROOT)!r})
for mod in {MODULES!r} + ["chip_smoke"]:
    importlib.import_module(mod)
import dataclasses, torch
from repro_torch.checkpoint import restore_jax_params
from repro_torch.configs import get_config
cfg = dataclasses.replace(get_config("qwen3-1.7b").reduced(layers=2, d_model=64), dtype="bfloat16")
p = restore_jax_params({fname!r}, cfg, device="cpu")
wq = p["layers"][1]["mixer"]["wq"]
assert wq.dtype == torch.bfloat16, wq.dtype
print("SUM", float(wq.float().sum()))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=_env(), timeout=300)
    assert out.returncode == 0, out.stderr
    got = float(out.stdout.split("SUM")[-1])
    assert got == pytest.approx(want, rel=1e-6, abs=1e-6)


def test_jax_bf16_checkpoint_restores_bit_exact(tmp_path):
    """Stacked reference blocks unstack into global layers, bf16 bit for bit."""
    cfg = dataclasses.replace(jax_config("qwen3-1.7b").reduced(layers=3, d_model=64),
                              dtype="bfloat16")
    tcfg = dataclasses.replace(torch_config("qwen3-1.7b").reduced(layers=3, d_model=64),
                               dtype="bfloat16")
    jp = JT.init_model(jax.random.PRNGKey(4), cfg)
    p = restore_jax_params(jax_save(str(tmp_path / "m"), jp), tcfg, device="cpu")
    assert len(p["layers"]) == 3
    for i in range(3):
        for name in ("wq", "wk", "wo", "q_norm"):
            ref = np.asarray(jp["blocks"][0]["mixer"][name][i]).view(np.int16)
            np.testing.assert_array_equal(p["layers"][i]["mixer"][name].view(torch.int16).numpy(),
                                          ref)
    np.testing.assert_array_equal(p["embed"]["table"].view(torch.int16).numpy(),
                                  np.asarray(jp["embed"]["table"]).view(np.int16))


def test_port_checkpoint_round_trip(tmp_path):
    tcfg = dataclasses.replace(torch_config("qwen3-1.7b").reduced(layers=2, d_model=64),
                               dtype="bfloat16")
    p = TT.init_model(tcfg, seed=3, device="cpu")
    fname = save(str(tmp_path / "port"), p, step=7)
    back = restore(fname, p, device="cpu")
    assert fname.endswith("port_00000007.npz")
    assert torch.equal(back["layers"][1]["ffn"]["w_up"], p["layers"][1]["ffn"]["w_up"])
    assert back["embed"]["table"].dtype == torch.bfloat16
    with np.load(fname) as data:
        assert "layers|1|mixer|wq" in data.files


def test_entry_points_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid here")
    cfg = torch_config("qwen3-1.7b").reduced(layers=1, d_model=64)
    params = TT.init_model(cfg, device="cpu")
    fname = save(str(tmp_path / "p"), params)
    calls = [
        lambda: TT.init_model(cfg),
        lambda: TT.init_cache(cfg, 1, 8),
        lambda: ServeEngine(cfg, params),
        lambda: tserve.main(["--arch", "qwen3-1.7b", "--reduced", "--gen", "2"]),
        lambda: TT.params_from_jax({"embed": {"table": np.zeros((512, 64))}}, cfg),
        lambda: restore(fname, params),
        lambda: TT.init_train_params(cfg),
        lambda: tsteps.make_trainer(cfg, 4),
        lambda: adgda_trainer(ADGDAConfig(num_nodes=4), lambda p, b, r: 0.0),
        lambda: ttrain.main(["--arch", "qwen3-1.7b", "--reduced", "--steps", "1"]),
        lambda: tquick.run(1),
        lambda: make_node_mesh(4),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_chip_smoke_fails_without_card_or_repo(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    run = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path)
    assert run.returncode != 0 and '"ok"' not in run.stdout
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(ROOT / "chip_smoke.py", alone)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    run = subprocess.run([sys.executable, "chip_smoke.py"], capture_output=True, text=True,
                         timeout=300, cwd=alone, env=env)
    assert run.returncode != 0 and '"ok"' not in run.stdout


def test_unknown_and_unported_configs():
    """Unknown names raise; none is unported any more (llama4-scout-17b-a16e
    resolves under both spellings)."""
    assert torch_config("qwen3_1_7b") == torch_config("qwen3-1.7b")
    with pytest.raises(ValueError, match="unknown arch"):
        torch_config("gpt-9")
    assert torch_config("llama4_scout_17b_a16e") == torch_config("llama4-scout-17b-a16e")
    assert torch_config("llama4-scout-17b-a16e").num_experts == 16
    assert torch_config("mamba2_1_3b") == torch_config("mamba2-1.3b")
    assert torch_config("qwen3-4b").name == "qwen3-4b"
    assert torch_config("qwen3-1.7b").activation_dtype == torch.bfloat16
