"""repro_torch trainer against the JAX trainer, on the CPU: reduced qwen3
(f32, 2 layers, d_model 64) on 4 ring nodes, 3 rounds of AD-GDA and of
CHOCO-SGD, with no compression and with ``kq4b`` fused gossip (the port fed
the reference's quantization noise); then the training CLI.

Tolerance: losses and lambda to 1e-5 relative, every theta leaf to 1e-5 of
its largest magnitude.  The two sides differ in summation order (matmuls,
norms) and in XLA's FMA contraction inside the jitted step; over 3 rounds
that stays near 1e-6.
"""
import json
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import get_config as jax_config
from repro.data import node_token_stream
from repro.launch import steps as jsteps
from repro.launch import train as jtrain
from repro.models import transformer as JT
from repro_torch.configs import get_config as torch_config
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.tree import leaves, unflatten
from torch_reference_noise import reference_noise
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

M, STEPS = 4, 3
REL = 1e-5


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("robust", [True, False], ids=["adgda", "choco_sgd"])
@pytest.mark.parametrize("spec,fused", [("none", False), ("kq4b", True)],
                         ids=["none", "kq4b_fused"])
def test_trainer_matches_reference(spec, fused, robust):
    jcfg = jax_config("qwen3-1.7b").reduced(layers=2, d_model=64)
    tcfg = torch_config("qwen3-1.7b").reduced(layers=2, d_model=64)
    kw = dict(compressor=spec, fused_gossip=fused, robust=robust)
    jtr = jsteps.make_trainer(jcfg, M, **kw)
    ttr = tsteps.make_trainer(tcfg, M, device="cpu", **kw)
    jparams = JT.init_model(jax.random.PRNGKey(0), jcfg)
    tparams = unflatten(jparams, [torch.from_numpy(np.array(x))
                                  for x in jax.tree_util.tree_leaves(jparams)])
    rng = jax.random.PRNGKey(1)
    jstate = jtr.init(jparams, rng)
    # the initial lambda is weakly typed and later rounds' is not: a strong f32
    # lambda (the same values) compiles the jitted step once, not twice
    jstate = jstate._replace(lam=jnp.asarray(jstate.lam, jnp.float32))
    tstate = ttr.init(tparams, seed=0)
    assert ttr.gamma == pytest.approx(jtr.gamma, rel=1e-12)
    stream = node_token_stream(M, 2, 8, jcfg.vocab_size, seed=0)
    for _ in range(STEPS):
        tokens = next(stream)
        # the reference's round key: split(rng, m + 2) -> (next rng, gossip key, ...)
        keys = jax.random.split(rng, M + 2)
        rng, gossip_key = keys[0], keys[1]
        xi = reference_noise(gossip_key, jstate.theta, ttr.compressor, M)
        jstate, jaux = jtr.step(jstate, {"tokens": jnp.asarray(tokens)})
        tstate, taux = ttr.step(tstate, {"tokens": torch.from_numpy(tokens)},
                                noise=lambda li, ci, shape: torch.from_numpy(xi[(li, ci)]))
        assert _rel(taux["losses"].numpy(), jaux["losses"]) <= REL
        assert _rel(taux["lambda_mean"].numpy(), jaux["lambda_mean"]) <= REL
        assert taux["eta_theta"] == pytest.approx(float(jaux["eta_theta"]), rel=1e-7)
        assert float(taux["consensus_err"]) == pytest.approx(float(jaux["consensus_err"]),
                                                            rel=1e-4)
    for a, b in zip(jax.tree_util.tree_leaves(jstate.theta), leaves(tstate.theta)):
        assert _rel(b.numpy(), a) <= REL
    assert ttr.bits_per_round(tstate) == jtr.bits_per_round(jstate)


def test_train_cli_runs_on_the_cpu_and_writes_the_reference_metrics(tmp_path, monkeypatch):
    out = tmp_path / "torch.json"
    res = ttrain.main(["--arch", "qwen3-1.7b", "--reduced", "--steps", "2", "--nodes", "3",
                       "--batch-per-node", "2", "--seq", "16", "--compressor", "kq4b",
                       "--fused-gossip", "--device", "cpu", "--metrics-out", str(out)])
    got = json.loads(out.read_text())
    assert all(np.isfinite(got["losses"])) and len(got["losses"]) == 3
    assert res["final_step"] == 2 and len(res["history"]) == 2
    ref = tmp_path / "jax.json"
    monkeypatch.setattr(sys, "argv", [
        "train", "--arch", "qwen3-1.7b", "--reduced", "--steps", "1", "--nodes", "3",
        "--batch-per-node", "2", "--seq", "16", "--compressor", "none",
        "--metrics-out", str(ref)])
    jtrain.main()
    assert set(got) == set(json.loads(ref.read_text()))


@pytest.fixture(scope="module")
def reference_metric_keys(tmp_path_factory):
    """The metrics file's keys from the reference CLI (one run: its keys do
    not depend on the flags)."""
    ref = tmp_path_factory.mktemp("jax") / "jax.json"
    argv = sys.argv
    sys.argv = ["train", "--arch", "qwen3-1.7b", "--reduced", "--steps", "1", "--nodes", "3",
                "--batch-per-node", "2", "--seq", "16", "--compressor", "none",
                "--metrics-out", str(ref)]
    try:
        jtrain.main()
    finally:
        sys.argv = argv
    return set(json.loads(ref.read_text()))


@pytest.mark.parametrize("flag", [
    ["--topology-schedule", "roundrobin:ring,torus"], ["--dropout", "0.1"],
    ["--consensus", "gt"], ["--local-steps", "2"], ["--checkpoint", "ckpt/x"],
], ids=["topology-schedule", "dropout", "consensus-gt", "local-steps", "checkpoint"])
def test_train_cli_flags_run_on_the_cpu(flag, tmp_path, reference_metric_keys):
    """The trainer-breadth flags run 2 rounds on the CPU and write the
    metrics file with the reference CLI's keys."""
    flag = [str(tmp_path / f) if f.startswith("ckpt/") else f for f in flag]
    out = tmp_path / "torch.json"
    res = ttrain.main(["--arch", "qwen3-1.7b", "--reduced", "--nodes", "3", "--batch-per-node",
                       "2", "--seq", "16", *flag, "--steps", "2", "--compressor", "kq4b",
                       "--device", "cpu", "--metrics-out", str(out)])
    got = json.loads(out.read_text())
    assert all(np.isfinite(got["losses"])) and len(res["history"]) == 2
    assert set(got) == reference_metric_keys


@pytest.mark.parametrize("flag,exc,match", [
    (["--fault-spec", "drop"], ValueError, "bad fault-spec item"),
    (["--fused-gossip", "--compressor", "kq4b", "--dropout", "0.1", "--fault-spec", "drop:0.1"],
     ValueError, "fused encode has no participation mask"),
    (["--gossip-backend", "ppermute", "--resume"], SystemExit, "--resume requires --checkpoint"),
    (["--fused-gossip", "--compressor", "kq4b", "--dropout", "0.1"], ValueError,
     "masked path"),
], ids=["malformed-fault-spec", "fused-dropout-faults", "ppermute", "fused-dropout"])
def test_train_cli_flags_outside_the_port_raise(flag, exc, match):
    with pytest.raises(exc, match=match):
        ttrain.main(["--arch", "qwen3-1.7b", "--reduced", "--steps", "1", "--device", "cpu",
                     *flag])


def test_train_cli_trains_under_wire_faults(capsys):
    """``--fault-spec`` trains through the faulted cached round and logs each
    round's detections, resyncs and realized bits; the history's realized
    bits are the trainer's meter plus the dual's constant."""
    res = ttrain.main(["--arch", "qwen3-1.7b", "--reduced", "--device", "cpu", "--steps", "2",
                       "--nodes", "3", "--batch-per-node", "2", "--seq", "16",
                       "--fault-spec", "drop:0.2,stale:0", "--log-every", "1"])
    out = capsys.readouterr().out
    assert "faults[drop:0.2,stale:0]" in out and out.count("detected=") == 2
    assert "resyncs=" in out and "bits_realized=" in out
    hist = res["history"]
    assert len(hist) == 2 and all(np.isfinite(h["losses"]).all() for h in hist)
    for h in hist:
        f = h["faults"]
        assert f["detected"] >= 0 and f["resyncs"] >= 0
        assert h["bits_realized"] == float(np.float32(f["bits_max"]) + np.float32(32 * 3 * 2))


def test_training_with_attention_kernels_raises():
    import dataclasses

    from repro_torch.models import transformer as TT

    cfg = dataclasses.replace(torch_config("qwen3-1.7b").reduced(layers=1, d_model=64),
                              attn_kernel="flash")
    params = TT.init_train_params(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="backward kernels"):
        TT.lm_loss(params, {"tokens": torch.zeros(1, 4, dtype=torch.long)}, cfg)
