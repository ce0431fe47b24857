"""Resumable training on ``torch.distributed`` ranks (gloo, CPU): a trainer
state saved on the ranks (``checkpoint.save_state(..., mesh=)``: rank 0
writes the one file, gathering every rank's rows of each node-stacked leaf)
and restored on them (each rank reads its rows) continues bit for bit.

The wires: static ``kq4b`` packed (Adam), ``kq4b`` fused, gradient
tracking, round-robin ring + torus with 25% dropout (4 nodes on 2 ranks),
and the faulted fused wire (3 nodes on 3 ranks, as phase 17b of
``chip_smoke.py``), on the logistic model of ``torch_dist_world.py``.
Every leaf a file holds is compared: theta, lambda, the optimizer moments,
theta_hat, s, GT's lanes and tracker, the mirrors, the fault state and its
meter, theta_avg, the step counters and the four generators.

Levels.  A resumed run against the straight one on the same backend:
EXACT.  The ranks' file against the rolled run's file at the same step:
the same names, shapes and dtypes, and the same bytes, except theta_avg
(the network mean is an all-reduce on the ranks: within 1e-6 relative)
and, on the time-varying wire, the values (the cached round against the
dense W(t): within 2e-6; its file also holds the mirrors).  A file that
crosses backends continues EXACTLY as the run that wrote it, theta_avg
within 1e-6 relative.  A JAX-written trainer state resumed on 2 ranks
equals the port's one-process resume of it bit for bit (lambda's mean and
theta_avg within 1e-6 relative) and the JAX run within
``test_torch_trainer_state.py``'s 1e-5.  Then the training CLI under
``torch.distributed.run``.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import torch_dist_world as W
from repro.checkpoint import save as jsave
from repro.configs import get_config as jax_config
from repro.data import node_token_stream
from repro.launch import steps as jsteps
from repro.models import transformer as JT
from repro_torch.checkpoint import load_flat
from repro_torch.launch import train as ttrain
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
ULP = 2e-6
REL = 1e-6
FAULTED = ("faulted",)
WIRES = list(W.RESUME_WIRES)


def _jax_reference(root: Path) -> dict:
    """The JAX trainer (``W.JAX_STATE``) runs 2 rounds and saves its whole
    state at step 2 (``<root>/jax_state``), then 2 more rounds: their aux
    and its final state's flat leaves."""
    m = W.JAX_NODES
    jcfg = jax_config("qwen3-1.7b").reduced(layers=2, d_model=64)
    jtr = jsteps.make_trainer(jcfg, m, **W.JAX_STATE)
    jstate = jtr.init(JT.init_model(jax.random.PRNGKey(0), jcfg), jax.random.PRNGKey(1))
    # a strong f32 lambda (the same values): the jitted step compiles once
    jstate = jstate._replace(lam=jnp.asarray(jstate.lam, jnp.float32))
    stream = node_token_stream(m, 4, 8, jcfg.vocab_size, seed=0)
    for _ in range(2):
        jstate, _ = jtr.step(jstate, {"tokens": jnp.asarray(next(stream))})
    jsave(str(root / "jax_state"), jstate, step=2)
    aux = []
    for _ in range(2):
        jstate, a = jtr.step(jstate, {"tokens": jnp.asarray(next(stream))})
        aux.append({k: np.asarray(a[k], np.float64) for k in ("losses", "lambda_mean")})
    return {"aux": aux, "final": load_flat(jsave(str(root / "jax_final"), jstate))}


@pytest.fixture(scope="module")
def resume(tmp_path_factory):
    """The rolled runs (which write the rolled files), the JAX file, the
    2-rank and 3-rank worlds, then the ranks' files resumed in one process."""
    root = tmp_path_factory.mktemp("resume")
    rolled = {w: W.resume_case(None, w, str(root)) for w in WIRES}
    jax_ref = _jax_reference(root)
    two = W.run_world("resume", 2, root / "w2", args=(str(root),), timeout=240.0)
    three = W.run_world("resume_faulted", 3, root / "w3", args=(str(root),), timeout=240.0)
    ranks = {w: [r[w] for r in (three if w in FAULTED else two)] for w in WIRES}
    crossed = {w: W.resume_from(None, w, ranks[w][0]["file"]) for w in W.CROSSING}
    return {"rolled": rolled, "ranks": ranks, "crossed": crossed, "jax": jax_ref,
            "jax_ranks": [r["jax"] for r in two], "jax_port": W.jax_file_case(None, str(root)),
            "torn": [r["torn"] for r in two]}


def _sharded(name: str, value: torch.Tensor) -> bool:
    """The node-stacked leaves of a record, as ``checkpoint.state_parts``
    declares them for these trainers (a per-node lambda, no federated
    state)."""
    return name.startswith(("theta|", "opt|mu|", "opt|nu|", "consensus|")) or name == "lam"


def _assemble(records: list) -> dict:
    """The ranks' records as one process's: the node-stacked leaves' rows in
    rank order, the others from rank 0 after checking every rank has them."""
    out = {}
    for name, x in records[0].items():
        if _sharded(name, x):
            out[name] = torch.cat([r[name] for r in records])
        else:
            for r in records[1:]:
                assert torch.equal(r[name], x), f"{name}: the ranks disagree"
            out[name] = x
    return out


def _same(got: dict, want: dict, *, rel=("theta_avg|",), ulp=False) -> None:
    assert list(got) == list(want)
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape and g.dtype == w.dtype, name
        if name.startswith(rel):
            scale = float(w.double().abs().max())
            assert float((g.double() - w.double()).abs().max()) <= REL * max(scale, 1e-30), name
        elif ulp and w.is_floating_point():
            assert float((g.double() - w.double()).abs().max()) <= ULP, name
        else:
            assert torch.equal(g, w), f"{name}: not exact"


@pytest.mark.parametrize("wire", WIRES)
def test_resumed_run_equals_the_straight_one(wire, resume):
    """Saved at round 2, resumed into a fresh state (other seeds), run to
    round 4: every leaf and generator EXACTLY the straight 4-round run's,
    on the ranks and in one process."""
    for rec in resume["ranks"][wire]:
        _same(rec["C"], rec["A"], rel=())
    _same(resume["rolled"][wire]["C"], resume["rolled"][wire]["A"], rel=())


@pytest.mark.parametrize("wire", WIRES)
def test_what_rank_0_writes_alone_is_the_same_on_every_rank(wire, resume):
    """theta_avg, the step counters and the generators are written from rank
    0's copy: every rank holds the same bytes when the file is written."""
    assert all(rec["agree"] for rec in resume["ranks"][wire])


@pytest.mark.parametrize("wire", WIRES)
def test_ranks_file_is_the_one_process_file(wire, resume):
    """One file, written by rank 0: whole [m, ...] leaves under the rolled
    run's names, shapes and dtypes, in its order, with the generators; the
    bytes equal but for theta_avg (the time-varying wire: within 2e-6, its
    mirrors besides)."""
    ranks = resume["ranks"][wire]
    assert len({rec["file"] for rec in ranks}) == 1
    got = load_flat(ranks[0]["file"])
    want = load_flat(resume["rolled"][wire]["file"])
    assert {n for n in got if n.startswith("generator|")} == {
        "generator|gossip", "generator|dual", "generator|mask", "generator|fault"}
    timevarying = wire == "rr+drop"
    if timevarying:  # the cached round's mirrors, one tree per union op
        extra = set(got) - set(want)
        assert extra and all(n.startswith("consensus|cache|") for n in extra)
        got = {n: got[n] for n in want}
    assert list(got) == list(want)
    as_torch = lambda flat: {n: torch.from_numpy(np.ascontiguousarray(a)) for n, a in flat.items()}
    _same(as_torch(got), as_torch(want), ulp=timevarying)
    m = 3 if wire in FAULTED else 4
    assert got["theta|w"].shape == (m, 20, 3) and got["lam"].shape == (m, m)


@pytest.mark.parametrize("wire", W.CROSSING)
def test_files_cross_backends(wire, resume):
    """The rolled run's step-2 file resumed on the ranks continues EXACTLY
    as the ranks' straight run, and the ranks' file resumed in one process
    as the rolled straight run (theta_avg within 1e-6 relative)."""
    for rec in resume["ranks"][wire]:
        _same(rec["X"], rec["A"])
    _same(resume["crossed"][wire], resume["rolled"][wire]["A"])


def test_torn_newest_file_falls_back_on_every_rank(resume):
    """Step 3 unreadable on one rank only, step 2 torn on every rank: every
    rank resumes at step 1, into exactly the state saved there."""
    for rec in resume["torn"]:
        assert rec["step"] == 1
        _same(rec["state"], rec["want"], rel=())


def test_jax_trainer_state_resumes_on_the_ranks(resume):
    """The JAX package's trainer state (gradient tracking, 2 local steps,
    momentum, the running average) resumed on 2 ranks: the ranks' rows equal
    the port's one-process resume of the same file, and both continue as
    the JAX run does."""
    port = resume["jax_port"]
    ranks = resume["jax_ranks"]
    _same(_assemble([r["state"] for r in ranks]), port["state"])
    for i, ref in enumerate(resume["jax"]["aux"]):
        for r in ranks:
            assert torch.equal(r["aux"][i]["losses"], port["aux"][i]["losses"])
            lm, want = r["aux"][i]["lambda_mean"].double(), port["aux"][i]["lambda_mean"].double()
            assert float((lm - want).abs().max()) <= REL * float(want.abs().max())
        for name in ("losses", "lambda_mean"):
            got = port["aux"][i][name].numpy()
            assert np.abs(got - ref[name]).max() <= 1e-5 * np.abs(ref[name]).max(), name
    final = resume["jax"]["final"]
    names = [n for n in port["state"] if n.startswith(("theta|", "theta_avg|"))]
    assert names and all(n in final for n in names)
    for n in names:
        a = np.asarray(final[n], np.float64)
        assert np.abs(port["state"][n].double().numpy() - a).max() <= 1e-5 * np.abs(a).max(), n


# -------------------------------------------------------------- the CLI
CLI = ["--arch", "qwen3-1.7b", "--reduced", "--nodes", "4", "--device", "cpu",
       "--compressor", "kq4b", "--batch-per-node", "2", "--seq", "32", "--log-every", "1"]


def test_train_cli_resumes_on_two_ranks(tmp_path):
    """``torch.distributed.run`` with 2 ranks: ``--steps 2 --checkpoint``
    writes one state file and one model file, from rank 0; ``--resume
    --steps 4`` resumes at step 2 on both ranks; the metrics equal the
    uninterrupted rolled run's (losses exact, the consensus error within
    1e-6 relative) and the final state file the rolled run's, leaf for
    leaf."""
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join([str(ROOT / "src"), os.environ.get("PYTHONPATH", "")])}
    ck, out = tmp_path / "dist" / "run", tmp_path / "dist.json"
    launch = [sys.executable, "-m", "torch.distributed.run", "--standalone",
              "--nproc-per-node", "2", "-m", "repro_torch.launch.train", *CLI,
              "--gossip-backend", "ppermute", "--checkpoint", str(ck)]
    first = subprocess.run(launch + ["--steps", "2"], capture_output=True, text=True,
                           timeout=300, env=env, cwd=tmp_path)
    assert first.returncode == 0, first.stdout[-3000:] + first.stderr[-3000:]
    assert sorted(p.name for p in ck.parent.iterdir()) == ["run_00000002.npz", "run_model.npz"]
    assert first.stdout.count("saved final state") == 1
    second = subprocess.run(launch + ["--steps", "4", "--resume", "--metrics-out", str(out)],
                            capture_output=True, text=True, timeout=300, env=env, cwd=tmp_path)
    assert second.returncode == 0, second.stdout[-3000:] + second.stderr[-3000:]
    assert second.stdout.count("resumed full trainer state from step 2") == 1
    assert second.stdout.count("mesh: rank") == 2
    rolled_ck, rolled_out = tmp_path / "rolled" / "run", tmp_path / "rolled.json"
    ttrain.main(CLI + ["--steps", "4", "--checkpoint", str(rolled_ck), "--metrics-out",
                       str(rolled_out)])
    got, want = json.loads(out.read_text()), json.loads(rolled_out.read_text())
    assert got["losses"] == want["losses"] and got["final_step"] == want["final_step"] == 4
    assert abs(got["consensus_err"] - want["consensus_err"]) <= REL * abs(want["consensus_err"])
    a, b = load_flat(f"{ck}_00000004.npz"), load_flat(f"{rolled_ck}_00000004.npz")
    assert list(a) == list(b)
    for n in b:
        assert a[n].shape == b[n].shape and a[n].dtype == b[n].dtype, n
        assert a[n].tobytes() == b[n].tobytes(), n
