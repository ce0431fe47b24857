"""repro_torch's trainer-state checkpoints and data generators, on the CPU:
a run stopped and resumed through ``launch/train.py --checkpoint /
--resume`` equals the run that never stopped, bit for bit (losses, theta,
the CHOCO / GT trackers, under faults the mirrors and the fault state, the
optimizer moments, every generator); a ``TrainerState`` the JAX package
wrote (f32: the reference cannot restore bf16), faulted or not, restores
into the port under the same leaf names and continues as the reference
does; the three classification generators are byte-identical to the
reference's.

Tolerance of the continuation: losses and lambda within 1e-5 relative,
theta within 1e-5 of each leaf's largest magnitude.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro import data as jdata
from repro.checkpoint import save as jsave
from repro.configs import get_config as jax_config
from repro.data import node_token_stream
from repro.launch import steps as jsteps
from repro.models import transformer as JT
from repro_torch import data as tdata
from repro_torch.checkpoint import load_flat, restore_state, save_state
from repro_torch.configs import get_config as torch_config
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.tree import leaves, unflatten
# autouse: one torch thread, which the bit-for-bit runs need (a multi-threaded
# CPU reduction may sum in another order from one run to the next)
from torch_threads import one_torch_thread  # noqa: F401

BASE = ["--arch", "qwen3-1.7b", "--reduced", "--batch-per-node", "2", "--seq", "16",
        "--device", "cpu", "--log-every", "100", "--compressor", "kq4b"]


def _strong_lam(jstate):
    """The reference's initial lambda is weakly typed and every later
    round's is not, so its jitted step would compile twice; a strong f32
    lambda (the same values) compiles it once."""
    return jstate._replace(lam=jnp.asarray(jstate.lam, jnp.float32))


def _state_tensors(state):
    cons = state.consensus
    lanes = [cons.model, cons.tracker] if hasattr(cons, "tracker") else [cons]
    out = leaves(state.theta) + [state.lam] + list(state.opt.mu)
    for lane in lanes:
        out += leaves(lane.theta_hat) + leaves(lane.s) + leaves(lane.cache)
        out += list(lane.fault)  # the FaultState's tensors, () without faults
    if hasattr(cons, "tracker"):
        out += leaves(cons.y) + leaves(cons.d_prev)
    return out


def _last_state(argv):
    """(metrics, final state) of one CLI run; ``wrap_step`` keeps the state."""
    kept = {}

    def wrap_step(step, run, state):
        kept["state"], aux = run()
        return kept["state"], aux

    return ttrain.main(argv, wrap_step=wrap_step), kept["state"]


@pytest.mark.parametrize("flags", [
    ["--nodes", "4", "--topology-schedule", "roundrobin:ring,torus", "--dropout", "0.3",
     "--momentum", "0.9"],
    ["--nodes", "2", "--consensus", "gt", "--local-steps", "2", "--fused-gossip"],
    ["--nodes", "3", "--fault-spec", "drop:0.3,corrupt:0.2,stale:0", "--fused-gossip"],
], ids=["masked", "gt-fused", "faulted-fused"])
def test_resume_equals_the_uninterrupted_run(tmp_path, flags):
    ck = str(tmp_path / "ck" / "run")
    a, sa = _last_state(BASE + flags + ["--steps", "4"])
    ttrain.main(BASE + flags + ["--steps", "2", "--checkpoint", ck])
    c, sc = _last_state(BASE + flags + ["--steps", "4", "--checkpoint", ck, "--resume",
                                        "--checkpoint-every", "3"])
    assert c["start_step"] == 2
    assert [h["losses"] for h in a["history"][2:]] == [h["losses"] for h in c["history"]]
    assert sa.step == sc.step == 4 and sa.opt.step == sc.opt.step
    assert all(torch.equal(x, y) for x, y in zip(_state_tensors(sa), _state_tensors(sc)))
    for g in ("generator", "dual_generator", "mask_generator", "fault_generator"):
        assert torch.equal(getattr(sa, g).get_state(), getattr(sc, g).get_state())
    names = set(load_flat(ck + "_00000004.npz"))
    assert {"step", "lam", "opt|step", "generator|gossip", "generator|dual",
            "generator|mask", "generator|fault"} <= names
    if "--fault-spec" in flags:
        assert {f"consensus|fault|{f}" for f in ("synced", "stale", "wait", "backoff",
                                                 "detected", "resyncs", "bits")} <= names
        assert any(n.startswith("consensus|cache|1|") for n in names)
        assert sum(h["faults"]["detected"] for h in a["history"]) > 0
    assert any(n.startswith("consensus|model|theta_hat|" if "gt" in flags
                            else "consensus|theta_hat|") for n in names)
    assert load_flat(ck + "_model.npz").keys() == {n[len("theta|"):] for n in names
                                                   if n.startswith("theta|")}


def test_resume_falls_back_past_a_torn_file(tmp_path, capsys):
    ck = str(tmp_path / "run")
    flags = ["--nodes", "2", "--steps", "2", "--checkpoint", ck, "--checkpoint-every", "1"]
    ttrain.main(BASE + flags)
    with open(ck + "_00000002.npz", "wb") as f:
        f.write(b"torn")
    c = ttrain.main(BASE + flags[:2] + ["--steps", "3", "--checkpoint", ck, "--resume"])
    assert c["start_step"] == 1 and "unreadable" in capsys.readouterr().out



def test_resume_with_no_loadable_file_starts_fresh(tmp_path, capsys):
    ck = str(tmp_path / "run")
    with open(ck + "_00000002.npz", "wb") as f:
        f.write(b"torn")
    flags = ["--nodes", "2", "--steps", "2", "--dropout", "0.3"]
    c = ttrain.main(BASE + flags + ["--checkpoint", ck, "--resume"])
    assert c["start_step"] == 0 and "starting fresh" in capsys.readouterr().out
    fresh = ttrain.main(BASE + flags)
    assert [h["losses"] for h in c["history"]] == [h["losses"] for h in fresh["history"]]

def test_a_reference_trainer_state_continues_in_the_port(tmp_path):
    """The JAX trainer (gradient tracking, 2 local steps, momentum, the
    running average) runs 2 rounds and saves its whole TrainerState; the
    port restores it under the same leaf names and both run 2 more."""
    m = 4
    kw = dict(compressor="none", consensus="gt", local_steps=2, momentum=0.9,
              track_average=True)
    jcfg = jax_config("qwen3-1.7b").reduced(layers=2, d_model=64)
    tcfg = torch_config("qwen3-1.7b").reduced(layers=2, d_model=64)
    jtr, ttr = jsteps.make_trainer(jcfg, m, **kw), tsteps.make_trainer(tcfg, m, device="cpu",
                                                                        **kw)
    jparams = JT.init_model(jax.random.PRNGKey(0), jcfg)
    jstate = _strong_lam(jtr.init(jparams, jax.random.PRNGKey(1)))
    stream = node_token_stream(m, 4, 8, jcfg.vocab_size, seed=0)
    for _ in range(2):
        jstate, _ = jtr.step(jstate, {"tokens": jnp.asarray(next(stream))})
    fname = jsave(str(tmp_path / "jax_state"), jstate, step=2)
    template = unflatten(jparams, [torch.zeros(x.shape) for x in
                                   jax.tree_util.tree_leaves(jparams)])
    tstate = restore_state(fname, ttr.init(template, seed=0))
    assert tstate.step == 2 and tstate.opt.step == 2
    for _ in range(2):
        tokens = next(stream)
        jstate, jaux = jtr.step(jstate, {"tokens": jnp.asarray(tokens)})
        tstate, taux = ttr.step(tstate, {"tokens": torch.from_numpy(tokens)})
        for name in ("losses", "lambda_mean"):
            ref = np.asarray(jaux[name], np.float64)
            assert np.abs(taux[name].numpy() - ref).max() <= 1e-5 * np.abs(ref).max()
    for tree_j, tree_t in ((jstate.theta, tstate.theta), (jstate.theta_avg, tstate.theta_avg)):
        for a, b in zip(jax.tree_util.tree_leaves(tree_j), leaves(tree_t)):
            a = np.asarray(a)
            assert np.abs(b.numpy() - a).max() <= 1e-5 * np.abs(a).max()
    # and the port's own file of that state has the reference's names, plus its generators
    names = set(load_flat(save_state(str(tmp_path / "port_state"), tstate)))
    jnames = set(load_flat(fname)) - {"rng"}
    assert names - jnames == {"generator|gossip", "generator|dual", "generator|mask",
                              "generator|fault"}
    assert jnames <= names


def test_a_reference_faulted_state_continues_in_the_port(tmp_path):
    """The JAX trainer under wire faults (3 nodes on a ring, ``none``
    compression, ``drop:0.3,corrupt:0.2,stale:0``) runs 2 rounds and saves;
    the port restores the file under the reference's leaf names --
    ``consensus|cache|<op>|...``, ``consensus|fault|...`` -- into exactly
    the reference's values, then both run 2 more rounds on the reference's
    fault draws: the fault state stays equal, losses within 1e-5."""
    m, spec = 3, "drop:0.3,corrupt:0.2,stale:0"
    kw = dict(compressor="none", fault_spec=spec)
    jcfg = jax_config("qwen3-1.7b").reduced(layers=2, d_model=64)
    tcfg = torch_config("qwen3-1.7b").reduced(layers=2, d_model=64)
    jtr, ttr = jsteps.make_trainer(jcfg, m, **kw), tsteps.make_trainer(tcfg, m, device="cpu",
                                                                        **kw)
    n_ops = jtr.consensus.union.n_ops
    jparams = JT.init_model(jax.random.PRNGKey(0), jcfg)
    jstate = _strong_lam(jtr.init(jparams, jax.random.PRNGKey(1)))
    stream = node_token_stream(m, 2, 8, jcfg.vocab_size, seed=0)
    for _ in range(2):
        jstate, _ = jtr.step(jstate, {"tokens": jnp.asarray(next(stream))})
    fname = jsave(str(tmp_path / "jax_state"), jstate, step=2)
    template = unflatten(jparams, [torch.zeros(x.shape) for x in
                                   jax.tree_util.tree_leaves(jparams)])
    tstate = restore_state(fname, ttr.init(template, seed=0))
    flat = load_flat(fname)
    fault = tstate.consensus.fault
    for f in fault._fields:
        np.testing.assert_array_equal(getattr(fault, f).numpy(), flat[f"consensus|fault|{f}"])
    for k, mirror in enumerate(tstate.consensus.cache):
        got = leaves(mirror)
        want = jax.tree_util.tree_leaves(jstate.consensus.cache[k])
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for _ in range(2):
        tokens = next(stream)
        fkey = jax.random.split(jstate.rng, m + 3)[2]
        u = np.array(jax.random.uniform(fkey, (n_ops, m)))
        jstate, jaux = jtr.step(jstate, {"tokens": jnp.asarray(tokens)})
        tstate, taux = ttr.step(tstate, {"tokens": torch.from_numpy(tokens)}, fault_u=u)
        for f in fault._fields:
            np.testing.assert_array_equal(getattr(tstate.consensus.fault, f).numpy(),
                                          np.asarray(getattr(jstate.consensus.fault, f)))
        assert taux["bits_realized"] == float(jaux["bits_realized"])
        ref = np.asarray(jaux["losses"], np.float64)
        assert np.abs(taux["losses"].numpy() - ref).max() <= 1e-5 * np.abs(ref).max()
    assert int(tstate.consensus.fault.detected.sum()) > 0


@pytest.mark.parametrize("fn,kw", [
    ("class_shard_classification", {}),
    ("class_shard_classification", {"num_nodes": 7, "num_classes": 3, "seed": 2}),
    ("contrast_shift_classification", {}),
    ("contrast_shift_classification", {"num_nodes": 10, "dim": 24, "seed": 1}),
    ("instrument_shift_classification", {}),
    ("instrument_shift_classification", {"num_nodes": 10, "dim": 24, "seed": 1}),
])
def test_generators_are_byte_identical(fn, kw):
    a, b = getattr(jdata, fn)(**kw), getattr(tdata, fn)(**kw)
    assert a.x.tobytes() == b.x.tobytes() and a.y.tobytes() == b.y.tobytes()
    assert a.x.dtype == b.x.dtype and a.y.dtype == b.y.dtype
    assert a.val_names == b.val_names
    for xa, xb, ya, yb in zip(a.val_x, b.val_x, a.val_y, b.val_y):
        assert xa.tobytes() == xb.tobytes() and ya.tobytes() == yb.tobytes()
    ga, gb = a.batches(8, seed=3), b.batches(8, seed=3)
    for _ in range(2):
        (xa, ya), (xb, yb) = next(ga), next(gb)
        assert xa.tobytes() == xb.tobytes() and ya.tobytes() == yb.tobytes()
