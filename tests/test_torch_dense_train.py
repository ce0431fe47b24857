"""Training the four configs left to the port's trained zoo against the JAX
trainer, on the CPU: qwen3-4b (qk_norm, GQA), granite-20b (MQA, GELU MLP),
command-r-35b (no bias, tied embedding) and llama4-scout-17b-a16e (MoE,
top-1 routing plus one shared expert).

``tests/test_torch_zoo_train.py``'s method: reduced widths (``cfg.reduced()``,
f32, 2 layers), JAX-initialised weights, the same numpy tokens from
``node_token_stream`` on both sides.

- Trainer rounds: 2 nodes on a ring, 2 rounds of ``make_trainer`` + ``step``;
  ``none``, and ``kq4b`` fused with the port fed the reference's
  quantization noise.  Losses and lambda to 1e-5 relative, every theta leaf
  to 1e-5 of its largest magnitude, the consensus error to 1e-4 relative,
  bits exact, after every round.
- Under ``kq4b`` theta_hat and s are held too, to the same 1e-5, with one
  allowance, stated and bounded: a quantization level at a floor boundary.
  Each side takes the residual's norm in its own summation order, so the
  two encode scales may differ in the last bit, and an element whose
  ``|r|·2^b/‖r‖ + ξ`` lies within a few ulps of an integer floors to
  adjacent levels.  Such an element's theta_hat differs by exactly one
  quantization level of its leaf and node (``‖r‖ / (2^b τ)``, from the
  reference's own residual); its s and theta at the same index then
  differ too, in this round and the later ones.  At most NORM_FLIPS of a
  leaf's elements may be flipped (the convention of
  ``tests/test_torch_gossip.py``), and the count is printed.
  ``test_level_flip_is_a_floor_boundary`` shows that every element whose
  theta_hat differs after the first round is one where the reference's
  residual and noise floor to different levels under the two norms, within
  a few ulps of the integer.
- The CLI: the port's ``launch/train.py`` against the reference's on
  granite-20b with ``--compressor none``, the port given the reference's
  initial tree; the ``--metrics-out`` files to the same bounds.
- ``chip_smoke.py`` phase 19's rows of these configs, rehearsed at reduced
  width on the CPU: ``train_family`` with the ``torch.cuda`` memory calls,
  the card's name and the profile breakdown stubbed, and the plain gossip
  functions counting launches.
"""
import dataclasses
import importlib
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.data import node_token_stream
from repro.launch import steps as jsteps
from repro.launch import train as jtrain
from repro.models import transformer as JT
from repro_torch.configs import get_config as torch_config
from repro_torch.core.topology import ring
from repro_torch.kernels.choco_fused import node_norms
from repro_torch.kernels.ref import encode_scale, tau_for
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.tree import leaves
from torch_reference_noise import reference_noise
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ARCHS = ("qwen3-4b", "granite-20b", "command-r-35b", "llama4-scout-17b-a16e")
M, STEPS, B, S = 2, 2, 2, 32
BITS = 4
REL = 1e-5
ERR_REL = 1e-4
NORM_FLIPS = 1e-3  # the largest share of a leaf's elements one level apart
ULPS = 4  # how near an integer a flipped element's floor argument must lie


def _cfgs(arch):
    return jax_config(arch).reduced(), torch_config(arch).reduced()


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _to_torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _flat(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _level(resid):
    """One quantization level of each node's leaf, ‖r‖ / (2^b τ), from the
    reference's residual [m, ...]: [m, 1, ...] for broadcasting."""
    m = resid.shape[0]
    d = resid[0].size
    norms = np.sqrt((resid.reshape(m, -1).astype(np.float64) ** 2).sum(1))
    return (norms / ((1 << BITS) * tau_for(d, BITS))).reshape((m,) + (1,) * (resid.ndim - 1))


class _Rounds:
    """Both trainers, round by round, from the same initial tree, tokens
    and (under ``kq4b``) quantization noise.  ``next()`` runs one round and
    returns the two aux dicts, the reference's theta_hat before the round
    (numpy leaves: its step donates the state) and the noise it used."""

    def __init__(self, arch, spec):
        self.jcfg, self.tcfg = _cfgs(arch)
        self.fused = spec == "kq4b"
        kw = dict(compressor=spec, fused_gossip=self.fused)
        self.jtr = jsteps.make_trainer(self.jcfg, M, **kw)
        self.ttr = tsteps.make_trainer(self.tcfg, M, device="cpu", **kw)
        jparams = JT.init_model(jax.random.PRNGKey(0), self.jcfg)
        self.rng = jax.random.PRNGKey(1)
        jstate = self.jtr.init(jparams, self.rng)
        # a strong f32 lambda (the same values): the jitted step compiles once
        self.jstate = jstate._replace(lam=jnp.asarray(jstate.lam, jnp.float32))
        self.tstate = self.ttr.init(_to_torch(jparams), seed=0)
        self.stream = node_token_stream(M, B, S, self.jcfg.vocab_size, seed=0)
        self.names = [jax.tree_util.keystr(p) for p, _ in
                      jax.tree_util.tree_flatten_with_path(self.jstate.theta)[0]]

    def next(self):
        batch = {"tokens": next(self.stream)}
        noise = xi = None
        if self.fused:
            # the reference's round key: split(rng, m + 2) -> (next rng, gossip key, ...)
            keys = jax.random.split(self.rng, M + 2)
            self.rng = keys[0]
            xi = reference_noise(keys[1], self.jstate.theta, self.ttr.compressor, M)
            noise = lambda li, ci, shape, xi=xi: torch.from_numpy(xi[(li, ci)])
        hat0 = _flat(self.jstate.consensus.theta_hat) if self.fused else None
        self.jstate, jaux = self.jtr.step(self.jstate,
                                          {k: jnp.asarray(v) for k, v in batch.items()})
        self.tstate, taux = self.ttr.step(self.tstate,
                                          {k: torch.from_numpy(v) for k, v in batch.items()},
                                          noise=noise)
        return jaux, taux, hat0, xi


def _held(name, got, want, flipped=None):
    """``got`` within REL of ``want``'s largest magnitude, except at the
    flipped indices (a boolean mask over the leaf's inner shape)."""
    bad = np.abs(got.astype(np.float64) - want) > REL * max(np.abs(want).max(), 1e-30)
    if flipped is not None:
        bad &= ~flipped[None]
    assert not bad.any(), (name, int(bad.sum()), np.argwhere(bad)[:4].tolist())


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("spec", ["none", "kq4b"])
def test_trainer_rounds_match_reference(arch, spec, capsys):
    run = _Rounds(arch, spec)
    assert run.ttr.gamma == pytest.approx(run.jtr.gamma, rel=1e-12)
    flipped = {}  # leaf index -> inner-shape mask of indices one level apart
    for r in range(STEPS):
        jaux, taux, jhat0, _ = run.next()
        assert _rel(taux["losses"].numpy(), jaux["losses"]) <= REL
        assert _rel(taux["lambda_mean"].numpy(), jaux["lambda_mean"]) <= REL
        assert float(taux["consensus_err"]) == pytest.approx(float(jaux["consensus_err"]),
                                                            rel=ERR_REL)
        jtheta = _flat(run.jstate.theta)
        ttheta = [t.numpy() for t in leaves(run.tstate.theta)]
        if run.fused:
            jhat = _flat(run.jstate.consensus.theta_hat)
            that = [t.numpy() for t in leaves(run.tstate.consensus.theta_hat)]
            for li, name in enumerate(run.names):
                mask = flipped.setdefault(li, np.zeros(jhat[li].shape[1:], bool))
                diff = that[li].astype(np.float64) - jhat[li]
                off = np.abs(diff) > REL * max(np.abs(jhat[li]).max(), 1e-30)
                new = off & ~mask[None]
                # a new flip sits exactly one level of this round's residual apart
                level = np.broadcast_to(_level(jtheta[li] - jhat0[li]), diff.shape)
                gap = np.abs(np.abs(diff[new]) - level[new])
                assert (gap <= REL * max(np.abs(jhat[li]).max(), 1e-30)).all(), (
                    r, name, np.argwhere(new)[:4].tolist(), diff[new][:4], level[new][:4])
                mask |= new.any(0)
                assert mask.mean() <= NORM_FLIPS, (r, name, int(mask.sum()), mask.size)
            for li, (name, a, b) in enumerate(zip(run.names, _flat(run.jstate.consensus.s),
                                                  leaves(run.tstate.consensus.s))):
                _held((r, name), b.numpy(), a, flipped[li])
        for li, (name, a, b) in enumerate(zip(run.names, jtheta, ttheta)):
            _held((r, name), b, a, flipped.get(li))
    n = sum(int(v.sum()) for v in flipped.values())
    with capsys.disabled():
        print(f"\n{arch} {spec}: {n} element(s) one quantization level apart (floor-boundary "
              f"flips), at most NORM_FLIPS = {NORM_FLIPS} of each leaf")
    assert run.ttr.bits_per_round(run.tstate) == run.jtr.bits_per_round(run.jstate)


def test_level_flip_is_a_floor_boundary():
    """qwen3-4b under ``kq4b``, the first round: every element whose
    theta_hat differs between the port and the reference is one where the
    reference's own residual r (theta_hat starts at 0, so r is the averaged
    theta) and noise ξ floor to different levels under the two sides' norms
    of r, ``floor(|r|·(2^b/‖r‖) + ξ)`` in f32, and ``|r|·2^b/‖r‖ + ξ`` lies
    within ULPS ulps of that integer; and every such element differs."""
    run = _Rounds("qwen3-4b", "kq4b")
    _, _, jhat0, xi = run.next()
    jtheta = _flat(run.jstate.theta)
    jhat = _flat(run.jstate.consensus.theta_hat)
    that = [t.numpy() for t in leaves(run.tstate.consensus.theta_hat)]
    found = 0
    for li, name in enumerate(run.names):
        assert not jhat0[li].any()
        resid = (jtheta[li] - jhat0[li]).astype(np.float32).reshape(M, -1)
        d = resid.shape[1]
        jnorm = np.asarray(jax.vmap(lambda a: jnp.linalg.norm(a))(jnp.asarray(resid)))
        tnorm = node_norms(torch.from_numpy(resid)).numpy()
        noise = xi[(li, None)].reshape(M, -1)[:, :d]
        args = [np.abs(resid) * encode_scale(torch.from_numpy(n), BITS).numpy()[:, None] + noise
                for n in (jnorm, tnorm)]
        floors = [np.minimum(np.floor(a), (1 << BITS) - 1) for a in args]
        boundary = floors[0] != floors[1]
        off = (np.abs(that[li].astype(np.float64) - jhat[li]).reshape(M, -1)
               > REL * max(np.abs(jhat[li]).max(), 1e-30))
        np.testing.assert_array_equal(off, boundary, err_msg=name)
        for node, e in np.argwhere(boundary):
            top = max(floors[0][node, e], floors[1][node, e])
            ulps = max(abs(float(a[node, e]) - top) / np.spacing(np.float32(top))
                       for a in args)
            print(f"{name} node {node} element {e}: |r| {abs(resid[node, e]):.9g}, norms "
                  f"{jnorm[node]:.9g} / {tnorm[node]:.9g}, xi {noise[node, e]:.9g}, floor "
                  f"arguments {args[0][node, e]:.9g} / {args[1][node, e]:.9g}, {ulps:.1f} ulps "
                  f"from {top:g}")
            assert ulps <= ULPS, (name, node, e, ulps)
        found += int(boundary.sum())
    print(f"qwen3-4b kq4b round 0: {found} floor-boundary flip(s)")


# ------------------------------------------------------------------ the CLI
CLI = ["--reduced", "--nodes", str(M), "--batch-per-node", "2", "--seq", "16", "--steps",
       str(STEPS), "--compressor", "none"]
CLI_ARCH = "granite-20b"  # MQA, GELU MLP


def test_train_cli_matches_reference_cli(tmp_path, monkeypatch):
    """The port's CLI from the reference's initial tree against the
    reference CLI on granite-20b: the metrics file's losses, worst loss and
    consensus error."""
    want_path, got_path = tmp_path / "jax.json", tmp_path / "torch.json"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "argv", ["train", "--arch", CLI_ARCH, *CLI,
                                 "--metrics-out", str(want_path)])
        jtrain.main()
    want = json.loads(want_path.read_text())
    jparams = JT.init_model(jax.random.PRNGKey(0), jax_config(CLI_ARCH).reduced())
    monkeypatch.setattr(ttrain.T, "init_train_params",
                        lambda cfg, seed=0, device="cpu": _to_torch(jparams))
    res = ttrain.main(["--arch", CLI_ARCH, *CLI, "--device", "cpu",
                       "--metrics-out", str(got_path)])
    got = json.loads(got_path.read_text())
    assert set(got) == set(want) and got["final_step"] == want["final_step"] == STEPS
    assert len(res["history"]) == STEPS
    assert _rel(got["losses"], want["losses"]) <= REL
    assert got["worst_loss"] == pytest.approx(want["worst_loss"], rel=REL)
    assert got["consensus_err"] == pytest.approx(want["consensus_err"], rel=ERR_REL)


# ------------------------------------------------ phase 19, rehearsed on the CPU
ROOT = Path(__file__).resolve().parents[1]


def _counting(module, name, counter):
    """``module.name`` (a plain version) that also adds one to ``counter``,
    as its kernel's wrapper does on the card."""
    real = getattr(module, name)

    def plain(*a, **kw):
        counter.add()
        return real(*a, **kw)

    return plain


def test_phase19_rows_rehearsed_on_the_cpu(monkeypatch):
    """``chip_smoke.py``'s ``zoo_trains`` over its rows of the four configs,
    at reduced width with ``--device cpu``: each row's depth cut, llama4
    packed beside fused with its routing pinned, command-r and llama4's
    round 1 under the profiler, and ``train_family``'s own checks (launches
    = the chunk plan x the rounds, bits exact, finite losses, packed =
    fused at step 0 and within 1e-3 at step 1)."""
    from repro_torch import configs
    from repro_torch.kernels import _build, choco_fused
    from repro_torch.launch import serve

    # the module, not the function the package exports under its name
    quantize = importlib.import_module("repro_torch.kernels.quantize")
    monkeypatch.syspath_prepend(str(ROOT))
    import chip_smoke as cs

    full = configs.get_config
    reduced = lambda name: full(name).reduced()
    for mod in (configs, ttrain, serve):
        monkeypatch.setattr(mod, "get_config", reduced)
    for name in ("empty_cache", "reset_peak_memory_stats", "synchronize"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **kw: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a, **kw: 0)
    monkeypatch.setattr(cs, "gpu_name_and_limit", lambda: "CPU rehearsal")
    monkeypatch.setattr(cs, "_profile_breakdown", lambda prof, wall, host=None: {
        "wall_ms": 1.0, "busy_ms": 0.0, "busy": {}, "spans_ms": {}, "read_s": 0.0, "top": []})
    for module, name, counter in (
            (choco_fused, "fused_encode_plain", choco_fused.encode_launches),
            (choco_fused, "fused_mix_plain", choco_fused.mix_launches),
            (quantize, "quantize_plain", quantize.quantize_launches),
            (quantize, "dequantize_plain", quantize.dequantize_launches)):
        monkeypatch.setattr(module, name, _counting(module, name, counter))
    rows = tuple(row for row in cs.P19_RUNS if row[0] in ARCHS)
    assert [row[0] for row in rows] == list(ARCHS)
    assert cs.LLAMA4 in cs.P19_PACKED
    assert {"command-r-35b", cs.LLAMA4} <= set(cs.P19_PROFILED)
    monkeypatch.setattr(cs, "P19_RUNS", rows)
    monkeypatch.setattr(cs, "P19_ARGS", cs.P19_ARGS + ["--device", "cpu"])
    try:
        total = cs.zoo_trains()
    finally:
        _build.reset_launch_counts()
    want = {"fused_encode": 0, "fused_mix": 0, "quantize": 0, "dequantize": 0}
    for arch, m, _, layers in rows:
        cfg = dataclasses.replace(reduced(arch), num_layers=layers or reduced(arch).num_layers)
        n = cs._chunk_plan(cfg, m) * STEPS
        k = len(ring(m).shifts)
        want["fused_encode"] += n
        want["fused_mix"] += n * -(-k // choco_fused.SHIFT_BATCH)
        if arch in cs.P19_PACKED:
            want["quantize"] += m * n
            want["dequantize"] += m * (1 + k) * n
    assert {k: total.get(k, 0) for k in want} == want
