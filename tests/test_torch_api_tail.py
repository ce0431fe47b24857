"""The tail of the reference's public API in the port, held against the JAX
package: every name the reference's ``core``, ``core.adgda``,
``core.baselines``, ``core.dro``, ``core.compression`` and ``kernels``
export; the chi^2 and KL regularizers (values and gradients within 1e-6);
``compress_pytree`` EXACT (``q4b`` on the reference's per-leaf uniforms:
its levels and signs exact, its values within 1e-6, each side summing its
own norm);
the deprecated shims ``ADGDA``, ``DRDSGD``, ``DRFA`` (a DeprecationWarning,
then the factory-built trainer's rounds bit for bit) and the state aliases;
Adam over 5 steps within 1e-6 relative; and an import of
``repro_torch.kernels`` that builds nothing."""
import importlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.core import compression as jcomp
from repro.core import dro as jdro
from repro.optim import adam as jadam
from repro_torch.core import (
    ADGDA,
    DRDSGD,
    DRFA,
    ADGDAConfig,
    ADGDAState,
    DecentralizedTrainer,
    DRDSGDConfig,
    DRFAConfig,
    TrainerState,
    adgda_trainer,
    drdsgd_trainer,
    drfa_trainer,
)
from repro_torch.core import compression as tcomp
from repro_torch.core import dro as tdro
from repro_torch.core.baselines import DRDSGDState, DRFAState
from repro_torch.optim import adam as tadam
from repro_torch.tree import leaves
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
M = 6


@pytest.mark.parametrize("module", ["core", "core.adgda", "core.baselines", "core.dro",
                                    "core.compression", "kernels"])
def test_every_reference_name_is_in_the_port(module):
    ref = importlib.import_module(f"repro.{module}")
    port = importlib.import_module(f"repro_torch.{module}")
    missing = [n for n in ref.__all__ if not hasattr(port, n)]
    assert not missing
    assert set(ref.__all__) <= set(port.__all__)
    if module == "kernels":  # the ops wrappers, not the submodules of the same names
        assert all(callable(getattr(port, n)) for n in ref.__all__)


# ------------------------------------------------------------ regularizers
def _lams(seed: int, m: int = 5, k: int = 4) -> np.ndarray:
    x = np.random.default_rng(seed).random((k, m)).astype(np.float32) + 0.05
    return x / x.sum(1, keepdims=True)


@pytest.mark.parametrize("name", ["chi2", "kl"])
def test_regularizer_values_and_gradients(name):
    """Seeded lambdas on the simplex: r(lambda) and its gradient against the
    reference's (``jax.grad``) within 1e-6; zero at the prior, negative
    elsewhere, concave along a segment (the reference's ``test_dro.py``)."""
    jreg, treg = getattr(jdro, f"{name}_regularizer"), getattr(tdro, f"{name}_regularizer")
    assert treg is tdro.make_regularizer(name) and treg.name == name
    for seed in range(3):
        lam, prior = _lams(seed), _lams(seed + 10)[0]
        for row in lam:
            want = float(jreg(jnp.asarray(row), jnp.asarray(prior)))
            assert float(treg(torch.from_numpy(row), torch.from_numpy(prior))) == pytest.approx(
                want, abs=1e-6)
            g_want = np.asarray(jreg.grad(jnp.asarray(row), jnp.asarray(prior)))
            g = treg.grad(torch.from_numpy(row), torch.from_numpy(prior)).numpy()
            np.testing.assert_allclose(g, g_want, rtol=0, atol=1e-6 * max(1.0, np.abs(
                g_want).max()))
    prior = torch.full((4,), 0.25)
    assert float(treg(prior, prior)) == pytest.approx(0.0)
    assert float(treg(torch.tensor([0.7, 0.1, 0.1, 0.1]), prior)) < 0
    prior5 = torch.full((5,), 0.2)
    a = torch.tensor([0.6, 0.1, 0.1, 0.1, 0.1])
    b = torch.tensor([0.1, 0.1, 0.1, 0.1, 0.6])
    mid = treg(0.5 * a + 0.5 * b, prior5)
    assert float(mid) >= 0.5 * float(treg(a, prior5)) + 0.5 * float(treg(b, prior5)) - 1e-6


# --------------------------------------------------------- compress_pytree
def _tree(seed: int = 3) -> dict:
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((8, 16)).astype(np.float32),
            "b": rng.standard_normal((37,)).astype(np.float32),
            "c": {"d": rng.standard_normal((5, 3, 4)).astype(np.float32)}}


@pytest.mark.parametrize("spec", ["none", "top25", "btop25", "q4b"])
def test_compress_pytree_against_the_reference(spec):
    """Q(tree) leaf by leaf, EXACT; ``q4b`` on each leaf's uniforms from the
    reference's split key (its own draw for leaf i:
    ``uniform(split(key, n)[i], leaf.shape)``), where the norms, summed in
    each side's order, leave the values a last bit apart: levels and signs
    exact, values within 1e-6 of the leaf's largest."""
    tree = _tree()
    key = jax.random.PRNGKey(11)
    jtree = jax.tree.map(jnp.asarray, tree)
    want = jcomp.compress_pytree(jcomp.make_compressor(spec), jtree, key)
    ttree = {"a": torch.from_numpy(tree["a"]), "b": torch.from_numpy(tree["b"]),
             "c": {"d": torch.from_numpy(tree["c"]["d"])}}
    flat = jax.tree_util.tree_leaves(jtree)
    keys = jax.random.split(key, len(flat))
    noise = [np.asarray(jax.random.uniform(k, x.shape)) for k, x in zip(keys, flat)]
    got = tcomp.compress_pytree(tcomp.make_compressor(spec), ttree, noise=noise)
    assert got.keys() == ttree.keys() and got["c"].keys() == {"d"}
    comp = tcomp.make_compressor(spec)
    for x, g, w in zip(flat, leaves(got), jax.tree_util.tree_leaves(want)):
        w, g = np.asarray(w), g.numpy()
        assert g.shape == w.shape and g.dtype == np.float32
        if spec != "q4b":
            np.testing.assert_array_equal(g, w)
            continue
        # each side sums its own norm, in its own order (a last bit apart):
        # the levels and signs are equal, the values within 1e-6 of the leaf
        x = np.asarray(x)
        unit = 2.0**comp.bits * comp._tau(x.size)
        levels = [np.rint(np.abs(v) * unit / n) for v, n in
                  ((g, float(torch.linalg.vector_norm(torch.from_numpy(x)))),
                   (w, float(jnp.sqrt(jnp.sum(jnp.asarray(x) ** 2)))))]
        np.testing.assert_array_equal(levels[0], levels[1])
        np.testing.assert_array_equal(np.signbit(g), np.signbit(w))
        assert np.abs(g - w).max() <= 1e-6 * np.abs(w).max()


def test_compress_pytree_draws_from_the_generator_in_leaf_order():
    """Without ``noise`` each leaf's uniforms come from ``generator``, leaf
    after leaf: the same as injecting those draws."""
    tree = {k: torch.from_numpy(v) for k, v in _tree().items() if k != "c"}
    comp = tcomp.make_compressor("q4b")
    got = tcomp.compress_pytree(comp, tree, torch.Generator().manual_seed(5))
    gen = torch.Generator().manual_seed(5)
    noise = [torch.rand((1,) + tuple(x.shape), generator=gen) for x in leaves(tree)]
    want = tcomp.compress_pytree(comp, tree, noise=[n[0].numpy() for n in noise])
    for g, w in zip(leaves(got), leaves(want)):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="generator or noise"):
        tcomp.compress_pytree(comp, tree)


# ------------------------------------------------------- deprecated shims
def _quadratic():
    def loss_fn(params, batch, rng):
        return 0.5 * torch.sum((params["w"] - batch["mu"]) ** 2)

    return loss_fn, {"mu": torch.tensor([[-3.0], [0.0], [0.0], [0.0], [0.0], [3.0]])}


def _three_rounds(tr, batch):
    state = tr.init({"w": torch.zeros(1)}, seed=0)
    out = []
    for _ in range(3):
        state, aux = tr.step(state, batch)
        out.append(aux["losses"])
    return state, out


@pytest.mark.parametrize("name", ["ADGDA", "DRDSGD", "DRFA"])
def test_deprecated_shims_are_the_factories(name):
    """Each shim warns ``DeprecationWarning`` with the reference's text, is a
    DecentralizedTrainer, and 3 rounds equal the factory-built trainer's bit
    for bit (the reference's ``test_trainer.py`` shim exercise)."""
    loss_fn, batch = _quadratic()
    if name == "ADGDA":
        cfg, shim, factory = ADGDAConfig(num_nodes=M, compressor="q4b"), ADGDA, adgda_trainer
    elif name == "DRDSGD":
        cfg, shim, factory = DRDSGDConfig(num_nodes=M, alpha=1.0), DRDSGD, drdsgd_trainer
    else:
        cfg, shim, factory = DRFAConfig(num_nodes=M, local_steps=2), DRFA, drfa_trainer
        batch = {"mu": batch["mu"][:, None].expand(M, 2, 1).contiguous()}
    with pytest.warns(DeprecationWarning, match=f"repro.core.{name} is deprecated"):
        tr = shim(cfg, loss_fn, device="cpu")
    assert isinstance(tr, DecentralizedTrainer) and tr.config is cfg
    ref = factory(cfg, loss_fn, device="cpu")
    (s1, l1), (s2, l2) = _three_rounds(tr, batch), _three_rounds(ref, batch)
    assert all(torch.equal(a, b) for a, b in zip(l1, l2))
    assert torch.equal(s1.theta["w"], s2.theta["w"]) and torch.equal(s1.lam, s2.lam)
    assert tr.bits_per_round(s1) == ref.bits_per_round(s2) > 0
    if name == "ADGDA":
        assert tr.regularizer is tdro.chi2_regularizer
    if name == "DRFA":
        assert tr.num_sampled == ref.consensus.num_sampled == 3


def test_state_aliases():
    assert ADGDAState is TrainerState and DRDSGDState is TrainerState
    assert DRFAState is TrainerState


# -------------------------------------------------------------------- Adam
def test_adam_against_the_reference():
    """5 Adam steps on seeded f32 gradients (one node): parameters and both
    moments within 1e-6 relative of ``repro.optim.adam``'s."""
    rng = np.random.default_rng(4)
    shapes = {"a": (7, 5), "b": (11,)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(5)]
    jopt = jadam(1e-2, weight_decay=0.01)
    jp = jax.tree.map(jnp.asarray, params)
    jstate = jopt.init(jp)
    for g in grads:
        upd, jstate = jopt.update(jax.tree.map(jnp.asarray, g), jstate, jp)
        jp = jax.tree.map(lambda p, u: p + u, jp, upd)
    topt = tadam(1e-2, weight_decay=0.01)
    names = sorted(shapes)
    tp = [torch.from_numpy(params[k].copy())[None] for k in names]  # one node
    tstate = topt.init(tp)
    for g in grads:
        tstate = topt.apply_(tp, [[torch.from_numpy(g[k])] for k in names], tstate,
                             torch.ones(1))
    assert tstate.step == 5 and int(jstate.step) == 5
    for i, k in enumerate(names):
        for got, want in ((tp[i][0], jp[k]), (tstate.mu[i][0], jstate.mu[k]),
                          (tstate.nu[i][0], jstate.nu[k])):
            want = np.asarray(want, np.float64)
            err = np.abs(got.double().numpy() - want).max()
            assert err <= 1e-6 * np.abs(want).max(), (k, err)


# ----------------------------------------------------------------- kernels
def test_importing_the_kernels_package_builds_nothing():
    """A fresh interpreter imports ``repro_torch.kernels`` (and every wrapper
    it exports) without starting a process (no nvcc) or loading a library."""
    probe = (
        "import subprocess\n"
        "calls = []\n"
        "class Spy(subprocess.Popen):\n"
        "    def __init__(self, *a, **k):\n"
        "        calls.append(a)\n"
        "        super().__init__(*a, **k)\n"
        "subprocess.Popen = Spy\n"
        "import repro_torch.kernels as k\n"
        "from repro_torch.kernels import _build\n"
        "assert not calls and not _build._LIBS, (calls, _build._LIBS)\n"
        "assert all(callable(getattr(k, n)) for n in k.__all__ if n != 'COUNTERS')\n"
        "print('ok', len(k.__all__))\n")
    env = {**os.environ,
           "PYTHONPATH": os.pathsep.join([str(ROOT / "src"), os.environ.get("PYTHONPATH", "")])}
    run = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True,
                         timeout=120, env=env)
    assert run.returncode == 0, run.stderr[-2000:]
    assert run.stdout.strip() == "ok 13"
