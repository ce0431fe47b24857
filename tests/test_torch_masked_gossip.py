"""repro_torch's time-varying CHOCO round against the JAX package, on the
CPU: ``choco_round(mixing=, mask=)`` -- the memory-full masked round --
for ``none``, ``q4b``, ``kq4b`` and ``btop25`` on a small stacked tree whose
leaves take every branch of the chunk plan, with the reference's noise and
masks injected; a dropped node's theta, theta_hat and s stay as they were;
a static schedule stays bit-identical to the static path; the fused round
refuses a time-varying wire; the two-lane round.

Tolerance as ``tests/test_torch_gossip.py``: 1e-6 of each leaf's largest
magnitude (the dense W(t) products sum in another order), with up to
NORM_FLIPS of the quantized elements one level apart.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.core import gossip as jg
from repro.core import topology as jtopo
from repro.core.compression import make_compressor as jax_compressor
from repro_torch.configs import get_config as torch_config
from repro_torch.core import gossip, topology
from repro_torch.core.compression import make_compressor
from repro_torch.core.trainer import ChocoConsensus
from repro_torch.launch import steps as tsteps
from repro_torch.models import transformer as TT
from repro_torch.tree import leaves, unflatten
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

NORM_FLIPS = 1e-3
BLOCK = 256


def _tree(m: int, seed: int):
    rng = np.random.default_rng(seed)
    shapes = {"w": (m, 1000), "blocks": [{"a": (m, 6, 100), "b": (m, 3, 260)}], "z": (m, 7)}
    return jax.tree.map(lambda s: rng.standard_normal(s).astype(np.float32), shapes,
                        is_leaf=lambda x: isinstance(x, tuple))


def _chunk_inner(shape, plan):
    axis, chunks, rows = plan
    if axis == 1:
        return (rows,) + tuple(shape[2:])
    return tuple(shape[1:-1]) + (rows,)


def _noise(key, tree, compressor, m):
    """The reference's per-encode noise: {(leaf, chunk): xi [m, ...]}."""
    flat = jax.tree_util.tree_leaves(tree)
    out = {}
    for li, (leaf, k) in enumerate(zip(flat, jax.random.split(key, len(flat)))):
        plan = jg._scan_plan(leaf.shape, int(np.prod(leaf.shape[1:])), BLOCK)
        parts = [(None, k, leaf.shape[1:])] if plan is None else [
            (c, kb, _chunk_inner(leaf.shape, plan))
            for c, kb in enumerate(jax.random.split(k, plan[1]))]
        for ci, kc, inner_shape in parts:
            shape = compressor.noise_shape(m, inner_shape)
            if shape is not None:
                out[(li, ci)] = np.stack([np.asarray(jax.random.uniform(nk, shape[1:]))
                                          for nk in jax.random.split(kc, m)])
    return out


def _to_t(tree):
    return unflatten(tree, [torch.from_numpy(np.array(x)) for x in jax.tree_util.tree_leaves(tree)])


def _strong_lam(jstate):
    """The reference's initial lambda is weakly typed and every later
    round's is not, so its jitted step would compile twice; a strong f32
    lambda (the same values) compiles it once."""
    return jstate._replace(lam=jnp.asarray(jstate.lam, jnp.float32))


def _close(ref, got, what):
    ref, got = np.asarray(ref), got.numpy()
    bad = np.abs(got - ref) > 1e-6 * np.abs(ref).max()
    assert bad.mean() <= NORM_FLIPS, f"{what}: {bad.sum()} of {bad.size} elements off"


@pytest.mark.parametrize("spec", ["none", "q4b", "kq4b", "btop25"])
@pytest.mark.parametrize("sched,mask", [
    ("roundrobin:ring,torus", None), ("roundrobin:ring,torus", (1, 0, 1, 1, 0, 1)),
    ("matching:4", (0, 1, 1, 1, 1, 1)), ("ring", (1, 1, 0, 1, 1, 1)),
], ids=["rr-all-alive", "rr-masked", "matching-masked", "ring-masked"])
def test_masked_round_matches_reference(spec, sched, mask):
    m, t = 6, 3
    theta = _tree(m, 0)
    hat = jax.tree.map(lambda x: 0.5 * x[::-1].copy(), _tree(m, 1))
    s = _tree(m, 2)
    key = jax.random.PRNGKey(7)
    js = jtopo.make_topology_schedule(sched, m, dropout=0.0 if mask is None else 0.2)
    ts = topology.make_topology_schedule(sched, m, dropout=0.0 if mask is None else 0.2)
    jmask = None if mask is None else jnp.asarray(mask, jnp.float32)
    tmask = None if mask is None else torch.tensor(mask, dtype=torch.float32)
    jt, jst = jg.choco_round(
        jax.tree.map(jnp.asarray, theta),
        jg.CHOCOState(theta_hat=jax.tree.map(jnp.asarray, hat), s=jax.tree.map(jnp.asarray, s)),
        js.topology_at(t), 0.2, jax_compressor(spec), key, block_scan_elems=BLOCK,
        mixing=js.mixing_at(t, jmask), mask=jmask)
    comp = make_compressor(spec)
    xi = _noise(key, theta, comp, m)
    state = gossip.CHOCOState(theta_hat=_to_t(hat), s=_to_t(s))
    tt, tst = gossip.choco_round(_to_t(theta), state, ts.topology_at(t), 0.2, comp,
                                 noise=lambda li, ci, shape: torch.from_numpy(xi[(li, ci)]),
                                 block_scan_elems=BLOCK, mixing=ts.mixing_at(t, tmask),
                                 mask=tmask)
    for name, a, b in (("theta", jt, tt), ("theta_hat", jst.theta_hat, tst.theta_hat),
                       ("s", jst.s, tst.s)):
        for i, (x, y) in enumerate(zip(jax.tree_util.tree_leaves(a), leaves(b))):
            _close(x, y, f"{spec} {name} leaf {i}")
    if mask is not None:  # a dropped node's state is untouched, bit for bit
        dead = [i for i, a in enumerate(mask) if a == 0]
        for before, after in ((theta, tt), (hat, tst.theta_hat), (s, tst.s)):
            for x, y in zip(jax.tree_util.tree_leaves(before), leaves(after)):
                np.testing.assert_array_equal(y.numpy()[dead], x[dead])


def test_mask_without_mixing_reweights_the_static_graph():
    m = 5
    theta = {"w": torch.randn(m, 40, generator=torch.Generator().manual_seed(0))}
    mask = torch.tensor([1.0, 1.0, 0.0, 1.0, 1.0])
    a = gossip.choco_round({"w": theta["w"].clone()}, gossip.choco_init(theta),
                           topology.ring(m), 0.3, make_compressor("none"), mask=mask)
    b = gossip.choco_round({"w": theta["w"].clone()}, gossip.choco_init(theta),
                           topology.ring(m), 0.3, make_compressor("none"),
                           mixing=topology.masked_metropolis(topology.ring(m).adjacency, mask),
                           mask=mask)
    assert torch.equal(a[0]["w"], b[0]["w"]) and torch.equal(a[1].s["w"], b[1].s["w"])


def test_fused_refuses_a_time_varying_round():
    theta = {"w": torch.zeros(4, 300)}
    with pytest.raises(ValueError, match="masked path"):
        gossip.choco_round(theta, gossip.choco_init(theta), topology.ring(4), 0.1,
                           make_compressor("kq4b"), generator=torch.Generator(), fused=True,
                           mask=torch.ones(4))
    sched = topology.make_topology_schedule("ring", 4, dropout=0.1)
    with pytest.raises(ValueError, match="masked path"):
        ChocoConsensus(sched, make_compressor("kq4b"), fused=True)
    with pytest.raises(ValueError, match="masked path"):
        tsteps.make_trainer(torch_config("qwen3-1.7b").reduced(), 4, compressor="kq4b",
                            topology_schedule="roundrobin:ring,torus", fused_gossip=True,
                            device="cpu")


@pytest.mark.parametrize("spec,fused", [("kq4b", False), ("kq4b", True), ("q4b", False)])
def test_static_schedule_is_the_static_path_bit_for_bit(spec, fused):
    """``--topology-schedule ring`` unwraps to the ring: the same packed /
    fused round, the same draws, the same bits."""
    cfg = torch_config("qwen3-1.7b").reduced(layers=1, d_model=32)
    outs = []
    for extra in ({}, {"topology_schedule": "ring"}):
        tr = tsteps.make_trainer(cfg, 3, compressor=spec, fused_gossip=fused, device="cpu",
                                 **extra)
        assert tr.schedule is None and tr.topology.shifts is not None
        state = tr.init(TT.init_train_params(cfg, seed=0, device="cpu"), seed=1)
        tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size,
                                                                    (3, 2, 8)))
        for _ in range(2):
            state, aux = tr.step(state, {"tokens": tokens})
        outs.append((leaves(state.theta) + leaves(state.consensus.theta_hat)
                     + leaves(state.consensus.s), aux["losses"], tr.bits_per_round(state)))
    (a, la, ba), (b, lb, bb) = outs
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert torch.equal(la, lb) and ba == bb


def test_lanes_are_rounds_in_lane_order():
    """A two-lane round equals two single-lane rounds on one generator, the
    model lane first."""
    m = 4
    gen = lambda: torch.Generator().manual_seed(3)
    base = [{"w": torch.randn(m, 500, generator=torch.Generator().manual_seed(i))}
            for i in range(2)]
    comp = make_compressor("kq4b")
    lanes = [({"w": b["w"].clone()}, gossip.choco_init(b), g, comp)
             for b, g in zip(base, (0.3, 0.2))]
    (x, y), _ = gossip.choco_round_lanes(lanes, topology.ring(m), gen())
    g = gen()
    want = [gossip.choco_round({"w": b["w"].clone()}, gossip.choco_init(b), topology.ring(m),
                               gam, comp, generator=g)[0]["w"]
            for b, gam in zip(base, (0.3, 0.2))]
    assert torch.equal(x["w"], want[0]) and torch.equal(y["w"], want[1])


def test_payload_bits_modes_match_reference():
    m = 10
    tmpl_t = {"w": torch.empty(m, 16, 4), "b": torch.empty(m, 4)}
    tmpl_j = {"w": jnp.zeros((m, 16, 4)), "b": jnp.zeros((m, 4))}
    mask = np.array([1, 1, 0, 1, 1, 1, 0, 1, 1, 1], np.float32)
    for spec in ("rr:ring,torus", "matching", "ring"):
        spec = spec.replace("rr:", "roundrobin:")
        js = jtopo.make_topology_schedule(spec, m, dropout=0.3)
        ts = topology.make_topology_schedule(spec, m, dropout=0.3)
        for mode in ("max", "expected", "realized"):
            kw = {"step": 1, "mask": mask} if mode == "realized" else {}
            assert gossip.payload_bits(make_compressor("q4b"), tmpl_t, ts, mode=mode, **kw) \
                == jg.payload_bits(jax_compressor("q4b"), tmpl_j, js, mode=mode, **kw)
    with pytest.raises(ValueError, match="needs the round's participation mask"):
        gossip.payload_bits(make_compressor("q4b"), tmpl_t, ts, mode="realized")


def test_adgda_with_dropout_matches_reference():
    """The trainer's masked round at reduced qwen3 (f32, 2 layers, d_model
    64, 4 nodes, 3 rounds, ``kq4b``, round-robin ring + torus, 30% dropout,
    momentum): the reference's masks and noise injected (its key layout:
    next rng, gossip key, mask key, node keys).  Losses and lambda within
    1e-5 relative, theta within 1e-5 of each leaf's largest magnitude; a
    dropped node's theta and momentum are the round's input, bit for bit."""
    from repro.configs import get_config as jax_config
    from repro.data import node_token_stream
    from repro.launch import steps as jsteps
    from repro.models import transformer as JT

    m, rel = 4, 1e-5
    kw = dict(compressor="kq4b", topology_schedule="roundrobin:ring,torus", dropout=0.3,
              momentum=0.9)
    jcfg = jax_config("qwen3-1.7b").reduced(layers=2, d_model=64)
    tcfg = torch_config("qwen3-1.7b").reduced(layers=2, d_model=64)
    jtr, ttr = jsteps.make_trainer(jcfg, m, **kw), tsteps.make_trainer(tcfg, m, device="cpu",
                                                                        **kw)
    jparams = JT.init_model(jax.random.PRNGKey(0), jcfg)
    jstate = _strong_lam(jtr.init(jparams, jax.random.PRNGKey(2)))
    tstate = ttr.init(_to_t(jparams), seed=0)
    stream = node_token_stream(m, 2, 8, jcfg.vocab_size, seed=0)
    dropped_any = False
    for _ in range(3):
        tokens = next(stream)
        keys = jax.random.split(jstate.rng, m + 3)
        mask = np.asarray(jtr.schedule.mask_at(keys[2], jstate.step))
        flat = jax.tree_util.tree_leaves(jstate.theta)
        xi = {}
        for li, (leaf, k) in enumerate(zip(flat, jax.random.split(keys[1], len(flat)))):
            shape = ttr.compressor.noise_shape(m, leaf.shape[1:])
            xi[(li, None)] = np.stack([np.asarray(jax.random.uniform(nk, shape[1:]))
                                       for nk in jax.random.split(k, m)])
        dead = mask == 0
        before = [x.numpy()[dead].copy() for x in leaves(tstate.theta) + tstate.opt.mu]
        jstate, jaux = jtr.step(jstate, {"tokens": jnp.asarray(tokens)})
        tstate, taux = ttr.step(tstate, {"tokens": torch.from_numpy(tokens)}, mask=mask,
                                noise=lambda li, ci, shape: torch.from_numpy(xi[(li, ci)]))
        np.testing.assert_array_equal(taux["participation"].numpy(),
                                      np.asarray(jaux["participation"]))
        for name in ("losses", "lambda_mean"):
            ref = np.asarray(jaux[name], np.float64)
            assert np.abs(taux[name].numpy() - ref).max() <= rel * np.abs(ref).max()
        assert taux["bits_realized"] == pytest.approx(float(jaux["bits_realized"]), rel=1e-7)
        after = [x.numpy()[dead] for x in leaves(tstate.theta) + tstate.opt.mu]
        assert all(np.array_equal(a, b) for a, b in zip(before, after))
        dropped_any |= bool(dead.any())
    assert dropped_any
    for a, b in zip(jax.tree_util.tree_leaves(jstate.theta), leaves(tstate.theta)):
        _close(a, b, "theta")
    for mode in ("max", "expected"):
        assert ttr.bits_per_round(tstate, mode=mode) == jtr.bits_per_round(jstate, mode=mode)
