"""repro_torch gossip layer and its static pieces against the JAX package,
on the CPU: ``choco_round`` (Identity, q4b, kq4b packed, kq4b fused) on a
small stacked tree whose leaves take every branch of the chunk plan; the
chunk plan, encode size, gamma and bit counts at the reduced and the full
qwen3-1.7b (shapes only); topologies; the DRO dual; schedules and SGD; the
synthetic data.

Rounds: the port is fed the ``xi`` of the reference's key stream (per leaf
``split(key, n_leaves)``, per chunk ``split``, per node ``split(k, m)``,
then ``uniform``).  Each side takes its own norms (``jnp.linalg.norm`` and
``torch.linalg.vector_norm`` sum in different orders), and XLA may contract
the f32 averaging step into an FMA; so theta, theta_hat and s are held to
1e-6 of each leaf's largest magnitude, except that up to NORM_FLIPS of the
quantized elements may sit one level apart (a level at a floor boundary
flipped by a last-bit norm difference).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import get_config as jax_config
from repro.core import dro as jdro
from repro.core import gossip as jg
from repro.core import topology as jtopo
from repro.core.compression import make_compressor as jax_compressor
from repro.core.trainer import ChocoConsensus as JChoco
from repro.data import node_token_stream as jax_tokens
from repro.data import rotated_minority_classification as jax_rotated
from repro.launch import steps as jsteps
from repro.optim import make_schedule as jax_schedule
from repro.optim import sgd as jax_sgd
from repro_torch.configs import get_config as torch_config
from repro_torch.core import dro, gossip, topology
from repro_torch.core.compression import make_compressor
from repro_torch.core.trainer import ChocoConsensus
from repro_torch.data import node_token_stream, rotated_minority_classification
from repro_torch.launch import steps as tsteps
from repro_torch.models import transformer as TT
from repro_torch.optim import OptState, make_schedule, sgd
from repro_torch.tree import leaves, unflatten
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

LANES = 128
NORM_FLIPS = 1e-3
BLOCK = 256  # test-sized BLOCK_SCAN_ELEMS: leaves above it are chunked


def _tree(m: int, seed: int):
    """Leaves for every branch of the chunk plan at BLOCK: a last-axis split
    ([m, 1000] -> 4 x 250), a layer-stack split ([m, 6, 100] -> 3 x 2
    layers; [m, 3, 260] -> 3 x 1), and a small ragged leaf kept whole."""
    rng = np.random.default_rng(seed)
    shapes = {"w": (m, 1000), "blocks": [{"a": (m, 6, 100), "b": (m, 3, 260)}], "z": (m, 7)}
    return jax.tree.map(lambda s: rng.standard_normal(s).astype(np.float32), shapes,
                        is_leaf=lambda x: isinstance(x, tuple))


def _noise(key, tree, compressor, m):
    """The reference's per-encode noise, keyed like ``choco_round``'s stream:
    {(leaf, chunk): xi [m, ...]}."""
    flat = jax.tree_util.tree_leaves(tree)
    out = {}
    for li, (leaf, k) in enumerate(zip(flat, jax.random.split(key, len(flat)))):
        inner = int(np.prod(leaf.shape[1:]))
        plan = jg._scan_plan(leaf.shape, inner, BLOCK)
        parts = [(None, k, leaf.shape[1:])] if plan is None else [
            (c, kb, _chunk_inner(leaf.shape, plan)) for c, kb in
            enumerate(jax.random.split(k, plan[1]))]
        for ci, kc, inner_shape in parts:
            shape = compressor.noise_shape(m, inner_shape)
            if shape is not None:
                out[(li, ci)] = np.stack([np.asarray(jax.random.uniform(nk, shape[1:]))
                                          for nk in jax.random.split(kc, m)])
    return out


def _chunk_inner(shape, plan):
    axis, chunks, rows = plan
    if axis == 1:
        return (rows,) + tuple(shape[2:])
    return tuple(shape[1:-1]) + (rows,)


def _close(ref, got, what):
    ref, got = np.asarray(ref), got.numpy()
    bad = np.abs(got - ref) > 1e-6 * np.abs(ref).max()
    assert bad.mean() <= NORM_FLIPS, f"{what}: {bad.sum()} of {bad.size} elements off"


@pytest.mark.parametrize("spec,packed,fused", [
    ("none", True, False), ("q4b", True, False), ("q4b", False, False),
    ("kq4b", True, False), ("kq4b", True, True),
])
def test_choco_round_matches_reference(spec, packed, fused):
    m = 4
    theta = _tree(m, 0)
    hat = jax.tree.map(lambda x: 0.5 * x[::-1].copy(), _tree(m, 1))
    s = _tree(m, 2)
    key = jax.random.PRNGKey(3)
    jstate = jg.CHOCOState(theta_hat=jax.tree.map(jnp.asarray, hat), s=jax.tree.map(jnp.asarray, s))
    jt, js = jg.choco_round(jax.tree.map(jnp.asarray, theta), jstate, jtopo.ring(m), 0.2,
                            jax_compressor(spec), key, packed=packed, fused=fused,
                            block_scan_elems=BLOCK)
    comp = make_compressor(spec)
    xi = _noise(key, theta, comp, m)
    to_t = lambda tree: unflatten(tree, [torch.from_numpy(np.array(x))
                                         for x in jax.tree_util.tree_leaves(tree)])
    state = gossip.CHOCOState(theta_hat=to_t(hat), s=to_t(s))
    drawn = []

    def noise(li, ci, shape):
        drawn.append((li, ci))
        return torch.from_numpy(xi[(li, ci)])

    tt, ts = gossip.choco_round(to_t(theta), state, topology.ring(m), 0.2, comp, noise=noise,
                                packed=packed, fused=fused, block_scan_elems=BLOCK)
    assert drawn == list(xi)  # one draw per encode, in the reference's order
    if spec != "none":
        assert len(drawn) == 4 + 3 + 3 + 1
    for name, a, b in (("theta", jt, tt), ("theta_hat", js.theta_hat, ts.theta_hat),
                       ("s", js.s, ts.s)):
        for i, (x, y) in enumerate(zip(jax.tree_util.tree_leaves(a), leaves(b))):
            _close(x, y, f"{spec} {name} leaf {i}")


def test_fused_needs_a_kernel_compressor_and_a_circulant_topology():
    theta = {"w": torch.zeros(4, 300)}
    state = gossip.choco_init(theta)
    with pytest.raises(ValueError, match="fused gossip needs a kernel compressor"):
        gossip.choco_round(theta, state, topology.ring(4), 0.1, make_compressor("q4b"),
                           generator=torch.Generator().manual_seed(0), fused=True)
    with pytest.raises(ValueError, match="fused gossip needs"):
        ChocoConsensus(topology.star(4), make_compressor("kq4b"), fused=True)
    with pytest.raises(ValueError, match="fused gossip needs"):
        tsteps.make_trainer(torch_config("qwen3-1.7b").reduced(), 4, compressor="q4b",
                            fused_gossip=True, device="cpu")
    with pytest.raises(ValueError, match="fused gossip needs"):
        ChocoConsensus(topology.ring(4), make_compressor("btop10"), fused=True)


def test_packed_and_fused_rounds_agree_from_one_generator():
    """From one seed the packed and fused paths quantize the same noise, so
    theta and theta_hat are equal and s agrees to f32 reassociation."""
    m = 4
    base = {k: torch.from_numpy(v) for k, v in
            {"w": np.random.default_rng(0).standard_normal((m, 5000)).astype(np.float32)}.items()}
    outs = []
    for fused in (False, True):
        theta = {k: v.clone() for k, v in base.items()}
        state = gossip.choco_init(theta)
        state.s["w"] += 0.1
        gen = torch.Generator().manual_seed(7)
        for _ in range(2):
            gossip.choco_round(theta, state, topology.ring(m), 0.3, make_compressor("kq4b"),
                               generator=gen, fused=fused, block_scan_elems=1024)
        outs.append((theta["w"], state.theta_hat["w"], state.s["w"]))
    (tp, hp, sp), (tf, hf, sf) = outs
    assert torch.equal(hp, hf)
    torch.testing.assert_close(tf, tp, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(sf, sp, rtol=1e-6, atol=1e-7)


def _templates(arch_cfg_jax, arch_cfg_torch, m):
    jt = jax.tree.map(lambda p: jax.ShapeDtypeStruct((m,) + p.shape, p.dtype),
                      jsteps.abstract_params(arch_cfg_jax))
    tt = [torch.empty((m,) + tuple(p.shape), device="meta")
          for p in leaves(TT.abstract_train_params(arch_cfg_torch))]
    return jt, tt


@pytest.mark.parametrize("full", [False, True], ids=["reduced", "full"])
def test_chunk_plan_gamma_and_bits_match_reference(full):
    """At full width (1,720,574,976 parameters, built as shapes only): 143
    encodes per round, the largest 2**24 elements (wq / wo, 4 layers a
    chunk), so gamma = 0.5 / tau(2**24) for kq4b; bits equal the
    reference's."""
    m = 4
    jc, tc = jax_config("qwen3-1.7b"), torch_config("qwen3-1.7b")
    if not full:
        jc, tc = jc.reduced(), tc.reduced()
    jt, tt = _templates(jc, tc, m)
    jflat = jax.tree_util.tree_leaves(jt)
    assert [tuple(x.shape) for x in jflat] == [tuple(x.shape) for x in tt]
    plans = []
    for a, b in zip(jflat, tt):
        inner = int(np.prod(a.shape[1:]))
        want = jg._scan_plan(a.shape, inner, jg.BLOCK_SCAN_ELEMS)
        assert gossip._scan_plan(tuple(b.shape), inner, gossip.BLOCK_SCAN_ELEMS) == want
        plans.append((tuple(a.shape), want))
    print("\n".join(f"{shape}: {plan}" for shape, plan in plans))
    assert ChocoConsensus._encode_dim(tt) == JChoco._encode_dim(jt)
    for spec in ("kq4b", "q4b", "none"):
        jcons = JChoco(jtopo.ring(m), jax_compressor(spec))
        tcons = ChocoConsensus(topology.ring(m), make_compressor(spec))
        d = JChoco._encode_dim(jt)
        assert tcons._resolve_gamma(d) == jcons._resolve_gamma(d)
        assert tcons.bits_per_round(tt) == jcons.bits_per_round(jt)
    if full:
        assert sum(int(np.prod(x.shape[1:])) for x in tt) == 1_720_574_976
        assert ChocoConsensus._encode_dim(tt) == 2**24
        assert sum(1 if p is None else p[1] for _, p in plans) == 143


@pytest.mark.parametrize("name,m", [("ring", 4), ("ring", 10), ("torus", 16), ("torus", 10),
                                    ("mesh", 5), ("star", 6)])
def test_topologies_match_reference(name, m):
    a, b = jtopo.make_topology(name, m), topology.make_topology(name, m)
    np.testing.assert_array_equal(a.mixing, b.mixing)
    np.testing.assert_array_equal(a.adjacency, b.adjacency)
    assert a.shifts == b.shifts and a.max_degree == b.max_degree
    assert a.spectral_gap == b.spectral_gap and a.consensus_step_size(0.1) == \
        b.consensus_step_size(0.1)
    e1, e2 = jtopo.erdos_renyi(9, 0.4, seed=2), topology.erdos_renyi(9, 0.4, seed=2)
    np.testing.assert_array_equal(e1.mixing, e2.mixing)


@pytest.mark.parametrize("reg", ["chi2", "kl"])
def test_projected_ascent_pieces_match_reference(reg):
    rng = np.random.default_rng(4)
    m = 6
    v = rng.standard_normal((m, m)).astype(np.float32)
    np.testing.assert_allclose(dro.project_simplex(torch.from_numpy(v)).numpy(),
                               np.asarray(jax.vmap(jdro.project_simplex)(jnp.asarray(v))),
                               rtol=1e-6, atol=1e-7)
    lam = np.asarray(jax.vmap(jdro.project_simplex)(jnp.asarray(v)))
    lam = (0.9 * lam + 0.1 / m).astype(np.float32)
    prior = np.full(m, 1.0 / m, np.float32)
    losses = rng.random(m).astype(np.float32)
    want = jax.vmap(lambda f, i, l: jdro.dual_gradient(
        f, i, l, jnp.asarray(prior), 0.05, jdro.make_regularizer(reg)))(
        jnp.asarray(losses), jnp.arange(m), jnp.asarray(lam))
    got = dro.dual_gradient(torch.from_numpy(losses), torch.arange(m), torch.from_numpy(lam),
                            torch.from_numpy(prior), 0.05, dro.make_regularizer(reg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("kind,warmup", [("const", 0), ("exp", 0), ("cosine", 5), ("exp", 3)])
def test_schedules_match_reference(kind, warmup):
    a = jax_schedule(kind, 0.3, decay=0.97, total_steps=20, warmup=warmup)
    b = make_schedule(kind, 0.3, decay=0.97, total_steps=20, warmup=warmup)
    for t in range(25):
        assert b(t) == pytest.approx(float(a(jnp.int32(t))), rel=1e-6)


@pytest.mark.parametrize("momentum,nesterov", [(0.0, False), (0.9, False), (0.9, True)])
def test_sgd_matches_reference(momentum, nesterov):
    """Two in-place steps with per-node gradient weights against the
    reference's update tree (``_scale_grads`` + ``_apply_updates``)."""
    rng = np.random.default_rng(5)
    m = 3
    p0 = {"a": rng.standard_normal((m, 4, 5)).astype(np.float32),
          "b": rng.standard_normal((m, 7)).astype(np.float32)}
    jopt = jax_sgd(jax_schedule("exp", 0.1, decay=0.9), momentum=momentum, nesterov=nesterov)
    topt = sgd(make_schedule("exp", 0.1, decay=0.9), momentum=momentum, nesterov=nesterov)
    jp = jax.tree.map(jnp.asarray, p0)
    tp = [torch.from_numpy(p0[k].copy()) for k in ("a", "b")]
    jstate, tstate = jopt.init(jp), topt.init(tp)
    for _ in range(2):
        g = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in p0.items()}
        scale = rng.random(m).astype(np.float32)
        sg = jax.tree.map(lambda x: jnp.asarray(x) * jnp.asarray(scale).reshape(
            (m,) + (1,) * (x.ndim - 1)), g)
        upd, jstate = jopt.update(sg, jstate, jp)
        jp = jax.tree.map(lambda p, u: p + u, jp, upd)
        grads = [[torch.from_numpy(g[k][i]) for i in range(m)] for k in ("a", "b")]
        tstate = topt.apply_(tp, grads, tstate, torch.from_numpy(scale))
    assert isinstance(tstate, OptState) and tstate.step == 2
    for k, t in zip(("a", "b"), tp):
        np.testing.assert_allclose(t.numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7)


def test_synthetic_data_is_byte_identical():
    a, b = jax_tokens(4, 3, 16, 700, seed=3), node_token_stream(4, 3, 16, 700, seed=3)
    for _ in range(3):
        x, y = next(a), next(b)
        assert x.dtype == y.dtype and np.array_equal(x, y)
    da, db = jax_rotated(seed=1), rotated_minority_classification(seed=1)
    for f in dataclasses.fields(da):
        va, vb = getattr(da, f.name), getattr(db, f.name)
        if isinstance(va, list):
            assert all(np.array_equal(x, y) for x, y in zip(va, vb))
        else:
            assert np.array_equal(va, vb) and va.dtype == vb.dtype
    ga, gb = da.batches(50, seed=0), db.batches(50, seed=0)
    for _ in range(2):
        (xa, ya), (xb, yb) = next(ga), next(gb)
        assert np.array_equal(xa, xb) and np.array_equal(ya, yb)


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_sgd_blocks_equal_the_whole_leaf_update(momentum, monkeypatch):
    """SGD updates a node's leaf over flat blocks (small f32 temporaries for
    embedding-sized leaves); the update is elementwise, so the blocks change
    no bit of it."""
    import sys

    rng = np.random.default_rng(5)
    p0 = torch.from_numpy(rng.standard_normal((3, 1000, 7)).astype(np.float32)).bfloat16()
    g = [torch.from_numpy(rng.standard_normal((1000, 7)).astype(np.float32)).bfloat16()
         for _ in range(3)]
    scale = torch.tensor([1.0, 0.5, 2.0])
    mod = sys.modules[sgd.__module__]
    outs = []
    for block in (mod._SGD_BLOCK, 999):
        monkeypatch.setattr(mod, "_SGD_BLOCK", block)
        p = p0.clone()
        opt = sgd(0.1, momentum=momentum)
        st = opt.init([p])
        for _ in range(2):
            st = opt.apply_([p], [g], st, scale)
        outs.append(p)
    assert torch.equal(outs[0].view(torch.int16), outs[1].view(torch.int16))
