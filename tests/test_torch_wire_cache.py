"""repro_torch's cached union-wire round against the JAX package, on the
CPU: one round and a few rounds of ``choco_round_cached_local`` on ``{w:
[m, d], b: [m]}`` (m = 4, d = 4096 chunked, d = 4096 + 37 whole) with
``none``, ``q4b``, ``kq4b`` (plain versions) and ``btop25``, fault-free and
under drop / corrupt / dup / delay at staleness 0 and 2, with and without
dropout, the reference's noise and fault draws injected.

Tolerances: the fault state, the verdicts it records and the bits meter
equal the reference's exactly; every synced mirror is its sender's
``theta_hat`` bit for bit; theta, theta_hat, s and the mirrors are within
1e-5 of each leaf's largest magnitude (the reference's chunked leaves run
under ``lax.scan`` and its quantizer norms reduce in another order), with
up to NORM_FLIPS of the quantized elements a level apart; with ``none`` on
unchunked leaves every tensor equals the reference's bit for bit.

Also: the fault-free cached round equals the port's own masked memory-full
round within the same bound; the fused faulted round (the digest variant's
plain version) equals the packed one bit for bit; a fused faulted round
with a mask refuses.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.core import exchange as jex
from repro.core import faults as jf
from repro.core import gossip as jg
from repro.core import topology as jtopo
from repro.core import wire as jw
from repro.core.compression import make_compressor as jax_compressor
from repro_torch.core import exchange, faults, gossip, topology, wire
from repro_torch.core.compression import make_compressor
from repro_torch.core.trainer import ChocoConsensus
from repro_torch.tree import leaves, unflatten
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

M, BLOCK, REL, NORM_FLIPS = 4, 1024, 1e-5, 1e-3
FIELDS = ("synced", "stale", "wait", "backoff", "detected", "resyncs", "bits")


def _tree(m, d, seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((m, d)).astype(np.float32),
            "b": rng.standard_normal((m,)).astype(np.float32)}


def _to_t(tree):
    return unflatten(tree, [torch.from_numpy(np.array(x)) for x in jax.tree_util.tree_leaves(tree)])


def _chunk_inner(shape, plan):
    axis, chunks, rows = plan
    return (rows,) + tuple(shape[2:]) if axis == 1 else tuple(shape[1:-1]) + (rows,)


def _noise(key, tree, compressor, m):
    """The reference's per-encode noise: {(leaf, chunk): xi [m, ...]}."""
    out = {}
    flat = jax.tree_util.tree_leaves(tree)
    for li, (leaf, k) in enumerate(zip(flat, jax.random.split(key, len(flat)))):
        plan = jg._scan_plan(leaf.shape, int(np.prod(leaf.shape[1:])), BLOCK)
        parts = [(None, k, leaf.shape[1:])] if plan is None else [
            (c, kb, _chunk_inner(leaf.shape, plan))
            for c, kb in enumerate(jax.random.split(k, plan[1]))]
        for ci, kc, inner in parts:
            shape = compressor.noise_shape(m, inner)
            if shape is not None:
                out[(li, ci)] = np.stack([np.asarray(jax.random.uniform(nk, shape[1:]))
                                          for nk in jax.random.split(kc, m)])
    return out


def _close(ref, got, what, exact):
    ref, got = np.asarray(ref), got.numpy()
    if exact:
        np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32), err_msg=what)
        return
    bad = np.abs(got - ref) > REL * max(np.abs(ref).max(), 1e-30)
    assert bad.mean() <= NORM_FLIPS, f"{what}: {bad.sum()} of {bad.size} elements off"


def _mirrors_exact(state, union):
    hats = leaves(state.theta_hat)
    synced = (state.fault.synced.numpy() if isinstance(state.fault, faults.FaultState)
              else np.ones((M, union.n_ops)))
    for k, snd in enumerate(union.senders):
        for hat, mirror in zip(hats, leaves(state.cache[k])):
            for i, j in enumerate(snd):
                if j >= 0 and synced[i, k] > 0:
                    assert torch.equal(mirror[i].view(torch.int32), hat[j].view(torch.int32))


CASES = [  # compressor, d, fault spec, schedule, dropout
    ("none", 4096 + 37, None, "ring", 0.0),
    ("none", 4096, "drop:0.3,stale:0", "ring", 0.0),
    ("none", 4096 + 37, "corrupt:0.3,stale:2", "roundrobin:ring,torus", 0.0),
    ("none", 4096 + 37, "dup:0.3,delay:0.2,stale:0", "matching:4", 0.25),
    ("q4b", 4096, None, "roundrobin:ring,torus", 0.25),
    ("q4b", 4096 + 37, "drop:0.2,corrupt:0.2,stale:0", "ring", 0.0),
    ("q4b", 4096, "delay:0.3,dup:0.2,stale:2", "ring", 0.25),
    ("kq4b", 4096, None, "ring", 0.0),
    ("kq4b", 4096 + 37, "drop:0.3,corrupt:0.1,stale:0", "ring", 0.0),
    ("kq4b", 4096, "corrupt:0.3,drop:0.1,stale:2", "matching:4", 0.25),
    ("btop25", 4096 + 37, None, "ring", 0.0),
    ("btop25", 4096, "drop:0.2,corrupt:0.2,stale:0", "roundrobin:ring,torus", 0.25),
]


@pytest.mark.parametrize("spec,d,fault,sched,dropout", CASES,
                         ids=[f"{c[0]}-{c[1]}-{c[2] or 'clean'}-{c[3]}-{c[4]}" for c in CASES])
def test_cached_rounds_match_reference(spec, d, fault, sched, dropout):
    """Three cached rounds from a non-zero hat (the mirrors synced to it),
    the reference's noise, masks and fault draws injected."""
    rounds = 3
    js = jtopo.make_topology_schedule(sched, M, dropout=dropout)
    ts = topology.make_topology_schedule(sched, M, dropout=dropout)
    ju = jw.compile_union_wire(jtopo.compile_schedule_plans(js))
    tu = wire.compile_union_wire(topology.compile_schedule_plans(ts))
    jspec, tspec = jf.parse_fault_spec(fault), faults.parse_fault_spec(fault)
    theta = _tree(M, d, 0)
    hat = jax.tree.map(lambda x: 0.5 * x[::-1].copy(), _tree(M, d, 1))
    # every mirror starts as its sender's hat (the round's invariant)
    cache = tuple(jax.tree.map(lambda x: x[np.maximum(snd, 0)] * (snd >= 0).astype(np.float32)
                               .reshape((-1,) + (1,) * (x.ndim - 1)), hat) for snd in ju.senders)
    jst = jg.choco_init(jax.tree.map(jnp.asarray, theta), cache_ops=ju.n_ops,
                        fault_ops=ju.n_ops if jspec else None)
    jst = jst._replace(theta_hat=jax.tree.map(jnp.asarray, hat), s=jax.tree.map(jnp.asarray, hat),
                       cache=tuple(jax.tree.map(jnp.asarray, c) for c in cache))
    tst = gossip.choco_init(_to_t(theta), cache_ops=tu.n_ops,
                            fault_ops=tu.n_ops if tspec else None)
    tst.theta_hat, tst.s, tst.cache = _to_t(hat), _to_t(hat), tuple(_to_t(c) for c in cache)
    jt, tt = jax.tree.map(jnp.asarray, theta), _to_t(theta)
    comp = make_compressor(spec)
    exact = spec == "none" and d % BLOCK != 0
    for r in range(rounds):
        key, fkey = jax.random.PRNGKey(100 + r), jax.random.PRNGKey(200 + r)
        mask = (np.array(js.mask_at(jax.random.PRNGKey(300 + r), r), np.float32)
                if dropout else None)
        xi = _noise(key, jt, comp, M)
        jt, jst = jex.choco_round_cached_local(
            jt, jst, 0.3, jax_compressor(spec), key, union=ju, step=jnp.int32(r),
            mask=None if mask is None else jnp.asarray(mask), faults=jspec, fault_key=fkey,
            block_scan_elems=BLOCK)
        tt, tst = exchange.choco_round_cached_local(
            tt, tst, 0.3, comp, noise=lambda li, ci, shape: torch.from_numpy(xi[(li, ci)]),
            union=tu, step=r, mask=None if mask is None else torch.from_numpy(mask),
            faults=tspec, block_scan_elems=BLOCK,
            events=np.array(jax.random.uniform(fkey, (ju.n_ops, M))) if tspec else None)
        if tspec:
            for f in FIELDS:
                np.testing.assert_array_equal(getattr(tst.fault, f).numpy(),
                                              np.asarray(getattr(jst.fault, f)),
                                              err_msg=f"round {r} {f}")
        _mirrors_exact(tst, tu)
        pairs = (("theta", jt, tt), ("theta_hat", jst.theta_hat, tst.theta_hat),
                 ("s", jst.s, tst.s), ("cache", jst.cache, tst.cache))
        for name, a, b in pairs:
            for i, (x, y) in enumerate(zip(jax.tree_util.tree_leaves(a), leaves(b),
                                           strict=True)):
                _close(x, y, f"round {r} {name} leaf {i}", exact)
        if mask is not None:
            assert tst.fault == () or tst.fault.bits.numpy()[mask == 0].sum() == 0


def test_fault_free_cached_round_is_the_masked_round():
    """Without faults the cached round is the memory-full masked round read
    from mirrors: the port's two forms agree within the f32 bound."""
    sched = topology.make_topology_schedule("roundrobin:ring,torus", M, dropout=0.25)
    tu = wire.compile_union_wire(topology.compile_schedule_plans(sched))
    comp = make_compressor("kq4b")
    base = _to_t(_tree(M, 4096, 0))
    a_t = unflatten(base, [x.clone() for x in leaves(base)])
    b_t = unflatten(base, [x.clone() for x in leaves(base)])
    a_st = gossip.choco_init(a_t, cache_ops=tu.n_ops)
    b_st = gossip.choco_init(b_t)
    for r in range(3):
        mask = sched.mask_at(torch.Generator().manual_seed(r), r)
        ga, gb = (torch.Generator().manual_seed(50 + r) for _ in range(2))
        a_t, a_st = exchange.choco_round_cached_local(a_t, a_st, 0.3, comp, generator=ga,
                                                      union=tu, step=r, mask=mask)
        b_t, b_st = gossip.choco_round(b_t, b_st, sched.topology_at(r), 0.3, comp,
                                       generator=gb, mixing=sched.mixing_at(r, mask), mask=mask)
        _mirrors_exact(a_st, tu)
    for a, b in zip(leaves((a_t, a_st.theta_hat, a_st.s)), leaves((b_t, b_st.theta_hat, b_st.s))):
        _close(b.numpy(), a, "cached vs masked", False)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_faulted_round_equals_packed(dtype):
    """The fused encode's digest variant (plain version on the CPU) in the
    faulted round: theta, theta_hat, s, every mirror, the fault state and
    the bits meter equal the packed round's bit for bit, round by round."""
    comp = make_compressor("kq4b")
    topo = topology.make_topology("ring", 3)
    tu = wire.compile_union_wire((topology.compile_permute_plan(topo),))
    spec = faults.FaultSpec(drop=0.25, corrupt=0.2, dup=0.1, stale=0)
    base = {"w": torch.randn(3, 8, 700, generator=torch.Generator().manual_seed(0)).to(dtype),
            "b": torch.randn(3, 5000, generator=torch.Generator().manual_seed(1)).to(dtype)}
    runs = []
    for fused in (False, True):
        theta = unflatten(base, [x.clone() for x in leaves(base)])
        st = gossip.choco_init(theta, cache_ops=tu.n_ops, fault_ops=tu.n_ops)
        gen = torch.Generator().manual_seed(9)
        seen = []
        for r in range(5):
            u = np.random.default_rng(r).random((tu.n_ops, 3)).astype(np.float32)
            theta, st = gossip.choco_round(theta, st, topo, 0.4, comp, generator=gen,
                                           fused=fused, union=tu, step=r, faults=spec,
                                           events=u, block_scan_elems=1024)
            _mirrors_exact(st, tu)
            seen.append([x.clone() for x in leaves((theta, st.theta_hat, st.s, st.cache))]
                        + [x.clone() for x in st.fault])
        runs.append(seen)
    for r, (a, b) in enumerate(zip(*runs)):
        for x, y in zip(a, b, strict=True):
            ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32}[x.element_size()]
            assert torch.equal(x.view(ints), y.view(ints)), f"round {r}"
    assert int(runs[1][-1][-2].sum()) > 0  # resyncs happened


def test_fused_faulted_round_refuses_a_mask():
    comp = make_compressor("kq4b")
    theta = {"w": torch.randn(4, 4096)}
    tu = wire.compile_union_wire((topology.compile_permute_plan(topology.make_topology("ring",
                                                                                        4)),))
    st = gossip.choco_init(theta, cache_ops=tu.n_ops, fault_ops=tu.n_ops)
    with pytest.raises(ValueError, match="mask"):
        exchange.choco_round_cached_local(
            theta, st, 0.3, comp, generator=torch.Generator(), union=tu, fused=True,
            mask=torch.tensor([1.0, 0.0, 1.0, 1.0]), faults=faults.FaultSpec(drop=0.1),
            events=np.zeros((tu.n_ops, 4), np.float32))
    sched = topology.make_topology_schedule("ring", 4, dropout=0.1)
    with pytest.raises(ValueError, match="fused"):
        ChocoConsensus(sched, comp, fused=True, faults="drop:0.1")


def test_faulted_round_needs_its_state_and_events():
    comp = make_compressor("none")
    topo = topology.make_topology("ring", 4)
    theta = {"w": torch.randn(4, 16)}
    with pytest.raises(ValueError, match="NeighborCache"):
        gossip.choco_round(theta, gossip.choco_init(theta), topo, 0.3, comp,
                           faults=faults.FaultSpec(drop=0.1), events=np.zeros((2, 4)))
    st = gossip.choco_init(theta, cache_ops=2, fault_ops=2)
    with pytest.raises(ValueError, match="events"):
        gossip.choco_round(theta, st, topo, 0.3, comp, faults=faults.FaultSpec(drop=0.1))
