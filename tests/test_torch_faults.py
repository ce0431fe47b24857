"""repro_torch's wire faults against the JAX package, on the CPU.

* the fault spec's parsing; ``digest`` / ``garble`` bit for bit (f32,
  bf16, int32, a single flipped bit); ``sample_events`` on the reference's
  uniform draw; ``update_fault_state`` over a scripted run of verdicts that
  drives the backoff to its cap;
* faulted cached rounds on a small tree (m <= 8, the reference's fault
  draw injected): divergence detected the round it happens, the synced
  mirror invariant and resyncs, an all-drop wire, lane isolation, and the
  fault state and bits meter equal to the reference's as integers;
* the memoryless faulted mix (exact wire, lambda gossip);
* the trainers under faults (AD-GDA with CHOCO and with gradient tracking,
  DR-DSGD) against the reference's on the logistic task, the reference's
  fault draws injected: lambda and theta within 1e-5 relative (the
  reference's jitted step reassociates), the fault state exact,
  ``bits_realized`` equal.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from benchmarks.common import logistic_init as jinit
from benchmarks.common import make_adgda as jmake_adgda
from benchmarks.common import make_loss
from repro.core import DRDSGDConfig as JDRDSGDConfig
from repro.core import drdsgd_trainer as jdrdsgd
from repro.core import exchange as jex
from repro.core import faults as jf
from repro.core import gossip as jg
from repro.core import topology as jtopo
from repro.core import wire as jw
from repro.core.compression import Identity as JIdentity
from repro.data import rotated_minority_classification
from repro_torch.core import DRDSGDConfig, drdsgd_trainer, exchange, faults, gossip, topology
from repro_torch.core import wire
from repro_torch.core.compression import Identity, RandomQuantization
from repro_torch.launch.comparisons import logistic_init, make_adgda
from repro_torch.tree import leaves, unflatten
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

REL = 1e-5
FIELDS = ("synced", "stale", "wait", "backoff", "detected", "resyncs", "bits")


def _to_t(tree):
    return unflatten(tree, [torch.from_numpy(np.array(x)) for x in jax.tree_util.tree_leaves(tree)])


def _theta(m, d, seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((m, d)).astype(np.float32),
            "b": rng.standard_normal((m,)).astype(np.float32)}


def _unions(spec, m, dropout=0.0):
    js = jtopo.make_topology_schedule(spec, m, dropout=dropout)
    ts = topology.make_topology_schedule(spec, m, dropout=dropout)
    return (js, jw.compile_union_wire(jtopo.compile_schedule_plans(js)),
            ts, wire.compile_union_wire(topology.compile_schedule_plans(ts)))


def _u(fkey, union, m):
    return np.array(jax.random.uniform(fkey, (union.n_ops, m)))


def _assert_fault_state_equal(jfs, tfs, what=""):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(tfs, f).numpy(), np.asarray(getattr(jfs, f)),
                                      err_msg=f"{what} {f}")


def _assert_synced_mirrors_exact(state, union):
    """Every edge the state machine calls synced holds its sender's
    theta_hat bit for bit; returns how many it checked."""
    hats, synced, checked = leaves(state.theta_hat), state.fault.synced.numpy(), 0
    for k, snd in enumerate(union.senders):
        for hat, mirror in zip(hats, leaves(state.cache[k])):
            for i, j in enumerate(snd):
                if j >= 0 and synced[i, k] > 0:
                    assert torch.equal(mirror[i].view(torch.int32), hat[j].view(torch.int32)), (
                        f"op {k} node {i}: synced, but the mirror is not sender {j}'s hat")
                    checked += 1
    return checked


# ---------------------------------------------------------------- the spec
def _same_spec(j, t) -> bool:
    return all(getattr(j, k) == getattr(t, k) for k in
               ("drop", "corrupt", "dup", "delay", "stale", "backoff_base", "backoff_cap"))


def test_parse_fault_spec_roundtrip():
    for text in ("drop:0.05,corrupt:0.01,stale:2", "dup:0.2,delay:0.1,stale:0",
                 "drop:0.1,backoff:3,backoff_cap:9"):
        j, t = jf.parse_fault_spec(text), faults.parse_fault_spec(text)
        assert _same_spec(j, t) and str(t) == str(j) and faults.parse_fault_spec(t) is t
        if "backoff" not in text:  # str() names the rates and the staleness bound
            assert faults.parse_fault_spec(str(t)) == t


def test_parse_fault_spec_zero_is_none():
    for spec in (None, "", "stale:3", "drop:0,corrupt:0.0", faults.FaultSpec()):
        assert faults.parse_fault_spec(spec) is None
        assert jf.parse_fault_spec(None if isinstance(spec, faults.FaultSpec) else spec) is None


@pytest.mark.parametrize("bad", ["drop", "drop:1.5", "drop:0.6,corrupt:0.6", "stale:-1",
                                 "bogus:0.1", "drop:0.1,backoff:0"])
def test_parse_fault_spec_errors(bad):
    with pytest.raises(ValueError):
        jf.parse_fault_spec(bad)
    with pytest.raises(ValueError):
        faults.parse_fault_spec(bad)


# ------------------------------------------------------- digest and garble
def _as_torch(x: np.ndarray) -> torch.Tensor:
    if x.dtype == jnp.bfloat16:
        return torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(x.copy())


def _bits(x: torch.Tensor) -> np.ndarray:
    return x.view({2: torch.int16, 4: torch.int32}[x.element_size()]).numpy()


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16, jnp.int32])
def test_digest_and_garble_equal_reference(dtype):
    """Bit for bit on values whose int32 sums wrap; a garble and a single
    flipped bit change the digest; garble is its own inverse."""
    rng = np.random.default_rng(3)
    if dtype == jnp.int32:
        x = jnp.asarray(rng.integers(-2**31, 2**31 - 1, (5, 257), dtype=np.int64), jnp.int32)
    else:
        x = jnp.asarray(rng.standard_normal((5, 257)) * 1e30, dtype)
    xt = _as_torch(np.asarray(x))
    np.testing.assert_array_equal(faults.digest(xt).numpy(), np.asarray(jf.digest(x)))
    np.testing.assert_array_equal(faults.digest(xt, 0).numpy().reshape(-1),
                                  np.asarray(jf.digest(x, 0)).reshape(-1).astype(np.int32))
    gt, gj = faults.garble(xt), jf.garble(x)
    np.testing.assert_array_equal(_bits(gt), _bits(_as_torch(np.asarray(gj))))
    np.testing.assert_array_equal(faults.digest(gt).numpy(), np.asarray(jf.digest(gj)))
    assert (faults.digest(gt) != faults.digest(xt)).all()
    np.testing.assert_array_equal(_bits(faults.garble(gt)), _bits(xt))
    flipped = xt.clone()
    ints = flipped.view({2: torch.int16, 4: torch.int32}[flipped.element_size()])
    ints[2, 100] ^= 1 << 3
    jflip = jnp.asarray(np.asarray(x).copy())
    jints = jax.lax.bitcast_convert_type(jflip, {2: jnp.int16, 4: jnp.int32}[xt.element_size()])
    jflip = jax.lax.bitcast_convert_type(jints.at[2, 100].set(jints[2, 100] ^ (1 << 3)), dtype)
    np.testing.assert_array_equal(faults.digest(flipped).numpy(), np.asarray(jf.digest(jflip)))
    assert faults.digest(flipped)[2] != faults.digest(xt)[2]


def test_sample_events_equal_reference():
    spec = faults.FaultSpec(drop=0.2, corrupt=0.15, dup=0.1, delay=0.05)
    key = jax.random.PRNGKey(5)
    ref = jf.sample_events(jf.FaultSpec(drop=0.2, corrupt=0.15, dup=0.1, delay=0.05), key, 3,
                           11)
    got = faults.sample_events(spec, torch.from_numpy(np.array(
        jax.random.uniform(key, (3, 11)))))
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert got.drop.shape == (3, 11) and got.drop.dtype == torch.bool


@pytest.mark.parametrize("base,cap", [(2, 32), (3, 100), (2, 1 << 20)])
def test_update_fault_state_matches_reference_to_the_backoff_cap(base, cap):
    """A scripted run: one edge's resync fails 19 rounds running (the
    backoff power passes the exponent cap of 16), another edge flaps, then
    everything verifies; every field equals the reference's each round."""
    m, n_ops = 3, 2
    jspec = jf.FaultSpec(drop=0.1, stale=0, backoff_base=base, backoff_cap=cap)
    tspec = faults.FaultSpec(drop=0.1, stale=0, backoff_base=base, backoff_cap=cap)
    jfs, tfs = jf.init_fault_state(m, n_ops), faults.init_fault_state(m, n_ops)
    rng = np.random.default_rng(0)
    top = 0
    for r in range(24):
        d_ok = rng.random((n_ops, m)) < 0.5
        r_ok = rng.random((n_ops, m)) < 0.3
        want = rng.random((n_ops, m)) < 0.6
        d_ok[0, 1], r_ok[0, 1], want[0, 1] = r >= 20, r >= 20, True
        bits = rng.random(m).astype(np.float32) * 1e3
        jfs = jf.update_fault_state(jfs, jnp.asarray(d_ok), jnp.asarray(r_ok),
                                    jnp.asarray(want), jspec, jnp.asarray(bits))
        tfs = faults.update_fault_state(tfs, torch.from_numpy(d_ok), torch.from_numpy(r_ok),
                                        torch.from_numpy(want), tspec, torch.from_numpy(bits))
        _assert_fault_state_equal(jfs, tfs, f"round {r}")
        top = max(top, int(tfs.backoff.max()))
    assert top >= 17 and int(tfs.wait[1, 0]) == 0  # past the exponent cap, then verified
    assert tfs.wait.dtype == torch.int32 and tfs.synced.dtype == torch.float32


def test_receiver_maps_invert_the_senders():
    _, ju, _, tu = _unions("matching:8", 7)
    for snd, rcv in zip(tu.senders, faults.receiver_maps(tu)):
        for j, i in enumerate(rcv):
            assert (i < 0 and j not in snd) or snd[i] == j


# ------------------------------------------------------- faulted rounds
def _run_both(theta, rounds, spec_text, sched="ring", dropout=0.0, comp="none", m=None,
              seed_key=7, check=None):
    """``rounds`` faulted cached rounds of the reference (eagerly) and of the
    port on the same inputs, the reference's noise and fault draws
    injected; returns the final (reference, port) states and thetas."""
    m = jax.tree_util.tree_leaves(theta)[0].shape[0]
    js, ju, ts, tu = _unions(sched, m, dropout)
    jspec, tspec = jf.parse_fault_spec(spec_text), faults.parse_fault_spec(spec_text)
    jcomp = JIdentity() if comp == "none" else jg_quant()
    tcomp = Identity() if comp == "none" else RandomQuantization(4)
    jt, tt = jax.tree.map(jnp.asarray, theta), _to_t(theta)
    jst = jg.choco_init(jt, cache_ops=ju.n_ops, fault_ops=ju.n_ops)
    tst = gossip.choco_init(tt, cache_ops=tu.n_ops, fault_ops=tu.n_ops)
    for r in range(rounds):
        key, fkey = jax.random.PRNGKey(100 + r), jax.random.fold_in(jax.random.PRNGKey(seed_key), r)
        mask = None
        if dropout:
            mask = np.asarray(js.mask_at(jax.random.PRNGKey(500 + r), r), np.float32)
        xi = _noise(key, jt, tcomp, m)
        jt, jst = jex.choco_round_cached_local(
            jt, jst, 0.3, jcomp, key, union=ju, step=jnp.int32(r),
            mask=None if mask is None else jnp.asarray(mask), faults=jspec, fault_key=fkey)
        tt, tst = exchange.choco_round_cached_local(
            tt, tst, 0.3, tcomp, noise=lambda li, ci, shape: torch.from_numpy(xi[(li, ci)]),
            union=tu, step=r, mask=None if mask is None else torch.from_numpy(mask),
            faults=tspec, events=_u(fkey, ju, m))
        _assert_fault_state_equal(jst.fault, tst.fault, f"round {r}")
        if check is not None:
            check(r, tst, tu)
    return (jt, jst), (tt, tst), tu


def jg_quant():
    from repro.core.compression import RandomQuantization as JRQ

    return JRQ(4)


def _noise(key, tree, compressor, m):
    """The reference's per-encode noise of an unchunked tree: {(leaf,
    None): xi [m, ...]}."""
    out = {}
    flat = jax.tree_util.tree_leaves(tree)
    for li, (leaf, k) in enumerate(zip(flat, jax.random.split(key, len(flat)))):
        shape = compressor.noise_shape(m, leaf.shape[1:])
        if shape is not None:
            out[(li, None)] = np.stack([np.asarray(jax.random.uniform(nk, shape[1:]))
                                        for nk in jax.random.split(k, m)])
    return out


def test_divergence_detected_the_round_it_happens():
    """From an all-synced state, one faulted round's verdicts equal a
    reconstruction from its events: every live edge that drew drop /
    corrupt / delay diverges, dup and clean edges stay synced; the meter
    bills drops 0, dups 2x, the rest 1x (payload + digest lane)."""
    m, d = 8, 40
    spec = faults.FaultSpec(drop=0.25, corrupt=0.2, dup=0.1, delay=0.1, stale=2)
    _, ju, _, tu = _unions("ring", m)
    theta = _to_t(_theta(m, d))
    u = _u(jax.random.PRNGKey(42), ju, m)
    st = gossip.choco_init(theta, cache_ops=tu.n_ops, fault_ops=tu.n_ops)
    _, st = exchange.choco_round_cached_local(theta, st, 0.3, RandomQuantization(4),
                                              generator=torch.Generator().manual_seed(0),
                                              union=tu, faults=spec, events=u)
    ev = faults.sample_events(spec, torch.from_numpy(u))
    exist = np.stack([np.asarray(s) >= 0 for s in tu.senders])
    diverged = exist & (ev.drop | ev.corrupt | ev.delay).numpy()
    assert diverged.any()
    np.testing.assert_array_equal(st.fault.synced.numpy().T.astype(bool),
                                  exist & ~diverged | ~exist)
    np.testing.assert_array_equal(st.fault.detected.numpy(), diverged.sum(0).astype(np.int32))
    assert int(st.fault.resyncs.sum()) == 0
    payload, dig, _ = exchange.wire_msg_bits(RandomQuantization(4), theta)
    mult = np.where(ev.drop.numpy(), 0.0, np.where(ev.dup.numpy(), 2.0, 1.0))
    want = np.zeros(m)
    for k, snd in enumerate(tu.senders):
        for i, j in enumerate(snd):
            if j >= 0:
                want[j] += mult[k, i] * (payload + dig)
    np.testing.assert_allclose(st.fault.bits.numpy(), want, rtol=1e-6)


@pytest.mark.parametrize("sched,dropout,comp", [("ring", 0.0, "none"), ("ring", 0.0, "q4b"),
                                                ("matching:3", 0.25, "none")],
                         ids=["static-ring", "static-ring-q4b", "matching-drop"])
def test_synced_mirror_invariant_and_resync(sched, dropout, comp):
    """Across a faulted run the mirror of every synced edge is its sender's
    theta_hat bit for bit each round, divergences accumulate, resyncs heal
    edges, and the fault state equals the reference's every round; with
    Identity and no chunking the reference's arithmetic is the port's, so
    theta, theta_hat, s and every mirror equal it bit for bit."""
    checked = []
    (jt, jst), (tt, tst), tu = _run_both(
        _theta(8, 40), 8, "drop:0.3,corrupt:0.1,stale:1", sched, dropout, comp,
        check=lambda r, st, u: checked.append(_assert_synced_mirrors_exact(st, u)))
    assert sum(checked) > 0
    assert int(tst.fault.detected.sum()) > 0 and int(tst.fault.resyncs.sum()) > 0
    pairs = [(jt, tt), (jst.theta_hat, tst.theta_hat), (jst.s, tst.s), (jst.cache, tst.cache)]
    for a, b in pairs:
        for x, y in zip(jax.tree_util.tree_leaves(a), leaves(b), strict=True):
            x = np.asarray(x)
            if comp == "none":
                np.testing.assert_array_equal(y.numpy().view(np.int32), x.view(np.int32))
            else:
                assert np.abs(y.numpy() - x).max() <= REL * np.abs(x).max()


def test_all_drop_wire_bills_zero_and_never_heals():
    m = 6
    (_, jst), (_, tst), _ = _run_both(_theta(m, 24), 4, "drop:1.0,stale:1")
    assert float(tst.fault.bits.sum()) == 0.0 and int(tst.fault.resyncs.sum()) == 0
    assert not tst.fault.synced.bool().any()


def test_multilane_faulted_lane_isolation():
    """Each lane of a two-lane faulted round has its own events, mirrors and
    fault state: lane k equals a one-lane run on lane k's events, bit for
    bit, and the lanes' fault states part ways."""
    m, rounds = 8, 6
    spec = faults.FaultSpec(drop=0.25, corrupt=0.15, stale=1)
    _, ju, _, tu = _unions("ring", m)
    thetas0 = [_theta(m, 40, seed=s) for s in (0, 1)]
    draws = [[_u(jax.random.PRNGKey(1000 * k + r), ju, m) for r in range(rounds)]
             for k in range(2)]
    comp = RandomQuantization(4)
    ts = [_to_t(t) for t in thetas0]
    sts = [gossip.choco_init(t, cache_ops=tu.n_ops, fault_ops=tu.n_ops) for t in ts]
    gen = torch.Generator().manual_seed(0)
    for r in range(rounds):
        lanes = [gossip.LaneRound(t, st, 0.3, comp) for t, st in zip(ts, sts)]
        ts, sts = exchange.choco_round_cached_local_lanes(
            lanes, generator=gen, union=tu, step=r, faults=spec,
            events=(draws[0][r], draws[1][r]))
        for st in sts:
            _assert_synced_mirrors_exact(st, tu)
    gen = torch.Generator().manual_seed(0)
    solo = [_to_t(t) for t in thetas0]
    solo_st = [gossip.choco_init(t, cache_ops=tu.n_ops, fault_ops=tu.n_ops) for t in solo]
    for r in range(rounds):
        for k in range(2):  # the lanes draw their noise in lane order
            solo[k], solo_st[k] = exchange.choco_round_cached_local(
                solo[k], solo_st[k], 0.3, comp, generator=gen, union=tu, step=r,
                faults=spec, events=draws[k][r])
    for k in range(2):
        for a, b in zip(leaves((ts[k], sts[k].theta_hat, sts[k].s, sts[k].cache)),
                        leaves((solo[k], solo_st[k].theta_hat, solo_st[k].s,
                                solo_st[k].cache))):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        for f in FIELDS:
            assert torch.equal(getattr(sts[k].fault, f), getattr(solo_st[k].fault, f))
    assert not torch.equal(sts[0].fault.synced, sts[1].fault.synced) or \
        not torch.equal(sts[0].fault.detected, sts[1].fault.detected)
    for st in sts:
        assert int(st.fault.detected.sum()) > 0 and int(st.fault.resyncs.sum()) > 0


# ------------------------------------------------------ the memoryless mix
def test_memoryless_all_drop_is_identity():
    m = 6
    tree = {"lam": torch.randn(m, m, generator=torch.Generator().manual_seed(0))}
    mixed, bits = exchange.mix_stacked_faulted_local(
        tree, topology=topology.make_topology("ring", m), faults=faults.FaultSpec(drop=1.0),
        events=np.random.default_rng(0).random((2, m)).astype(np.float32))
    assert torch.equal(mixed["lam"], tree["lam"]) and float(bits.sum()) == 0.0


def test_memoryless_faulted_mix_row_stochastic():
    m = 8
    const = {"v": torch.full((m, 3), 2.5)}
    mixed, bits = exchange.mix_stacked_faulted_local(
        const, topology=topology.make_topology("ring", m),
        faults=faults.FaultSpec(drop=0.3, corrupt=0.2),
        events=np.random.default_rng(11).random((2, m)).astype(np.float32))
    np.testing.assert_allclose(mixed["v"].numpy(), 2.5, rtol=1e-6)
    assert float(bits.max()) > 0.0


@pytest.mark.parametrize("sched,masked", [("ring", False), ("matching:8", True),
                                          ("roundrobin:ring,torus", True)])
def test_memoryless_mix_equals_reference(sched, masked):
    m = 8
    js, ju, ts, tu = _unions(sched, m, 0.3 if masked else 0.0)
    spec = "drop:0.2,corrupt:0.1,dup:0.1,delay:0.1"
    lam = np.random.default_rng(1).random((m, m)).astype(np.float32)
    for step in range(3):
        fkey = jax.random.PRNGKey(30 + step)
        mask = (np.asarray(js.mask_at(jax.random.PRNGKey(step), step), np.float32)
                if masked else None)
        jm, jb = jex.mix_stacked_faulted_local(
            {"lam": jnp.asarray(lam)}, union=ju, step=jnp.int32(step),
            mask=None if mask is None else jnp.asarray(mask), faults=jf.parse_fault_spec(spec),
            fault_key=fkey)
        tm, tb = exchange.mix_stacked_faulted_local(
            {"lam": torch.from_numpy(lam)}, union=tu, step=step,
            mask=None if mask is None else torch.from_numpy(mask),
            faults=faults.parse_fault_spec(spec), events=_u(fkey, ju, m))
        np.testing.assert_array_equal(tm["lam"].numpy(), np.asarray(jm["lam"]))
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))


# ---------------------------------------------------------------- trainers
def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _fault_states(cons):
    if hasattr(cons, "tracker"):
        return [cons.model.fault, cons.tracker.fault]
    return [cons.fault]


@pytest.mark.parametrize("kw", [
    dict(topology="ring"),
    dict(topology_schedule="roundrobin:ring,torus", dropout=0.2),
    dict(topology="ring", consensus="gt"),
], ids=["choco-ring", "choco-rr-dropout", "gt-ring"])
def test_adgda_faulted_trainer_matches_reference(kw):
    """AD-GDA (``none`` compression) with ``drop:0.3,corrupt:0.1,stale:1``
    on the logistic task, 4 rounds: the reference's fault draws (its key
    layout: next rng, gossip key, [mask key,] fault key, node keys; lane 1
    folds the fault key) and masks injected.  The fault state of every lane
    equals the reference's exactly, lambda and theta within 1e-5 relative,
    ``bits_realized`` equal; the lambda gossip ran faulted."""
    m, spec = 6, "drop:0.3,corrupt:0.1,stale:1"
    data = rotated_minority_classification(num_nodes=m, seed=0)
    jtr, _, _ = jmake_adgda("logistic", m, compressor="none", fault_spec=spec, **kw)
    ttr = make_adgda(m, compressor="none", fault_spec=spec, device="cpu", **kw)
    assert ttr.dual.mix_fn is not None and ttr.consensus.union.n_ops == jtr.consensus.union.n_ops
    js = jtr.init(jinit(data.dim, data.num_classes), jax.random.PRNGKey(0))
    js = js._replace(lam=jnp.asarray(js.lam, jnp.float32))
    ts = ttr.init(logistic_init(data.dim, data.num_classes, "cpu"), seed=0)
    gen = data.batches(20, seed=0)
    n_ops, masked = jtr.consensus.union.n_ops, "dropout" in kw
    for _ in range(4):
        xb, yb = next(gen)
        keys = jax.random.split(js.rng, m + 3 + int(masked))
        fkey = keys[3 if masked else 2]
        mask = np.asarray(jtr.schedule.mask_at(keys[2], js.step)) if masked else None
        u = [np.asarray(jax.random.uniform(jg.lane_key(fkey, k), (n_ops, m)))
             for k in range(ttr.consensus.fault_lanes)]
        js, ja = jtr.step(js, (jnp.asarray(xb), jnp.asarray(yb)))
        ts, ta = ttr.step(ts, (torch.from_numpy(xb), torch.from_numpy(yb)), mask=mask,
                          fault_u=u[0] if len(u) == 1 else u)
        for jfs, tfs in zip(_fault_states(js.consensus), _fault_states(ts.consensus),
                            strict=True):
            _assert_fault_state_equal(jfs, tfs)
        assert ta["bits_realized"] == float(ja["bits_realized"])
        assert _rel(ta["lambda_mean"].numpy(), ja["lambda_mean"]) <= REL
        assert _rel(ts.lam.numpy(), js.lam) <= REL
        for k in ("w", "b"):
            assert _rel(ts.theta[k].numpy(), js.theta[k]) <= REL
    assert sum(int(f.detected.sum()) for f in _fault_states(ts.consensus)) > 0
    assert ttr.bits_per_round(ts, mode="realized") == pytest.approx(
        jtr.bits_per_round(js, mode="realized"), rel=1e-7)
    for mode in ("max", "expected"):
        assert ttr.bits_per_round(ts, mode=mode) == jtr.bits_per_round(js, mode=mode)


def test_gt_trainer_faulted_bits_meter():
    """Gradient tracking under faults (q4b, its own draws): the realized
    bits are the sum of both lanes' meters and equal
    ``bits_per_round(mode='realized')``; both lanes detect independently."""
    m = 6
    data = rotated_minority_classification(num_nodes=m, seed=0)
    tr = make_adgda(m, compressor="q4b", consensus="gt", device="cpu",
                    fault_spec="drop:0.3,corrupt:0.1,stale:1")
    st = tr.init(logistic_init(data.dim, data.num_classes, "cpu"), seed=0)
    xb, yb = next(data.batches(20, seed=0))
    for _ in range(5):
        st, aux = tr.step(st, (torch.from_numpy(xb), torch.from_numpy(yb)))
        assert aux["bits_realized"] == pytest.approx(tr.bits_per_round(st, mode="realized"))
    cons = st.consensus
    assert int(cons.model.fault.detected.sum()) > 0 and int(cons.tracker.fault.detected.sum()) > 0
    bm, bt = cons.model.fault.bits, cons.tracker.fault.bits
    assert float(bm.sum()) > 0 and float(bt.sum()) > 0 and not torch.equal(bm, bt)


def test_trainer_bits_realized_under_heavy_drop():
    """Dropped deliveries are not billed: under 50% drop (no resyncs) the
    aux meter equals ``bits_per_round(mode='realized')`` and the total is
    below billing every edge every round."""
    m = 6
    data = rotated_minority_classification(num_nodes=m, seed=0)
    tr = make_adgda(m, compressor="q4b", device="cpu", fault_spec="drop:0.5,stale:9999")
    st = tr.init(logistic_init(data.dim, data.num_classes, "cpu"), seed=0)
    xb, yb = next(data.batches(20, seed=0))
    payload, dig, _ = exchange.wire_msg_bits(tr.compressor, st.theta)
    full = float(tr.consensus.union.out_degree.sum()) * (payload + dig)
    total = 0.0
    for _ in range(6):
        st, aux = tr.step(st, (torch.from_numpy(xb), torch.from_numpy(yb)))
        assert aux["bits_realized"] == pytest.approx(tr.bits_per_round(st, mode="realized"))
        total += float(st.consensus.fault.bits.sum())
    assert 0.0 < total < 6 * full


def test_drdsgd_faulted_matches_reference():
    """DR-DSGD with ``fault_spec``: the memoryless exact wire, the
    reference's fault draws injected; lambda and theta within 1e-5, the
    delivered-bits meter and ``bits_realized`` equal."""
    m, spec = 10, "drop:0.2,corrupt:0.1,dup:0.1"
    data = rotated_minority_classification(num_nodes=m, seed=0)
    kw = dict(num_nodes=m, topology="torus", alpha=6.0, eta_theta=0.3, lr_decay=0.99,
              fault_spec=spec)
    jt = jdrdsgd(JDRDSGDConfig(**kw), make_loss(lambda p, x: x @ p["w"] + p["b"]))
    tt = drdsgd_trainer(DRDSGDConfig(**kw), _loss(), device="cpu")
    js = jt.init(jinit(data.dim, data.num_classes), jax.random.PRNGKey(0))
    ts = tt.init(logistic_init(data.dim, data.num_classes, "cpu"), seed=0)
    gen = data.batches(50, seed=0)
    n_ops = jt.consensus.union.n_ops
    for _ in range(3):
        xb, yb = next(gen)
        fkey = jax.random.split(js.rng, m + 2)[1]
        u = np.asarray(jax.random.uniform(fkey, (n_ops, m)))
        js, ja = jt.step(js, (jnp.asarray(xb), jnp.asarray(yb)))
        ts, ta = tt.step(ts, (torch.from_numpy(xb), torch.from_numpy(yb)), fault_u=u)
        np.testing.assert_array_equal(ts.consensus.bits.numpy(), np.asarray(js.consensus.bits))
        assert ta["bits_realized"] == float(ja["bits_realized"])
        assert _rel(ts.lam.numpy(), js.lam) <= REL
        for k in ("w", "b"):
            assert _rel(ts.theta[k].numpy(), js.theta[k]) <= REL
    assert tt.bits_per_round(ts) == jt.bits_per_round(js)


def _loss():
    from repro_torch.launch.comparisons import loss_fn

    return loss_fn


@pytest.mark.parametrize("sched", ["static-ring", "rr-ring-torus", "matching"])
def test_ft_faulted_bits_table(sched):
    """BENCH_FT.json's faulted rows bill the union wire's degree: bits per
    round 1448 / 2896 / 3552, max and expected, from the port's trainer as
    from the reference's."""
    import json
    from pathlib import Path

    from repro_torch.launch import comparisons

    rows = {(r["schedule"], r["fault_spec"]): r for r in json.loads(
        (Path(__file__).resolve().parents[1] / "BENCH_FT.json").read_text())["rows"]}
    for spec in comparisons.FT_FAULTS:
        kw = comparisons.FT_SCHEDULES[sched]
        tr = comparisons.make_adgda(10, fault_spec=spec, device="cpu", **kw)
        st = tr.init(comparisons.logistic_init(16, 4, "cpu"))
        jtr, init_fn, _ = jmake_adgda("logistic", 10, compressor="q4b", fault_spec=spec, **kw)
        jst = jtr.init(init_fn(16, 4), jnp.zeros(2, jnp.uint32))
        for mode, key in (("max", "bits_per_round"), ("expected", "bits_per_round_expected")):
            got = tr.bits_per_round(st, mode=mode)
            assert got == float(jtr.bits_per_round(jst, mode=mode)) == rows[(sched, spec)][key]


def test_ft_faulted_run_detects_and_resyncs():
    """One faulted FT task runs (40 rounds here) and reports its detections,
    resyncs and consensus error."""
    from repro_torch.launch import comparisons

    task = ("ft", "static-ring|0|drop:0.1,stale:2", 0)
    assert task in comparisons.tasks(("ft",), (0,))
    data = rotated_minority_classification(num_nodes=10, seed=0)
    tr = comparisons.make_adgda(10, fault_spec="drop:0.1,stale:2", device="cpu")
    worst, info = comparisons._train(tr, data, 40, 50, 0, torch.device("cpu"))
    assert info["faults_detected"] > 0 and info["resyncs"] > 0
    assert np.isfinite(info["consensus_err"]) and 0.0 <= worst <= 1.0
    assert info["bits_per_round_realized"] > info["bits_per_round"]  # resyncs bill dense
