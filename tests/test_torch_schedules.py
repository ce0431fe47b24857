"""repro_torch topology schedules against the JAX package, on the CPU:
``masked_metropolis`` on random masks, every schedule's ``mixing_at`` /
degrees / spectral quantities, ``make_topology_schedule``'s specs, the
dropout mask's law, and suite FT's bits table (``BENCH_FT.json``) from the
trainers of both sides.

Tolerances: matchings, adjacency, masks and bits exact; mixing weights
exact (the same f32 operations on small integers); spectral gap, beta and
gamma to 1e-12 (the same numpy code).
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core import topology as jtopo
from repro_torch.core import topology
from repro_torch.launch import comparisons
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
SPECS = ["ring", "torus", "star", "erdos_renyi", "roundrobin:ring,torus",
         "roundrobin:ring,star,mesh", "matching", "matching:3"]


@pytest.mark.parametrize("name", ["ring", "torus", "mesh", "star", "erdos_renyi"])
@pytest.mark.parametrize("m", [2, 5, 10])
def test_masked_metropolis_matches_reference(name, m):
    adj = jtopo.make_topology(name, m).adjacency
    rng = np.random.default_rng(m)
    for _ in range(6):
        alive = (rng.random(m) < 0.7).astype(np.float32)
        want = np.asarray(jtopo.masked_metropolis(adj, jnp.asarray(alive)))
        got = topology.masked_metropolis(adj, torch.from_numpy(alive)).numpy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_allclose(got.sum(0), 1.0, atol=1e-6)
        np.testing.assert_allclose(got.sum(1), 1.0, atol=1e-6)
        dead = alive == 0
        np.testing.assert_array_equal(got[dead][:, dead], np.eye(int(dead.sum())))


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("dropout", [0.0, 0.2])
def test_schedule_matches_reference(spec, dropout):
    m = 9
    js = jtopo.make_topology_schedule(spec, m, dropout=dropout, seed=3)
    ts = topology.make_topology_schedule(spec, m, dropout=dropout, seed=3)
    assert type(ts).__name__ == type(js).__name__ and ts.name == js.name
    assert (ts.period, ts.is_static, ts.dropout_rate) == (js.period, js.is_static,
                                                          js.dropout_rate)
    np.testing.assert_array_equal(ts.mixing_bank, js.mixing_bank)
    np.testing.assert_array_equal(ts.adjacency_bank, js.adjacency_bank)
    assert ts.max_degree == js.max_degree
    assert ts.expected_degree == js.expected_degree
    assert ts.spectral_gap == pytest.approx(js.spectral_gap, abs=1e-12)
    assert ts.beta == pytest.approx(js.beta, abs=1e-12)
    for delta in (0.05, 0.5):
        try:
            want = js.consensus_step_size(delta)
        except ValueError:
            with pytest.raises(ValueError, match="never connects"):
                ts.consensus_step_size(delta)
            continue
        assert ts.consensus_step_size(delta) == pytest.approx(want, rel=1e-12)
    rng = np.random.default_rng(1)
    for t in range(2 * ts.period + 1):
        np.testing.assert_array_equal(ts.mixing_at(t).numpy(), np.asarray(js.mixing_at(t)))
        alive = (rng.random(m) < 0.6).astype(np.float32)
        np.testing.assert_array_equal(ts.mixing_at(t, torch.from_numpy(alive)).numpy(),
                                      np.asarray(js.mixing_at(t, jnp.asarray(alive))))
        assert ts.realized_degree(t, alive) == js.realized_degree(t, alive)
        assert ts.realized_degree_traced(t, alive) == float(
            js.realized_degree_traced(t, jnp.asarray(alive)))
        assert ts.realized_degree_traced(t, None) == float(js.realized_degree_traced(t, None))


def test_topology_degrees_match_reference():
    for name in ("ring", "torus", "star", "erdos_renyi"):
        jt, tt = jtopo.make_topology(name, 7), topology.make_topology(name, 7)
        alive = np.array([1, 0, 1, 1, 0, 1, 1], np.float32)
        assert tt.expected_degree == jt.expected_degree
        assert tt.realized_degree(0, alive) == jt.realized_degree(0, alive)
        assert tt.realized_degree_traced(0, alive) == float(
            jt.realized_degree_traced(0, jnp.asarray(alive)))
        assert tt.realized_degree_traced(0, None) == float(jt.realized_degree_traced(0, None))


def test_matchings_equal_the_reference_draws():
    for m, period, seed in ((10, 8, 0), (7, 5, 11), (2, 1, 4)):
        js, ts = jtopo.MatchingSchedule(m, period, seed), topology.MatchingSchedule(m, period,
                                                                                   seed)
        np.testing.assert_array_equal(ts.mixing_bank, js.mixing_bank)
        assert ts.max_degree == 1 or m == 2


def test_schedule_specs_and_errors():
    s = topology.make_topology_schedule("roundrobin:ring,torus", 9)
    assert [t.name for t in s.topologies] == ["ring", "torus"] and not s.is_static
    assert topology.make_topology_schedule("ring", 5).is_static
    assert topology.make_topology_schedule("ring", 5, dropout=0.1).name == "ring+drop0.1"
    assert topology.make_topology_schedule("matching", 6, period=4).period == 4
    assert topology.make_topology_schedule("matching:3", 6).period == 3
    with pytest.raises(ValueError, match="empty roundrobin"):
        topology.make_topology_schedule("roundrobin:", 5)
    with pytest.raises(ValueError, match="dropout rate"):
        topology.BernoulliDropout(topology.ring(4), 1.0)
    with pytest.raises(ValueError, match="unknown topology"):
        topology.make_topology_schedule("hypercube", 4)


def test_dropout_mask_is_bernoulli_on_its_generator():
    s = topology.make_topology_schedule("ring", 10, dropout=0.3)
    gen = torch.Generator().manual_seed(5)
    masks = torch.stack([s.mask_at(gen, t) for t in range(2000)])
    twin = torch.Generator().manual_seed(5)
    want = torch.stack([(torch.rand(10, generator=twin) < 0.7).float() for _ in range(2000)])
    assert torch.equal(masks, want)
    assert abs(float(masks.mean()) - 0.7) < 0.02
    assert topology.make_topology_schedule("ring", 10).mask_at(gen, 0) is None


def _ft_rows():
    rows = json.loads((ROOT / "BENCH_FT.json").read_text())["rows"]
    return {(r["schedule"], r["dropout"]): r for r in rows
            if r["fault_spec"] == "none" and r["schedule"] in comparisons.FT_SCHEDULES}


@pytest.mark.parametrize("sched", list(comparisons.FT_SCHEDULES))
def test_ft_bits_table(sched):
    """BENCH_FT.json's fault-free bits, max and expected, from the port's
    trainer (``kq4b``) and the reference's (``q4b``): equal as floats."""
    from benchmarks.common import make_adgda

    rows = _ft_rows()
    for dropout in comparisons.FT_DROPOUTS:
        kw = comparisons.FT_SCHEDULES[sched]
        tr = comparisons.make_adgda(10, dropout=dropout, device="cpu", **kw)
        st = tr.init(comparisons.logistic_init(16, 4, "cpu"))
        jtr, init_fn, _ = make_adgda("logistic", 10, compressor="q4b", dropout=dropout, **kw)
        jst = jtr.init(init_fn(16, 4), jnp.zeros(2, jnp.uint32))
        row = rows[(sched, dropout)]
        for mode, key in (("max", "bits_per_round"), ("expected", "bits_per_round_expected")):
            got = tr.bits_per_round(st, mode=mode)
            assert got == float(jtr.bits_per_round(jst, mode=mode)) == row[key], (mode, got)


def test_ksweep_bits():
    """GT bills two lanes: 2256 bits a round against CHOCO's 1448; 1984 with
    a q2b tracker (BENCH_FT.json's ksweep rows)."""
    bits = {}
    for consensus, tracker in (("choco", None), ("gt", None), ("gt", "q2b")):
        tr = comparisons.make_adgda(10, consensus=consensus, local_steps=16,
                                    tracker_compressor=tracker, device="cpu")
        st = tr.init(comparisons.logistic_init(16, 4, "cpu"))
        bits[(consensus, tracker)] = (tr.bits_per_round(st),
                                      tr.bits_per_round(st, per_iteration=True))
    assert bits == {("choco", None): (1448.0, 90.5), ("gt", None): (2256.0, 141.0),
                    ("gt", "q2b"): (1984.0, 124.0)}
