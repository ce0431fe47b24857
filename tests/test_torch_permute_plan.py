"""repro_torch's permute plans and union wire against the JAX package, on
the CPU: ``compile_permute_plan`` / ``compile_schedule_plans`` (exchange
ops, sender maps, edge steps, the reconstructed W and its masked rescale)
and ``compile_union_wire`` (ops, senders, the weight / self / active banks,
out-degrees, receiver maps) for static graphs and schedules at m in
{3, 4, 8}; the NeighborCache and the exports.  All numpy: equal exactly."""
import numpy as np
import pytest
import torch

from repro.core import exchange as jexchange
from repro.core import faults as jfaults
from repro.core import topology as jtopo
from repro.core import wire as jwire
import repro.core as jcore
import repro_torch.core as tcore
from repro_torch.core import exchange, faults, topology, wire
from repro_torch.launch import mesh as tmesh
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

MS = (3, 4, 8)
GRAPHS = ("ring", "torus", "star", "erdos_renyi", "mesh")
SCHEDULES = ("ring", "torus", "star", "erdos_renyi", "roundrobin:ring,torus", "matching:8")


@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("name", GRAPHS)
def test_permute_plan_equals_reference(name, m):
    jp = jtopo.compile_permute_plan(jtopo.make_topology(name, m))
    tp = topology.compile_permute_plan(topology.make_topology(name, m))
    assert tp.exchange_ops() == jp.exchange_ops()
    assert tp.num_exchanges == jp.num_exchanges and tp.is_circulant == jp.is_circulant
    for a, b in zip(tp.sender_maps(), jp.sender_maps(), strict=True):
        np.testing.assert_array_equal(a, b)
    assert tp.steps == tuple(topology.EdgeStep(s.perm, s.weights) for s in jp.steps)
    assert tp.self_weight == jp.self_weight and tp.shifts == jp.shifts
    np.testing.assert_array_equal(tp.mixing_matrix(), jp.mixing_matrix())
    mask = np.ones(m, np.float32)
    mask[1] = 0.0
    np.testing.assert_array_equal(tp.masked_mixing_matrix(mask), jp.masked_mixing_matrix(mask))


@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("spec", SCHEDULES)
def test_union_wire_equals_reference(spec, m):
    js = jtopo.make_topology_schedule(spec, m)
    ts = topology.make_topology_schedule(spec, m)
    jplans, tplans = jtopo.compile_schedule_plans(js), topology.compile_schedule_plans(ts)
    assert [p.exchange_ops() for p in tplans] == [p.exchange_ops() for p in jplans]
    ju = jwire.compile_union_wire(jplans, name=js.name)
    tu = wire.compile_union_wire(tplans, name=ts.name)
    assert (tu.name, tu.num_nodes, tu.period, tu.ops) == (ju.name, ju.num_nodes, ju.period,
                                                         ju.ops)
    for a, b in zip(tu.senders, ju.senders, strict=True):
        np.testing.assert_array_equal(a, b)
    for bank in ("w_bank", "self_bank", "active"):
        np.testing.assert_array_equal(getattr(tu, bank), getattr(ju, bank))
    np.testing.assert_array_equal(tu.out_degree, ju.out_degree)
    assert tu.max_out_degree == ju.max_out_degree
    for a, b in zip(faults.receiver_maps(tu), jfaults.receiver_maps(ju), strict=True):
        np.testing.assert_array_equal(a, b)
    mask = np.ones(m, np.float32)
    mask[0] = 0.0
    assert tu.realized_out_degree(mask) == ju.realized_out_degree(mask)
    assert tu.realized_out_degree_traced(torch.from_numpy(mask)) == float(
        ju.realized_out_degree_traced(mask))
    assert tu.realized_out_degree_traced(None) == float(ju.realized_out_degree_traced(None))


def test_union_dedups_shared_ops_across_phases():
    """ring and torus at m = 8 share the +-1 shifts: the union keeps one op
    for each, and phase 0 (the ring) is inactive on the torus-only ops."""
    ts = topology.make_topology_schedule("roundrobin:ring,torus", 8)
    tu = wire.compile_union_wire(topology.compile_schedule_plans(ts))
    ring_ops = topology.compile_permute_plan(topology.make_topology("ring", 8)).exchange_ops()
    assert tu.ops[:len(ring_ops)] == ring_ops and len(set(tu.ops)) == tu.n_ops
    assert not tu.active[0, len(ring_ops):].any() and tu.active[1].any(axis=1).all()


def test_neighbor_cache_is_zero_mirrors_per_op():
    theta = {"w": torch.randn(4, 6), "b": [torch.randn(4, 2, 3)]}
    cache = wire.init_neighbor_cache(theta, 3)
    assert len(cache) == 3
    for mirror in cache:
        assert mirror["w"].shape == (4, 6) and mirror["b"][0].shape == (4, 2, 3)
        assert not mirror["w"].any() and not mirror["b"][0].any()


def test_exports_match_reference():
    """The wire and plan names the reference's core package exports, and
    the faults and wire modules' ``__all__`` lists."""
    names = ("UnionWirePlan", "compile_union_wire", "init_neighbor_cache", "PermutePlan",
             "compile_permute_plan", "compile_schedule_plans", "choco_round_ppermute",
             "mix_stacked_ppermute", "server_average_ppermute", "WireFormat", "PAYLOAD",
             "DENSE", "HAT_DELTA")
    for n in names:
        assert n in jcore.__all__ and n in tcore.__all__, n
        assert getattr(tcore, n) is not None
    assert faults.__all__ == jfaults.__all__
    assert wire.__all__ == jwire.__all__
    assert exchange.__all__ == jexchange.__all__
    for n in exchange.__all__:  # the port's core also re-exports the rest of the wire
        assert n in tcore.__all__ and getattr(tcore, n) is getattr(exchange, n), n
    assert "make_node_mesh" in tmesh.__all__ and callable(tmesh.make_node_mesh)
