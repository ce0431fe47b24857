"""The ``ppermute`` backend on ``torch.distributed`` ranks (gloo, CPU)
against the port's rolled backend, section by section as the reference's
``tests/exchange_parity_main.py`` grid: the static rounds (ring and torus on
4 ranks of 2 nodes, every combo; erdos_renyi on 4 ranks of 1), the
time-varying wire (masked round-robin, matchings), the faulted wire (CHOCO
and exact), the trainer (AD-GDA, fused, GT, round-robin with dropout), the
baselines (DR-DSGD, DRFA), gradient tracking's lanes, the lambda gossip,
and the rejected meshes; then the training CLI under
``torch.distributed.run``.

Each section runs once, in one spawned world (``torch_dist_world.py``),
and each case reads its result.  Levels: static circulant rounds EXACT
(the ranks run the rolled round's operations on their rows); irregular
graphs and masked or scheduled rounds (the cached round against the rolled
dense W(t)) within 2e-6 absolute; the faulted wire EXACT against the
rolled faulted round (one round body); network means within 1e-6
relative; integers (payload bytes, fault state, the bytes each rank sent)
exact.  A few static cases are also held against the JAX package's
``gossip.choco_round``.
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
import torch_dist_world as W
from repro.core import gossip as jg
from repro.core import topology as jtopo
from repro.core.compression import Identity as JIdentity
from repro.core.compression import TopK as JTopK
from repro_torch.core import ADGDAConfig, adgda_trainer, gossip
from repro_torch.core.compression import make_compressor
from repro_torch.core.exchange import node_mesh_info, resolve_union
from repro_torch.core.gossip import _scan_plan
from repro_torch.core.topology import erdos_renyi, make_topology, make_topology_schedule
from repro_torch.core.trainer import ChocoConsensus
from repro_torch.launch import train as ttrain
from repro_torch.launch.mesh import NodeMesh, make_node_mesh
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
RANKS = 4
ULP = 2e-6


# ------------------------------------------------------------- the worlds
@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Each section's world, run on first use: {section: per-rank results}."""
    cache = {}

    def get(section):
        if section not in cache:
            cache[section] = W.run_world(section, RANKS, tmp_path_factory.mktemp(section))
        return cache[section]

    return get


@pytest.fixture(scope="module")
def rolled():
    """Each section's rolled results in this process, computed on first use."""
    cache = {}

    def get(section):
        if section not in cache:
            cache[section] = W.SECTIONS[section](None)
        return cache[section]

    return get


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


def _assembled(parts):
    """The ranks' rows of one node-stacked value, in rank order."""
    return torch.cat(parts) if parts[0].ndim else torch.stack(parts)


def _hold(ref, ranks, *, exact: bool, stacked=None, replicated=(), rel=()):
    """Hold every leaf of the ranks' results against the rolled ``ref``:
    node-stacked leaves are the ranks' rows concatenated; leaves named in
    ``replicated`` must be the same on every rank and equal ``ref``'s (at
    1e-6 relative if also in ``rel``).  Returns the worst |diff|."""
    worst = 0.0
    got = [dict(_leaves(r)) for r in ranks]
    for path, want in _leaves(ref):
        if stacked is not None and not any(path.startswith(p) for p in stacked):
            continue
        parts = [g[path] for g in got]
        if any(path.startswith(p) for p in replicated):
            for p in parts[1:]:
                assert torch.equal(p, parts[0]), f"{path}: ranks disagree"
            y = parts[0]
        else:
            y = _assembled(parts)
        assert y.shape == want.shape and y.dtype == want.dtype, path
        diff = float((y.double() - want.double()).abs().max()) if y.numel() else 0.0
        if any(path.startswith(p) for p in rel):
            scale = float(want.double().abs().max())
            assert diff <= 1e-6 * max(scale, 1e-30), f"{path}: {diff:.3e} of {scale:.3e}"
            continue
        if exact or not want.is_floating_point():
            assert torch.equal(y, want), f"{path}: not exact (worst {diff:.3e})"
        else:
            assert diff <= ULP, f"{path}: {diff:.3e} > {ULP}"
        worst = max(worst, diff)
    return worst


# ---------------------------------------------------- the bytes formula
def _shift_rows(s: int, m: int, block: int) -> int:
    """Rows a rank sends for a roll by ``s``: the whole-block permute (a
    block) plus the boundary slab, in the minimal-|s| direction."""
    s %= m
    if s == 0:
        return 0
    q, rem = divmod(m - s if s > m // 2 else s, block)
    return (block if q else 0) + rem


def _op_rows(op, m: int, rank: int) -> int:
    kind, arg = op
    block = m // RANKS
    if kind == "shift":
        return _shift_rows(int(arg), m, block)
    return sum(1 for src, dst in arg if src // block == rank and dst // block != rank)


def _row_bytes(comp, inner_shape) -> int:
    """Bytes of one node's payload for one encode of ``inner_shape`` (the
    fused round ships its dequantize scale in place of the norm: as many)."""
    x = torch.ones((1,) + tuple(inner_shape))
    shape = comp.noise_shape(1, inner_shape)
    payload = comp.encode(x, None if shape is None else torch.zeros(shape))
    return sum(t.numel() * t.element_size() for _, t in _leaves(payload))


def _chunk_shapes(tree):
    """The inner shapes of every encode of a stacked tree at the test block."""
    out = []
    for _, leaf in _leaves(tree):
        inner = int(np.prod(leaf.shape[1:]))
        plan = _scan_plan(tuple(leaf.shape), inner, W.BLOCK)
        if plan is None:
            out.append(tuple(leaf.shape[1:]))
        else:
            out += [tuple(leaf.shape[1:-1]) + (leaf.shape[-1] // plan[1],)] * plan[1]
    return out


# ------------------------------------------------------------ static grid
STATIC = [f"{t}/{c}" for t in ("ring8", "torus8") for c in W.STATIC_COMBOS] + [
    f"er4/{c}" for c in W.STATIC_COMBOS[:4]]


@pytest.mark.parametrize("case", STATIC)
def test_static_grid(case, worlds, rolled):
    """theta, theta_hat and s after 3 rounds: EXACT on the circulant graphs,
    2e-6 on erdos_renyi (edge steps against the dense matmul); every rank
    sends, per round and encode, each op's crossing rows of the payload."""
    topo_name, combo = case.split("/")
    ranks = [r[case] for r in worlds("static")]
    _hold(rolled("static")[case], ranks, exact=topo_name != "er4",
          stacked=("/theta", "/hat", "/s"))
    m = 4 if topo_name == "er4" else 8
    topo = (erdos_renyi(4, 0.6, seed=1) if topo_name == "er4"
            else make_topology(topo_name.rstrip("8"), m))
    comp = W._compressor(combo)
    ops = ([("shift", sh) for sh, _ in topo.shifts] if topo.shifts is not None
           else resolve_union(None, None, topo).ops)
    shapes = _chunk_shapes(W.theta8(m))
    dense = combo in ("identity", "q4b-unpacked")
    for rank, r in enumerate(ranks):
        per_round = sum(
            _op_rows(op, m, rank) * (4 * int(np.prod(shape)) if dense
                                     else _row_bytes(comp, shape))
            for shape in shapes for op in ops)
        assert int(r["bytes"]) == 3 * per_round, (rank, int(r["bytes"]), per_round)


@pytest.mark.parametrize("block", [1, 2, 3, 5])
def test_shard_roll_moves_one_row_per_rank(block, worlds):
    """A ring shift of +-1 sends one node row per rank whatever the block,
    and the ranks' rows are ``torch.roll`` of the whole axis."""
    ranks = [r["roll_bytes"] for r in worlds("static")]
    whole = torch.cat([torch.arange(block * 6, dtype=torch.float32).reshape(block, 6)
                       + 100 * rank for rank in range(RANKS)])
    for shift in (1, -1):
        got = torch.cat([r[f"{block}/{shift}"]["y"] for r in ranks])
        assert torch.equal(got, torch.roll(whole, shift, 0))
        assert [int(r[f"{block}/{shift}"]["bytes"]) for r in ranks] == [6 * 4] * RANKS


def test_lambda_gossip_on_the_ranks(worlds, rolled):
    """``mix_stacked_ppermute`` of lambda's rows equals ``gossip.mix_stacked``
    bit for bit; each rank sends one lambda row per ring shift."""
    ranks = [r["wire_mix"] for r in worlds("static")]
    _hold(rolled("static")["wire_mix"], ranks, exact=True, stacked=("/lam",))
    assert [int(r["bytes"]) for r in ranks] == [2 * 8 * 4] * RANKS


@pytest.mark.parametrize("case", ["ring8/identity", "torus8/identity", "ring8/top25"])
def test_static_against_the_reference(case, worlds):
    """The ranks' rounds against the JAX package's rolled ``choco_round`` on
    the same numpy inputs (Identity and top-k draw no noise), to 1e-6 of each
    leaf's largest magnitude (XLA may contract the averaging into an FMA)."""
    topo_name, combo = case.split("/")
    jtopo_ = jtopo.ring(8) if topo_name == "ring8" else jtopo.torus_2d(8)
    comp = JIdentity() if combo == "identity" else JTopK(fraction=0.25)
    theta = {k: jax.numpy.asarray(v) for k, v in W.theta8().items()}
    state = jg.choco_init(theta)
    for i in range(3):
        theta, state = jg.choco_round(theta, state, jtopo_, 0.25, comp, jax.random.PRNGKey(i),
                                      block_scan_elems=W.BLOCK)
    ranks = [r[case] for r in worlds("static")]
    for name, ref in (("theta", theta), ("hat", state.theta_hat), ("s", state.s)):
        for k in ("w", "b"):
            got = torch.cat([r[name][k] for r in ranks]).numpy()
            want = np.asarray(ref[k])
            assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max(), (name, k)


def test_one_rank_mesh_is_the_rolled_round():
    """``ppermute`` on a one-rank mesh (the reference's degenerate mesh) is
    the rolled round, bit for bit, in one process."""
    mesh = NodeMesh(rank=0, size=1, device=torch.device("cpu"))
    topo = make_topology("ring", 8)
    for combo in ("q4b-packed", "kq4b-fused", "identity"):
        comp = W._compressor(combo)
        outs = []
        for kw in ({}, dict(backend="ppermute", mesh=mesh)):
            theta = W.torch_tree(W.theta8())
            state = gossip.choco_init(theta)
            gen = torch.Generator().manual_seed(3)
            for _ in range(2):
                theta, state = gossip.choco_round(theta, state, topo, 0.25, comp, generator=gen,
                                                  fused=combo == "kq4b-fused",
                                                  block_scan_elems=W.BLOCK, **kw)
            outs.append([theta, state.theta_hat, state.s])
        for a, b in zip(*outs):
            for k in a:
                assert torch.equal(a[k], b[k]), (combo, k)


# ------------------------------------------------------------ time-varying
def _mirrors_hold(hats, caches, union, synced=None):
    """Every mirror (every synced one, under faults) equals its sender's
    theta_hat bit for bit."""
    for k, snd in enumerate(union.senders):
        for key in hats:
            for i, j in enumerate(snd):
                if j >= 0 and (synced is None or synced[i, k] > 0):
                    assert torch.equal(caches[k][key][i], hats[key][j]), (k, key, i)


@pytest.mark.parametrize("case", ["masked/identity", "masked/q4b-packed", "matching"])
def test_time_varying_wire(case, worlds, rolled):
    """The cached round on the ranks against the rolled masked round (dense
    W(t)): within 2e-6; every mirror equals its sender's theta_hat."""
    ranks = [r[case] for r in worlds("time_varying")]
    _hold(rolled("time_varying")[case], ranks, exact=False)
    m = 4 if case == "matching" else 8
    sched = (make_topology_schedule("matching:3", m, seed=0) if case == "matching"
             else make_topology_schedule("roundrobin:ring,torus", m))
    union = resolve_union(None, sched)
    hats = {k: torch.cat([r["hat"][k] for r in ranks]) for k in ranks[0]["hat"]}
    caches = [{k: torch.cat([r["cache"][op][k] for r in ranks]) for k in hats}
              for op in range(union.n_ops)]
    _mirrors_hold(hats, caches, union)


# ---------------------------------------------------------------- faults
@pytest.mark.parametrize("name", sorted(W.FAULT_SPECS))
def test_faulted_wire(name, worlds, rolled):
    """The faulted round on the ranks against the rolled faulted round (one
    round body): theta, theta_hat, s, every mirror, the fault state and the
    meter EXACT, and the exact wire's memoryless mix and meter EXACT; every
    synced mirror equals its sender's hat; the bytes each rank sent equal
    the formula from the round's resync requests."""
    ref = rolled("faulted")[name]
    ranks = [r[name] for r in worlds("faulted")]
    _hold({k: v for k, v in ref.items() if k not in ("bytes", "wants")},
          [{k: v for k, v in r.items() if k not in ("bytes", "wants")} for r in ranks],
          exact=True)
    fault = {f: torch.cat([r["fault"][f] for r in ranks]) for f in ref["fault"]}
    assert int(fault["detected"].sum()) > 0
    if name == "fused":
        assert int(fault["resyncs"].sum()) > 0
    m = 8
    fused = name == "fused"
    sched = None if fused else make_topology_schedule("roundrobin:ring,torus", m)
    union = resolve_union(None, sched, make_topology("ring", m) if fused else None)
    hats = {k: torch.cat([r["hat"][k] for r in ranks]) for k in ranks[0]["hat"]}
    caches = [{k: torch.cat([r["cache"][op][k] for r in ranks]) for k in hats}
              for op in range(union.n_ops)]
    _mirrors_hold(hats, caches, union, fault["synced"])
    # the bytes: alive and degree bits (4 B a row) each op, the resync
    # requests each reverse op, then per encode each op's payload and digest
    # (4 B) and the dense hat on a requested edge whose sender is here
    comp = W._compressor("kq4b-fused" if fused else "q4b-packed")
    shapes = _chunk_shapes({"w": np.zeros((m, 1024 if fused else 120), np.float32)})
    block = m // RANKS
    for rank, r in enumerate(ranks):
        want_total = 0
        for want in ref["wants"]:
            rows = sum(_op_rows(op, m, rank) for op in union.ops)
            want_total += 3 * 4 * rows
            for shape in shapes:
                want_total += rows * (_row_bytes(comp, shape) + 4)
                for k, snd in enumerate(union.senders):
                    for i, j in enumerate(snd):
                        if (want[k, i] and j // block == rank and i // block != rank):
                            want_total += 4 * int(np.prod(shape))
        assert int(r["bytes"]) == want_total, (rank, int(r["bytes"]), want_total)


# --------------------------------------------------------------- trainers
@pytest.mark.parametrize("name", ["adgda-ring", "fused-kq4b", "gt", "rr+drop"])
def test_trainer_on_the_ranks(name, worlds, rolled):
    """AD-GDA, 5 steps, logistic model on 8 nodes (2 a rank): on a static
    ring every rank's rows of theta, lambda, theta_hat and s, the losses
    and the consensus error equal the rolled trainer's EXACTLY; round-robin
    ring + torus with 25% dropout (the cached round against the masked
    one) within 2e-6, its bits billed at the union wire's realized degree.
    Lambda's mean and the network mean within 1e-6 relative."""
    ref = rolled("trainer")[f"trainer/{name}"]
    ranks = [r[f"trainer/{name}"] for r in worlds("trainer")]
    static = name != "rr+drop"
    keys = ("theta", "lam", "hat", "s", "losses", "consensus_err", "participation")
    _hold({k: ref[k] for k in keys}, [{k: r[k] for k in keys} for r in ranks], exact=static,
          replicated=("/losses", "/consensus_err", "/participation"))
    for key in ("lambda_mean", "theta_avg"):
        _hold({key: ref[key]}, [{key: r[key]} for r in ranks], exact=False,
              replicated=(f"/{key}",), rel=(f"/{key}",))
    bits = [r["bits"] for r in ranks]
    assert all(torch.equal(b, bits[0]) for b in bits)
    if static:
        assert torch.equal(bits[0], ref["bits"])
    else:  # every union edge carries a hat-delta from an alive sender
        from repro_torch.core.gossip import payload_total_bits

        sched = make_topology_schedule("roundrobin:ring,torus", 8, dropout=0.25)
        union = resolve_union(None, sched)
        total = payload_total_bits(make_compressor("q4b"), W.torch_tree(
            {"w": np.zeros((8, 20, 3), np.float32), "b": np.zeros((8, 3), np.float32)}))
        want = [float(np.float32(np.float32(total)
                                 * np.float32(union.realized_out_degree_traced(mask)))
                      + np.float32(32.0 * 8 * sched.max_degree))  # the dual's bound
                for mask in ref["participation"]]
        assert bits[0].tolist() == want


@pytest.mark.parametrize("name", ["drdsgd", "drfa"])
def test_baselines_on_the_ranks(name, worlds, rolled):
    """DR-DSGD (dense models between ring neighbours) EXACT; DRFA (the
    server average by all-reduce) within 1e-6 relative, its sample drawn
    alike on every rank."""
    ref = rolled("trainer")[f"baseline/{name}"]
    ranks = [r[f"baseline/{name}"] for r in worlds("trainer")]
    if name == "drdsgd":
        _hold({k: ref[k] for k in ("theta", "lam", "losses")},
              [{k: r[k] for k in ("theta", "lam", "losses")} for r in ranks], exact=True,
              replicated=("/lam", "/losses"))
        _hold({"avg": ref["theta_avg"]}, [{"avg": r["theta_avg"]} for r in ranks],
              exact=False, replicated=("/avg",), rel=("/avg",))
    else:
        _hold(ref, ranks, exact=False, replicated=("/theta", "/lam", "/losses", "/theta_avg"),
              rel=("/theta", "/theta_avg"))


@pytest.mark.parametrize("tracker", ["off", "on"])
def test_gradient_tracking_lanes(tracker, worlds, rolled):
    """Gradient tracking's two lanes share each edge's messages on the ranks:
    with the tracker off it is ChocoConsensus bit for bit; on, its rounds
    equal the rolled lanes' EXACTLY and leave the generator where the rolled
    round does."""
    ref = rolled("trainer")[f"gt-{tracker}"]
    ranks = [r[f"gt-{tracker}"] for r in worlds("trainer")]
    for label in ("choco", "gt"):
        _hold({"t": ref[label]["theta"]}, [{"t": r[label]["theta"]} for r in ranks],
              exact=True)
        for r in ranks:
            assert torch.equal(r[label]["gen"], ref[label]["gen"])
    if tracker == "off":
        for r in ranks:
            for k in r["gt"]["theta"]:
                assert torch.equal(r["gt"]["theta"][k], r["choco"]["theta"][k])


def test_consensus_error_by_block_owners(worlds, rolled):
    """The consensus error over 44 column blocks, each computed by its
    owner rank and added in the one-process order: equal bit for bit on
    every rank."""
    want = rolled("trainer")["consensus_err"]["err"]
    for r in worlds("trainer"):
        assert torch.equal(r["consensus_err"]["err"], want)


# ------------------------------------------------------- rejected meshes
def test_uneven_ratio_and_node_count_rejected():
    """An irregular graph needs one node per rank; a node count the ranks do
    not divide is refused, as by the reference's ``node_mesh_info``."""
    mesh = NodeMesh(rank=0, size=4, device=torch.device("cpu"))
    theta = {"w": torch.zeros(2, 16)}
    with pytest.raises(ValueError, match="one node per device"):
        gossip.choco_round(theta, gossip.choco_init(theta), erdos_renyi(8, 0.5, seed=0), 0.3,
                           make_compressor("none"), backend="ppermute", mesh=mesh)
    with pytest.raises(ValueError, match="must be divisible by the node-axis device count 4"):
        node_mesh_info(mesh, "data", 6)
    with pytest.raises(ValueError, match="must be divisible"):
        adgda_trainer(ADGDAConfig(num_nodes=6, gossip_backend="ppermute"), W.logistic_loss,
                      mesh=mesh, device="cpu")
    with pytest.raises(ValueError, match="must be divisible"):
        make_node_mesh(6, device="cpu", rank=0, world_size=4, log=False)


def test_ppermute_requires_a_mesh():
    """``ppermute`` without a mesh raises the reference's error at every
    entry point; a mesh of several ranks on the rolled backend raises."""
    msg = "requires a mesh"
    topo, comp = make_topology("ring", 4), make_compressor("q4b")
    with pytest.raises(ValueError, match=msg):
        ChocoConsensus(topo, comp, backend="ppermute")
    with pytest.raises(ValueError, match=msg):
        adgda_trainer(ADGDAConfig(num_nodes=4, gossip_backend="ppermute"), W.logistic_loss,
                      device="cpu")
    theta = {"w": torch.zeros(4, 8)}
    with pytest.raises(ValueError, match=msg):
        gossip.choco_round(theta, gossip.choco_init(theta), topo, 0.3, comp,
                           generator=torch.Generator(), backend="ppermute")
    with pytest.raises(ValueError, match="needs backend='ppermute'"):
        ChocoConsensus(topo, comp, mesh=NodeMesh(rank=0, size=2, device=torch.device("cpu")))


# -------------------------------------------------------------- the CLI
CLI = ["--arch", "qwen3-1.7b", "--reduced", "--nodes", "4", "--steps", "3", "--device", "cpu",
       "--compressor", "kq4b", "--batch-per-node", "2", "--seq", "32"]


def test_train_cli_on_two_ranks_equals_the_rolled_run(tmp_path):
    """``torch.distributed.run`` with 2 ranks of 2 nodes: the metrics file
    equals the rolled run's (losses exact, consensus error within 1e-6
    relative); rank 0 alone writes it."""
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join([str(ROOT / "src"), os.environ.get("PYTHONPATH", "")])}
    out_dist, out_roll = tmp_path / "dist.json", tmp_path / "rolled.json"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           "2", "-m", "repro_torch.launch.train", *CLI, "--gossip-backend", "ppermute",
           "--metrics-out", str(out_dist)]
    run = subprocess.run(cmd, capture_output=True, text=True, timeout=300, env=env,
                         cwd=tmp_path)
    assert run.returncode == 0, run.stdout[-3000:] + run.stderr[-3000:]
    assert run.stdout.count("mesh: rank") == 2 and run.stdout.count("arch=") == 1
    ttrain.main(CLI + ["--metrics-out", str(out_roll)])
    got, want = json.loads(out_dist.read_text()), json.loads(out_roll.read_text())
    assert got["losses"] == want["losses"] and got["final_step"] == want["final_step"]
    assert abs(got["consensus_err"] - want["consensus_err"]) <= 1e-6 * abs(want["consensus_err"])


def test_train_cli_refuses_checkpoints_on_the_ranks(tmp_path):
    """``--resume`` without ``--checkpoint`` exits on every rank under the
    launcher, before any rank joins the group (the checkpointed run on the
    ranks is ``test_torch_resume_dist.py``'s)."""
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join([str(ROOT / "src"), os.environ.get("PYTHONPATH", "")])}
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           "2", "-m", "repro_torch.launch.train", *CLI, "--gossip-backend", "ppermute",
           "--resume"]
    run = subprocess.run(cmd, capture_output=True, text=True, timeout=120, env=env,
                         cwd=tmp_path)
    assert run.returncode != 0
    assert (run.stdout + run.stderr).count("--resume requires --checkpoint") >= 2
