"""Spawned ``torch.distributed`` worlds for the port's multi-process wire
tests (CPU, gloo).  Not a test module: ``test_torch_exchange_dist.py`` and
``test_torch_resume_dist.py`` import it, and each rank process imports it
again without JAX.

``run_world(section, ranks, tmp_path, args=())`` starts ``ranks`` processes,
each joining one gloo group through a ``file://`` store under ``tmp_path``
with one torch thread, runs ``SECTIONS[section](mesh, *args)`` there and
saves what it returns; the parent gets one result per rank.  A world that outlives its
timeout is killed and fails the test.
"""
from __future__ import annotations

import multiprocessing as mp
import shutil
import traceback
from pathlib import Path

import numpy as np
import torch

BLOCK = 256  # test-sized BLOCK_SCAN_ELEMS: leaves above it are chunked
SEED = 7


def theta8(m: int = 8, seed: int = 0) -> dict:
    """The grid's stacked tree: a chunked leaf and a small one, f32."""
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((m, 300)).astype(np.float32),
            "b": rng.standard_normal((m, 7)).astype(np.float32)}


def torch_tree(tree, rows: slice | None = None) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v if rows is None else v[rows]))
            for k, v in tree.items()}


def logistic_loss(params, batch, rng):
    x, y = batch["x"], batch["y"]
    logits = x @ params["w"] + params["b"]
    return torch.nn.functional.cross_entropy(logits, y)


def logistic_data(m: int, dim: int = 20, classes: int = 3, per: int = 16, k: int | None = None,
                  seed: int = 1):
    rng = np.random.default_rng(seed)
    lead = (m, per) if k is None else (m, k, per)
    return {"x": rng.standard_normal(lead + (dim,)).astype(np.float32),
            "y": rng.integers(0, classes, lead).astype(np.int64)}


def fault_draws(n_ops: int, m: int, rounds: int, seed: int = 8) -> list:
    rng = np.random.default_rng(seed)
    return [rng.random((n_ops, m), dtype=np.float32) for _ in range(rounds)]


# ----------------------------------------------------------- the cases
# one definition, run by the parent on the rolled backend (mesh=None) and by
# every rank on the ppermute backend; each returns {name: tree of tensors}
# whose node-stacked leaves the parent cuts into blocks.

STATIC_COMBOS = ("identity", "q4b-unpacked", "q4b-packed", "kq4b-packed", "top25", "kq4b-fused")


def _compressor(name: str):
    from repro_torch.core.compression import make_compressor

    spec = {"identity": "none", "q4b-unpacked": "q4b", "q4b-packed": "q4b",
            "kq4b-packed": "kq4b", "top25": "top25", "kq4b-fused": "kq4b"}[name]
    return make_compressor(spec)


def _rows(mesh, m: int) -> slice:
    return slice(0, m) if mesh is None else mesh.rows(m)


def _bytes():
    from repro_torch.core.exchange import wire_bytes_sent

    return wire_bytes_sent.count


def static_case(mesh, topo_name: str, combo: str, rounds: int = 3) -> dict:
    from repro_torch.core import gossip
    from repro_torch.core.topology import erdos_renyi, make_topology

    m = 4 if topo_name == "er4" else 8
    topo = erdos_renyi(4, 0.6, seed=1) if topo_name == "er4" else make_topology(
        topo_name.rstrip("8"), m)
    rows = _rows(mesh, m)
    theta = torch_tree(theta8(m), rows)
    state = gossip.choco_init(theta)
    gen = torch.Generator().manual_seed(SEED)
    kw = {} if mesh is None else dict(backend="ppermute", mesh=mesh)
    comp = _compressor(combo)
    b0 = _bytes()
    for _ in range(rounds):
        theta, state = gossip.choco_round(
            theta, state, topo, 0.25, comp, generator=gen, packed=combo != "q4b-unpacked",
            fused=combo == "kq4b-fused", block_scan_elems=BLOCK, **kw)
    return {"theta": theta, "hat": state.theta_hat, "s": state.s,
            "bytes": torch.tensor(_bytes() - b0)}


def roll_bytes_case(mesh) -> dict:
    """Bytes one ring shift of +-1 sends, for blocks of 1, 2, 3 and 5 rows."""
    from repro_torch.core import exchange

    out = {}
    if mesh is None:  # one process sends nothing
        return out
    for block in (1, 2, 3, 5):
        x = torch.arange(block * 6, dtype=torch.float32).reshape(block, 6) + 100 * mesh.rank
        for shift in (1, -1):
            b0 = _bytes()
            y = exchange._shard_roll(x, shift, exchange._wire(mesh, block))
            out[f"{block}/{shift}"] = {"y": y, "bytes": torch.tensor(_bytes() - b0)}
    return out


def masked_case(mesh, combo: str, rounds: int = 3) -> dict:
    """Round-robin ring + torus on 8 nodes with two nodes dropped: the rolled
    masked round (dense W(t)) against the cached round on the ranks."""
    from repro_torch.core import gossip
    from repro_torch.core.topology import make_topology_schedule

    m = 8
    sched = make_topology_schedule("roundrobin:ring,torus", m)
    mask = torch.tensor([1.0, 0.0, 1.0, 1.0, 1.0, 0.0, 1.0, 1.0])
    theta = torch_tree({"w": np.random.default_rng(2).standard_normal((m, 200))
                        .astype(np.float32)}, _rows(mesh, m))
    comp = _compressor(combo)
    gen = torch.Generator().manual_seed(SEED)
    topo0 = sched.topology_at(0)
    if mesh is None:
        state = gossip.choco_init(theta)
        for i in range(rounds):
            theta, state = gossip.choco_round(theta, state, topo0, 0.25, comp, generator=gen,
                                              mixing=sched.mixing_at(i, mask), mask=mask)
        return {"theta": theta, "hat": state.theta_hat, "s": state.s}
    from repro_torch.core.exchange import resolve_union

    union = resolve_union(None, sched)
    state = gossip.choco_init(theta, cache_ops=union.n_ops)
    for i in range(rounds):
        theta, state = gossip.choco_round(theta, state, topo0, 0.25, comp, generator=gen,
                                          mask=mask, backend="ppermute", mesh=mesh,
                                          schedule=sched, step=i)
    return {"theta": theta, "hat": state.theta_hat, "s": state.s,
            "cache": list(state.cache)}


def matching_case(mesh, rounds: int = 4) -> dict:
    """One-peer matchings on 4 nodes (irregular phases, one node a rank)."""
    from repro_torch.core import gossip
    from repro_torch.core.topology import make_topology_schedule

    m = 4
    sched = make_topology_schedule("matching:3", m, seed=0)
    theta = torch_tree({"w": np.random.default_rng(3).standard_normal((m, 200))
                        .astype(np.float32)}, _rows(mesh, m))
    comp = _compressor("q4b-packed")
    gen = torch.Generator().manual_seed(SEED)
    t0 = sched.topology_at(0)
    if mesh is None:
        state = gossip.choco_init(theta)
        for i in range(rounds):
            theta, state = gossip.choco_round(theta, state, t0, 0.25, comp, generator=gen,
                                              mixing=sched.mixing_at(i, None))
        return {"theta": theta, "hat": state.theta_hat, "s": state.s}
    from repro_torch.core.exchange import resolve_union

    union = resolve_union(None, sched)
    state = gossip.choco_init(theta, cache_ops=union.n_ops)
    for i in range(rounds):
        theta, state = gossip.choco_round(theta, state, t0, 0.25, comp, generator=gen,
                                          backend="ppermute", mesh=mesh, schedule=sched,
                                          step=i)
    return {"theta": theta, "hat": state.theta_hat, "s": state.s, "cache": list(state.cache)}


FAULT_SPECS = {"drop": "drop:0.3,stale:1", "corrupt": "corrupt:0.3,stale:1",
               "fused": "drop:0.2,corrupt:0.1,stale:0"}


def faulted_case(mesh, name: str, rounds: int = 3) -> dict:
    """The faulted cached round, rolled (one process) and on the ranks: the
    round-robin schedule with q4b, or (``fused``) a static ring with kq4b on
    the fused encode's digest variant, 4 rounds so a resync lands."""
    from repro_torch.core import gossip
    from repro_torch.core.exchange import resolve_union
    from repro_torch.core.faults import parse_fault_spec
    from repro_torch.core.topology import make_topology, make_topology_schedule

    m = 8
    spec = parse_fault_spec(FAULT_SPECS[name])
    fused = name == "fused"
    sched = None if fused else make_topology_schedule("roundrobin:ring,torus", m)
    topo = make_topology("ring", m) if fused else sched.topology_at(0)
    union = resolve_union(None, sched, topo)
    rows = _rows(mesh, m)
    theta = torch_tree({"w": np.random.default_rng(4).standard_normal((m, 1024 if fused else 120))
                        .astype(np.float32)}, rows)
    state = gossip.choco_init(theta, cache_ops=union.n_ops, fault_ops=union.n_ops)
    comp = _compressor("kq4b-fused" if fused else "q4b-packed")
    gen = torch.Generator().manual_seed(SEED)
    kw = {} if mesh is None else dict(backend="ppermute", mesh=mesh)
    draws = fault_draws(union.n_ops, m, 5 if fused else rounds)
    b0 = _bytes()
    wants = []  # each round's resync requests [n_ops, receivers], before the round
    for i, u in enumerate(draws):
        wants.append(((state.fault.stale.T > spec.stale) & (state.fault.wait.T <= 0)).clone())
        theta, state = gossip.choco_round(theta, state, topo, 0.25, comp, generator=gen,
                                          fused=fused, block_scan_elems=BLOCK, schedule=sched,
                                          step=i, union=union, faults=spec,
                                          events=torch.from_numpy(u), **kw)
    out = {"theta": theta, "hat": state.theta_hat, "s": state.s, "cache": list(state.cache),
           "fault": {f: getattr(state.fault, f) for f in state.fault._fields},
           "bytes": torch.tensor(_bytes() - b0), "wants": wants}
    # the exact wire's memoryless faulted mix on the same events
    from repro_torch.core.exchange import mix_stacked_faulted_local, mix_stacked_ppermute

    x = torch_tree(theta8(m, seed=9), rows)
    for i, u in enumerate(draws):
        if mesh is None:
            x, bits = mix_stacked_faulted_local(x, union=union, step=i, faults=spec,
                                                events=torch.from_numpy(u))
        else:
            x, bits = mix_stacked_ppermute(x, topo, mesh=mesh, schedule=sched, step=i,
                                           union=union, faults=spec, events=torch.from_numpy(u))
    out["exact"], out["exact_bits"] = x, bits
    return out


def trainer_case(mesh, name: str, steps: int = 5) -> dict:
    """AD-GDA steps on a logistic model, rolled or on the ranks."""
    from repro_torch.core import ADGDAConfig, adgda_trainer

    m = 8
    base = dict(num_nodes=m, topology="ring", compressor="q4b", alpha=0.05, eta_theta=0.3,
                eta_lambda=0.2)
    base.update({"adgda-ring": {}, "fused-kq4b": dict(compressor="kq4b", fused_gossip=True),
                 "rr+drop": dict(topology_schedule="roundrobin:ring,torus", dropout=0.25),
                 "gt": dict(consensus="gt")}[name])
    if mesh is not None:
        base["gossip_backend"] = "ppermute"
    tr = adgda_trainer(ADGDAConfig(**base), logistic_loss, mesh=mesh, device="cpu")
    params = {"w": torch.zeros(20, 3), "b": torch.zeros(3)}
    st = tr.init(params, seed=42)
    data = logistic_data(m)
    batch = {k: torch.from_numpy(v[tr.rows]) for k, v in data.items()}
    auxes = []
    for _ in range(steps):
        st, aux = tr.step(st, batch)
        auxes.append(aux)
    cons = st.consensus
    model = getattr(cons, "model", cons)
    return {"theta": st.theta, "lam": st.lam, "hat": model.theta_hat, "s": model.s,
            "losses": torch.stack([a["losses"] for a in auxes]),
            "consensus_err": torch.stack([a["consensus_err"] for a in auxes]),
            "lambda_mean": torch.stack([a["lambda_mean"] for a in auxes]),
            "bits": torch.tensor([a["bits_realized"] for a in auxes], dtype=torch.float64),
            "participation": torch.stack([a.get("participation", torch.ones(m))
                                          for a in auxes]),
            "theta_avg": tr.network_mean(st)}


def baseline_case(mesh, name: str, steps: int = 4) -> dict:
    from repro_torch.core.baselines import (
        DRDSGDConfig,
        DRFAConfig,
        drdsgd_trainer,
        drfa_trainer,
    )

    m = 8
    wire = {} if mesh is None else dict(gossip_backend="ppermute")
    if name == "drdsgd":
        tr = drdsgd_trainer(DRDSGDConfig(num_nodes=m, eta_theta=0.2, alpha=6.0, **wire),
                            logistic_loss, mesh=mesh, device="cpu")
        data = logistic_data(m, dim=12, per=8)
    else:
        tr = drfa_trainer(DRFAConfig(num_nodes=m, local_steps=3, eta_theta=0.2, eta_lambda=0.1,
                                     **wire), logistic_loss, mesh=mesh, device="cpu")
        data = logistic_data(m, dim=12, per=8, k=3)
    params = {"w": torch.zeros(12, 3), "b": torch.zeros(3)}
    st = tr.init(params, seed=7)
    batch = {k: torch.from_numpy(v[tr.rows]) for k, v in data.items()}
    losses = []
    for _ in range(steps):
        st, aux = tr.step(st, batch)
        losses.append(aux["losses"])
    return {"theta": st.theta, "lam": st.lam, "losses": torch.stack(losses),
            "theta_avg": st.theta_avg}


def gt_case(mesh, tracker: bool, rounds: int = 3) -> dict:
    """GradientTrackingConsensus on a ring of 8 (q4b): the tracker off is
    ChocoConsensus; on, its two lanes share each edge's messages."""
    from repro_torch.core.compression import make_compressor
    from repro_torch.core.topology import ring
    from repro_torch.core.trainer import ChocoConsensus, GradientTrackingConsensus

    m = 8
    rows = _rows(mesh, m)
    rng = np.random.default_rng(11)
    th = {"w": rng.standard_normal((m, 64)).astype(np.float32),
          "b": rng.standard_normal((m, 5)).astype(np.float32)}
    kw = {} if mesh is None else dict(backend="ppermute", mesh=mesh)
    comp = make_compressor("q4b")
    out = {}
    makers = {"choco": lambda: ChocoConsensus(ring(m), comp, 0.25, **kw),
              "gt": lambda: GradientTrackingConsensus(ring(m), comp, 0.25, tracker=tracker,
                                                      **kw)}
    for label, make in makers.items():
        gc = make()
        t = torch_tree(th, rows)
        tp = tree_scale(t, 0.9)
        st = gc.init(t)
        gen = torch.Generator().manual_seed(SEED)
        for _ in range(rounds):
            keep = {k: v.clone() for k, v in t.items()}
            t, st = gc.mix(t, st, gen, theta_prev=tp)
            tp = keep
        out[label] = {"theta": t, "gen": gen.get_state()}
    return out


def tree_scale(tree, a: float) -> dict:
    return {k: v * a for k, v in tree.items()}


def wire_mix_case(mesh) -> dict:
    from repro_torch.core import gossip
    from repro_torch.core.exchange import mix_stacked_ppermute
    from repro_torch.core.topology import ring

    lam = torch.from_numpy(np.random.default_rng(6).standard_normal((8, 8)).astype(np.float32))
    if mesh is None:
        return {"lam": gossip.mix_stacked(lam, ring(8))}
    b0 = _bytes()
    out = mix_stacked_ppermute(lam[mesh.rows(8)].contiguous(), ring(8), mesh=mesh)
    return {"lam": out, "bytes": torch.tensor(_bytes() - b0)}


def _section_static(mesh):
    out = {f"{t}/{c}": static_case(mesh, t, c)
           for t in ("ring8", "torus8") for c in STATIC_COMBOS}
    out.update({f"er4/{c}": static_case(mesh, "er4", c) for c in STATIC_COMBOS[:4]})
    out["roll_bytes"] = roll_bytes_case(mesh)
    out["wire_mix"] = wire_mix_case(mesh)
    return out


def _section_time_varying(mesh):
    out = {f"masked/{c}": masked_case(mesh, c) for c in ("identity", "q4b-packed")}
    out["matching"] = matching_case(mesh)
    return out


def _section_faulted(mesh):
    return {name: faulted_case(mesh, name) for name in FAULT_SPECS}


def consensus_error_case(mesh) -> dict:
    """The consensus error over many column blocks (7 columns each, 3 blocks
    an exchange): each block's owner rank computes its term."""
    from repro_torch.core.trainer import _consensus_error

    theta = torch_tree(theta8(), _rows(mesh, 8))
    return {"err": _consensus_error(theta, mesh, chunk_elems=7, batch=3)}


def _section_trainer(mesh):
    out = {f"trainer/{n}": trainer_case(mesh, n)
           for n in ("adgda-ring", "fused-kq4b", "rr+drop", "gt")}
    out.update({f"baseline/{n}": baseline_case(mesh, n) for n in ("drdsgd", "drfa")})
    out.update({f"gt-{'on' if on else 'off'}": gt_case(mesh, on) for on in (False, True)})
    out["consensus_err"] = consensus_error_case(mesh)
    return out


# ------------------------------------------------- resume on the ranks
# AD-GDA on the logistic model with every kind of state a file holds: SGD
# momentum or Adam's two moments, a per-node lambda, theta_avg, GT's lanes,
# the cached round's mirrors, the fault state and its meter, and all four
# generators.  4 nodes on 2 ranks; the faulted wire as phase 17b of
# chip_smoke.py, 3 nodes on 3 ranks.
RESUME_WIRES = {
    "kq4b-packed": dict(compressor="kq4b", optimizer="adam"),
    "kq4b-fused": dict(compressor="kq4b", fused_gossip=True, momentum=0.9),
    "gt": dict(consensus="gt", momentum=0.9),
    "rr+drop": dict(topology_schedule="roundrobin:ring,torus", dropout=0.25, momentum=0.9),
    "faulted": dict(compressor="kq4b", fused_gossip=True, fault_spec=FAULT_SPECS["fused"],
                    momentum=0.9),
}
# the time-varying wire on the ranks keeps mirrors that the rolled masked
# round has no use for (as the reference's backends do): its files hold
# different leaves, so only the other wires cross between backends
CROSSING = ("kq4b-packed", "kq4b-fused", "gt", "faulted")
# the JAX package's trainer state (f32; gradient tracking, 2 local steps,
# momentum, the running average) on reduced qwen3-1.7b, as in
# test_torch_trainer_state.py
JAX_STATE = dict(compressor="none", consensus="gt", local_steps=2, momentum=0.9,
                 track_average=True)
JAX_NODES = 4


def resume_trainer(mesh, wire: str):
    from repro_torch.core import ADGDAConfig, adgda_trainer

    m = 3 if wire == "faulted" else 4
    cfg = {**dict(num_nodes=m, topology="ring", compressor="q4b", alpha=0.05, eta_theta=0.3,
                  eta_lambda=0.2), **RESUME_WIRES[wire]}
    if mesh is not None:
        cfg["gossip_backend"] = "ppermute"
    tr = adgda_trainer(ADGDAConfig(**cfg), logistic_loss, mesh=mesh, device="cpu")
    batch = {k: torch.from_numpy(v[tr.rows]) for k, v in logistic_data(m).items()}
    return tr, batch


def _fresh(tr, seed: int = 42):
    return tr.init({"w": torch.zeros(20, 3), "b": torch.zeros(3)}, seed=seed)


def _rounds(tr, state, batch, n: int):
    for _ in range(n):
        state, _ = tr.step(state, batch)
    return state


def _generators(state) -> dict:
    return {"gossip": state.generator, "dual": state.dual_generator,
            "mask": state.mask_generator, "fault": state.fault_generator}


def state_record(state) -> dict:
    """Every leaf a state file holds, under its name (the rank's rows of the
    sharded ones), with each generator's state."""
    from repro_torch.checkpoint import state_leaves

    out = {name: x.clone() for name, x, _ in state_leaves(state)}
    out.update({f"generator|{k}": g.get_state() for k, g in _generators(state).items()})
    return out


def replicated_agree(state, mesh) -> bool:
    """Whether every leaf a file takes from rank 0's copy alone -- the
    replicated leaves (theta_avg, the step counters) and the generators --
    is the same on every rank (True in one process)."""
    if mesh is None or mesh.size == 1:
        return True
    import torch.distributed as dist

    from repro_torch.checkpoint import state_leaves

    same = True
    mine = [x for _, x, sharded in state_leaves(state) if not sharded]
    mine += [g.get_state() for g in _generators(state).values()]
    for x in mine:
        x = x.detach().cpu().contiguous()
        got = [torch.empty_like(x) for _ in range(mesh.size)]
        dist.all_gather(got, x)
        same &= all(torch.equal(g, x) for g in got)
    return same


def resume_from(mesh, wire: str, fname: str) -> dict:
    """``fname`` restored into a fresh state (other generator seeds: they
    must come from the file) on ``mesh``, then 2 more rounds."""
    from repro_torch.checkpoint import restore_state

    tr, batch = resume_trainer(mesh, wire)
    state = restore_state(fname, _fresh(tr, seed=5), mesh=mesh)
    return state_record(_rounds(tr, state, batch, 2))


def resume_case(mesh, wire: str, root: str) -> dict:
    """A: 4 rounds straight.  B: 2 rounds, then saved at step 2 to
    ``<root>/<wire>-<backend>``, with the check that what rank 0 alone
    writes is the same on every rank.  C: B's file resumed.  X: the rolled
    backend's step-2 file resumed on the ranks, for a wire whose files
    cross."""
    from repro_torch.checkpoint import save_state, step_path

    tr, batch = resume_trainer(mesh, wire)
    out = {"A": state_record(_rounds(tr, _fresh(tr), batch, 4))}
    b = _rounds(tr, _fresh(tr), batch, 2)
    out["agree"] = replicated_agree(b, mesh)
    out["file"] = save_state(f"{root}/{wire}-{'rolled' if mesh is None else 'ranks'}", b,
                             step=2, mesh=mesh)
    del b
    out["C"] = resume_from(mesh, wire, out["file"])
    if mesh is not None and wire in CROSSING:
        out["X"] = resume_from(mesh, wire, step_path(f"{root}/{wire}-rolled", 2))
    return out


def torn_case(mesh, root: str) -> dict:
    """Files at steps 1, 2 and 3 on the ranks; step 3 fails to load on the
    last rank only, step 2 is torn on every rank: ``launch/train.py``'s
    resume takes step 1 on every rank."""
    import argparse

    import torch.distributed as dist

    from repro_torch.checkpoint import save_state, step_path
    from repro_torch.launch import train

    tr, batch = resume_trainer(mesh, "kq4b-packed")
    ck = f"{root}/torn/run"
    state, records = _fresh(tr), {}
    for step in (1, 2, 3):
        state = _rounds(tr, state, batch, 1)
        save_state(ck, state, step=step, mesh=mesh)
        records[step] = state_record(state)
    if mesh.rank == 0:
        with open(step_path(ck, 2), "r+b") as f:
            f.truncate(f.seek(0, 2) // 2)
    dist.barrier()
    restore = train.restore_state

    def flaky(fname, state, **kw):
        if fname == step_path(ck, 3) and mesh.rank == mesh.size - 1:
            raise OSError("an unreadable file on this rank alone")
        return restore(fname, state, **kw)

    train.restore_state = flaky
    try:
        args = argparse.Namespace(checkpoint=ck, seed=41)  # init's seed: 42, as _fresh
        got, step, _ = train._resume(tr, {"w": torch.zeros(20, 3), "b": torch.zeros(3)}, args,
                                     mesh)
    finally:
        train.restore_state = restore
    return {"step": step, "state": state_record(got), "want": records[1]}


def jax_file_case(mesh, root: str) -> dict:
    """The JAX package's step-2 trainer-state file (``<root>/jax_state``)
    restored on ``mesh`` (or in one process) and run 2 more rounds on the
    token stream's rounds 2 and 3."""
    from repro_torch.checkpoint import restore_state, step_path
    from repro_torch.configs import get_config
    from repro_torch.data import node_token_stream
    from repro_torch.launch import steps
    from repro_torch.models import transformer as T

    cfg = get_config("qwen3-1.7b").reduced(layers=2, d_model=64)
    tr = steps.make_trainer(cfg, JAX_NODES, device="cpu", mesh=mesh,
                            gossip_backend="rolled" if mesh is None else "ppermute",
                            **JAX_STATE)
    template = T.init_train_params(cfg, seed=0, device="cpu")
    state = restore_state(step_path(f"{root}/jax_state", 2), tr.init(template, seed=0),
                          mesh=mesh)
    stream = node_token_stream(JAX_NODES, 4, 8, cfg.vocab_size, seed=0)
    for _ in range(2):
        next(stream)
    aux = []
    for _ in range(2):
        tokens = torch.from_numpy(next(stream)[tr.rows])
        state, a = tr.step(state, {"tokens": tokens})
        aux.append({k: a[k] for k in ("losses", "lambda_mean")})
    return {"state": state_record(state), "aux": aux}


def _section_resume(mesh, root):
    out = {w: resume_case(mesh, w, root) for w in RESUME_WIRES if w != "faulted"}
    out["torn"] = torn_case(mesh, root)
    out["jax"] = jax_file_case(mesh, root)
    return out


def _section_resume_faulted(mesh, root):
    return {"faulted": resume_case(mesh, "faulted", root)}


SECTIONS = {"static": _section_static, "time_varying": _section_time_varying,
            "faulted": _section_faulted, "trainer": _section_trainer,
            "resume": _section_resume, "resume_faulted": _section_resume_faulted}


# ------------------------------------------------------------- the world
def _rank_main(section: str, rank: int, ranks: int, store: str, out: str, args: tuple) -> None:
    torch.set_num_threads(1)
    try:
        import torch.distributed as dist

        from repro_torch.launch.mesh import make_node_mesh

        mesh = make_node_mesh(ranks, device="cpu", init_method=f"file://{store}", rank=rank,
                              world_size=ranks, log=False)
        result = SECTIONS[section](mesh, *args)
        torch.save(result, f"{out}/{rank}.pt")
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        Path(f"{out}/{rank}.err").write_text(traceback.format_exc())
        raise


def run_world(section: str, ranks: int, tmp_path: Path, timeout: float = 120.0,
              args: tuple = ()) -> list:
    """Run ``SECTIONS[section](mesh, *args)`` on ``ranks`` spawned gloo ranks;
    returns each rank's result.  Kills the world and raises if it outlives
    ``timeout`` seconds or any rank fails."""
    out = tmp_path / f"world-{section}"
    if out.exists():
        shutil.rmtree(out)
    out.mkdir(parents=True)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(section, r, ranks, str(out / "store"), str(out), args))
             for r in range(ranks)]
    for p in procs:
        p.start()
    import time

    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    errors = {r: (out / f"{r}.err").read_text() for r in range(ranks)
              if (out / f"{r}.err").exists()}
    if hung or errors or any(p.exitcode != 0 for p in procs):
        raise AssertionError(f"world {section!r}: ranks {hung} hung past {timeout:.0f} s; "
                             f"exit codes {[p.exitcode for p in procs]}; errors {errors}")
    return [torch.load(out / f"{r}.pt", weights_only=False) for r in range(ranks)]


