"""The port's dry run against the JAX package's: input shapes, abstract trees,
placements, per-device counts and the dry run's rows.

- Shapes: ``supports_shape`` and ``input_specs`` (with and without a node
  axis) equal ``repro.configs.shapes``' for every arch and shape.
- Abstract trees: ``abstract_params``, ``abstract_cache(cfg, 128, 32768)``
  and (qwen3-1.7b, 16 nodes) ``abstract_trainer_state`` equal the
  reference's ``jax.eval_shape`` trees leaf for leaf under the ``|``-joined
  names of ``checkpoint/npz.py`` (the reference's ``rng`` key aside), and
  allocate nothing: meta tensors, fake ones for the trainer state.
- Placements: the port's rules against the reference's PartitionSpecs (on
  the ``FakeMesh`` stand-in of ``tests/test_substrate.py``, read through
  ``sharding.to_placements``) on both production meshes.
- Counts: the matmul FLOPs of a prefill, a decode step and a train step of
  reduced qwen3-1.7b, deepseek-moe-16b and llama4-scout-17b-a16e equal the
  reference's HLO dot FLOPs within 2% (the eager program runs the same
  products; XLA may fold a few); ``model_flops_for`` equals the reference's
  exactly; the bytes of a hand-built ``mm`` + ``add`` are exact; on a TP-2
  fake mesh a reduced dense forward all-reduces one [B, S, d] per attention
  and per MLP (plus the vocab-sharded embedding's), bytes exact.
- The dry run: one full-size pair in a subprocess (the fake world is
  global), its row with the reference's keys; ``long_500k`` skips the
  full-attention archs with the reference's message.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec
from torch.utils.checkpoint import set_checkpoint_early_stop
from torch.distributed.tensor import Shard

from repro.configs import ARCHS
from repro.configs import get_config as jax_config
from repro.configs import shapes as JS
from repro.launch import hlo_cost
from repro.launch import roofline as JR
from repro.launch import sharding as JSH
from repro.launch import steps as JST
from repro.models import transformer as JT
from repro_torch.checkpoint.npz import state_tree
from repro_torch.configs import get_config as torch_config
from repro_torch.configs import shapes as TS
from repro_torch.launch import dryrun as TD
from repro_torch.launch import roofline as TR
from repro_torch.launch import sharding as TSH
from repro_torch.launch import steps as TST
from repro_torch.launch.mesh import (fake_world, make_cpu_mesh, make_production_mesh, node_axes,
                                     num_nodes)
from repro_torch.launch.op_cost import OpCost
from repro_torch.models import transformer as TT
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"16x16": (("data", "model"), (16, 16), ("data",)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16), ("pod", "data"))}


class JaxMesh:
    """The reference's rules read only ``axis_names`` and ``devices.shape``."""

    def __init__(self, names, shape):
        self.axis_names = names
        self.devices = np.empty(shape, dtype=object)


class TorchMesh:
    """The port's rules read only ``mesh_dim_names`` and ``shape``."""

    def __init__(self, names, shape):
        self.mesh_dim_names = names
        self.shape = shape


def _meshes(name):
    names, shape, lead = MESHES[name]
    return JaxMesh(names, shape), TorchMesh(names, shape), lead


def _name(p):
    return str(getattr(p, "key", getattr(p, "idx", getattr(p, "name", p))))


def _jflat(tree, leaf=None):
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=leaf)[0]
    return {"|".join(_name(p) for p in path): x for path, x in flat}


def _tflat(tree, prefix=()):
    """``|``-joined names -> leaves; a tuple of placements is a leaf."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list) or (isinstance(tree, tuple) and tree
                                    and not hasattr(tree[0], "is_shard")):
        items = enumerate(tree)
    else:
        return {"|".join(prefix): tree}
    return {k: v for key, sub in items for k, v in _tflat(sub, prefix + (str(key),)).items()}


def _shape_dtype(x):
    return tuple(x.shape), str(x.dtype).split(".")[-1]


def _arch_names():
    return [a.replace("_", "-") for a in ARCHS]


# ------------------------------------------------------------------ shapes
@pytest.mark.parametrize("arch", _arch_names())
def test_input_specs_match_reference(arch):
    jcfg, tcfg = jax_config(arch), torch_config(arch)
    for name, shape in TS.SHAPES.items():
        assert dataclasses.astuple(shape) == dataclasses.astuple(JS.SHAPES[name])
        assert TS.supports_shape(tcfg, shape) == JS.supports_shape(jcfg, JS.SHAPES[name])
        for nodes in (None, 16, 32):
            want = JS.input_specs(jcfg, name, num_nodes=nodes)
            got = TS.input_specs(tcfg, name, num_nodes=nodes)
            assert set(got) == set(want)
            for k, t in got.items():
                assert t.is_meta and _shape_dtype(t) == _shape_dtype(want[k]), (name, nodes, k)


# ------------------------------------------------------------ abstract trees
@pytest.mark.parametrize("arch", _arch_names())
def test_abstract_params_and_cache_match_reference(arch):
    """Full size, names, shapes and dtypes; on the meta device."""
    jcfg, tcfg = jax_config(arch), torch_config(arch)
    for got, want in ((TST.abstract_params(tcfg), JST.abstract_params(jcfg)),
                      (TST.abstract_cache(tcfg, 128, 32768), JST.abstract_cache(jcfg, 128, 32768))):
        got, want = _tflat(got), _jflat(want)
        assert set(got) == set(want)
        for k, t in got.items():
            assert t.is_meta and _shape_dtype(t) == _shape_dtype(want[k]), k


def test_abstract_trainer_state_matches_reference():
    """qwen3-1.7b on 16 nodes at full size: the node-stacked state (theta,
    lam, the optimizer and CHOCO trackers) on fake tensors; the reference's
    ``rng`` key has no counterpart (the port's generators are not leaves)."""
    from torch._subclasses.fake_tensor import FakeTensor

    jcfg, tcfg = jax_config("qwen3-1.7b"), torch_config("qwen3-1.7b")
    want = _jflat(JST.abstract_trainer_state(JST.make_trainer(jcfg, 16), jcfg))
    want.pop("rng")
    state = TST.abstract_trainer_state(TST.make_trainer(tcfg, 16, device="cpu"), tcfg)
    got = _tflat(state_tree(state))
    assert set(got) == set(want)
    for k, t in got.items():
        assert _shape_dtype(t) == _shape_dtype(want[k]), k
    assert all(isinstance(t, FakeTensor) for k, t in got.items() if k not in ("step", "opt|step"))
    assert TST.abstract_adgda_state is TST.abstract_trainer_state


# --------------------------------------------------------------- placements
def _same_placements(got: dict, want: dict, mesh):
    assert set(got) == set(want)
    for k, spec in want.items():
        assert got[k] == TSH.to_placements(tuple(spec), mesh), (k, spec, got[k])


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", _arch_names())
def test_placements_match_reference(arch, mesh_name):
    """param_pspecs (plain, and node-stacked on the node axes), cache_pspecs
    at decode_32k (granite-20b's one kv head shards the sequence dim) and
    batch_pspecs for every shape."""
    jmesh, tmesh, lead = _meshes(mesh_name)
    jcfg, tcfg = jax_config(arch), torch_config(arch)
    isp = lambda x: isinstance(x, PartitionSpec)  # noqa: E731
    jp, tp = JST.abstract_params(jcfg), TST.abstract_params(tcfg)
    _same_placements(_tflat(TSH.param_pspecs(tp, tmesh)), _jflat(JSH.param_pspecs(jp, jmesh), isp),
                     tmesh)
    m = 32 if "pod" in lead else 16
    jstack = jax.tree.map(lambda s: jax.ShapeDtypeStruct((m,) + s.shape, s.dtype), jp)
    tstack = TT._map_tree(tp, lambda t: torch.empty((m,) + tuple(t.shape), dtype=t.dtype,
                                                    device="meta"))
    _same_placements(_tflat(TSH.param_pspecs(tstack, tmesh, node_axes=lead)),
                     _jflat(JSH.param_pspecs(jstack, jmesh, node_axes=lead), isp), tmesh)
    jc, tc = JST.abstract_cache(jcfg, 128, 32768), TST.abstract_cache(tcfg, 128, 32768)
    got = _tflat(TSH.cache_pspecs(tc, tmesh, 128, lead_axes=lead))
    _same_placements(got, _jflat(JSH.cache_pspecs(jc, jmesh, 128, lead_axes=lead), isp), tmesh)
    if arch == "granite-20b":  # [n_blocks, B, L, KV, hd]: the sequence over `model`
        assert got["blocks|0|k"][MESHES[mesh_name][0].index("model")] == Shard(2)
    for name in TS.SHAPES:
        nodes = m if name == "train_4k" else None
        jb, tb = JS.input_specs(jcfg, name, nodes), TS.input_specs(tcfg, name, nodes)
        _same_placements(_tflat(TSH.batch_pspecs(tb, tmesh, lead_axes=lead)),
                         _jflat(JSH.batch_pspecs(jb, jmesh, lead_axes=lead), isp), tmesh)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_trainer_state_placements_match_reference(mesh_name):
    """qwen3-1.7b's trainer state on 16 (32) nodes over ``data`` (x ``pod``)."""
    jmesh, tmesh, lead = _meshes(mesh_name)
    m = 32 if "pod" in lead else 16
    jcfg, tcfg = jax_config("qwen3-1.7b"), torch_config("qwen3-1.7b")
    jstate = JST.abstract_trainer_state(JST.make_trainer(jcfg, m), jcfg)
    jspec = JSH.trainer_state_pspecs(jstate, JSH.param_pspecs(jstate.theta, jmesh, node_axes=lead),
                                     jmesh, lead)
    want = _jflat(jspec, lambda x: isinstance(x, PartitionSpec))
    want.pop("rng")
    tstate = TST.abstract_trainer_state(TST.make_trainer(tcfg, m, device="cpu"), tcfg)
    got = TSH.trainer_state_pspecs(tstate, TSH.param_pspecs(tstate.theta, tmesh, node_axes=lead),
                                   tmesh, lead)
    _same_placements(_tflat(got), want, tmesh)
    nodes = _tflat(TSH.node_shardings(state_tree(tstate), tmesh, m, lead))
    assert nodes["theta|embed|table"] == TSH.to_placements((lead,), tmesh)
    assert nodes["step"] == TSH.to_placements((), tmesh)


# ------------------------------------------------------------------- counts
def _reduced(arch):
    return (dataclasses.replace(jax_config(arch).reduced(), dtype="float32"),
            dataclasses.replace(torch_config(arch).reduced(), dtype="float32"))


def _hlo_dot_flops(fn, *args, monkeypatch) -> float:
    """The reference's HLO count of the dot products alone (its per-element
    arithmetic set emptied)."""
    monkeypatch.setattr(hlo_cost, "_ARITH", set())
    return hlo_cost.analyze_hlo(jax.jit(fn).lower(*args).compile().as_text()).flops


def _counted(fn, *args) -> float:
    with OpCost() as counter, torch.no_grad():
        fn(*args)
    return counter.matmul_flops


@pytest.mark.parametrize("step", ["prefill", "decode", "train"])
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "deepseek-moe-16b", "llama4-scout-17b-a16e"])
def test_matmul_flops_match_hlo_dots(arch, step, monkeypatch):
    """Reduced configs on one device: a prefill (B2 S16 into a 32-row
    cache), a decode step (batch 1: the reference decodes a batch's MoE as
    one routing group, the port row by row; at one row they are one
    program) and one AD-GDA round on 2 nodes (B2 S16 each; forward,
    rematerialised forward and backward of every node)."""
    jcfg, tcfg = _reduced(arch)
    jp = JT.init_model(jax.random.PRNGKey(0), jcfg)
    if step == "prefill":
        toks = np.random.default_rng(0).integers(0, 512, (2, 16)).astype(np.int32)
        want = _hlo_dot_flops(JST.make_prefill_step(jcfg, 32), jp, {"tokens": jnp.asarray(toks)},
                              monkeypatch=monkeypatch)
        tp = TT.params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
        got = _counted(TST.make_prefill_step(tcfg, 32), tp, {"tokens": torch.from_numpy(toks)})
    elif step == "decode":
        jc = JT.init_cache(jcfg, 1, 32)
        tok = np.array([[3]], np.int32)
        want = _hlo_dot_flops(JST.make_decode_step(jcfg), jp, jc, jnp.asarray(tok),
                              jnp.int32(5), monkeypatch=monkeypatch)
        tp = TT.params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
        got = _counted(TST.make_decode_step(tcfg), tp, TT.init_cache(tcfg, 1, 32, device="cpu"),
                       torch.from_numpy(tok), 5)
    else:
        toks = np.random.default_rng(1).integers(0, 512, (2, 2, 16)).astype(np.int32)
        jtr = JST.make_trainer(jcfg, 2)
        jstate = jtr.init(jp, jax.random.PRNGKey(0))
        want = _hlo_dot_flops(jtr.step_impl, jstate, {"tokens": jnp.asarray(toks)},
                              monkeypatch=monkeypatch)
        ttr = TST.make_trainer(tcfg, 2, device="cpu")
        tstate = ttr.init(jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp))
        with OpCost() as counter:
            ttr.step(tstate, {"tokens": torch.from_numpy(toks)})
        got = counter.matmul_flops
    assert got == pytest.approx(want, rel=0.02), (got, want)


@pytest.mark.parametrize("arch", _arch_names())
def test_model_flops_for_matches_reference(arch, monkeypatch):
    """Full size, every shape (the reference's active count traced once)."""
    import functools

    monkeypatch.setattr(JT, "active_param_count", functools.lru_cache(JT.active_param_count))
    jcfg, tcfg = jax_config(arch), torch_config(arch)
    for name, shape in TS.SHAPES.items():
        assert TR.model_flops_for(tcfg, shape) == JR.model_flops_for(jcfg, JS.SHAPES[name])


def test_bytes_of_mm_and_add_are_exact():
    """mm [64, 32] x [32, 48] reads both and writes [64, 48]; add reads two
    [64, 48] and writes one; f32; factories and views move nothing."""
    a, b, c = torch.ones(64, 32), torch.ones(32, 48), torch.ones(64, 48)
    with OpCost() as counter:
        y = (a @ b) + c.view(64, 48)
    assert counter.cost.bytes == 4 * (64 * 32 + 32 * 48 + 64 * 48) + 4 * 3 * 64 * 48
    assert counter.matmul_flops == 2 * 64 * 48 * 32
    assert counter.cost.flops == 2 * 64 * 48 * 32 + 64 * 48 and y.shape == (64, 48)
    assert counter.cost.coll_bytes == 0


def test_tp2_forward_all_reduces_once_per_attention_and_mlp():
    """Reduced qwen3-1.7b (2 layers, 4 heads on 2 kv heads) on a (1, 2) mesh
    of fake ranks, placed by the reference's rules: the forward's only
    collectives are all-reduces of [B, S, d], one per attention, one per
    MLP and one for the vocab-sharded embedding lookup."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    _, tcfg = _reduced("qwen3-1.7b")
    B, S = 2, 16
    with fake_world(2), TD.placed_layers():
        mesh = make_cpu_mesh(1, 2)
        with FakeTensorMode(allow_non_fake_inputs=True):
            abs_p = TST.abstract_params(tcfg)
            params = TSH.shardings(mesh, TSH.param_pspecs(abs_p, mesh), abs_p)
            batch_abs = TS.batch_specs(tcfg, B, S)
            batch = TSH.shardings(mesh, TSH.batch_pspecs(batch_abs, mesh), batch_abs)
            traced = TD._run(lambda p, b: TT.forward(p, b, tcfg), (params, batch))
    d = tcfg.d_model
    assert traced.cost.coll["all-reduce"] == (2 * tcfg.num_layers + 1) * B * S * d * 4
    assert traced.cost.coll_bytes == traced.cost.coll["all-reduce"]
    assert not torch.distributed.is_initialized()


def test_train_step_per_device_is_a_quarter_on_a_2x2_mesh():
    """One AD-GDA round of reduced qwen3-1.7b (2 nodes over ``data``, each
    node's model TP-2 over ``model``) as device 0 runs it: its matmul FLOPs
    are a quarter of the one-process round's on the same shapes (its node,
    half of every product), and at most 10% more: DTensor's backward forms
    some weight gradients (the output projection's) from gathered
    activations, whole on each device (8% at this size; the count is of the
    program that runs).  Its gossip leaves as sends to the neighbour
    (collective-permutes), its TP sums as all-reduces.  Both runs without
    the recompute's early stop, so that they recompute the same ops."""
    _, tcfg = _reduced("qwen3-1.7b")
    toks = np.random.default_rng(2).integers(0, 512, (2, 2, 16)).astype(np.int32)
    ttr = TST.make_trainer(tcfg, 2, device="cpu")
    state = ttr.init(TT.init_train_params(tcfg, device="cpu"))
    with OpCost() as whole, set_checkpoint_early_stop(False):
        ttr.step(state, {"tokens": torch.from_numpy(toks)})
    with fake_world(4), TD.placed_layers(), set_checkpoint_early_stop(False):
        traced = TD.trace_train(tcfg, make_cpu_mesh(2, 2), ("data",), seq=16, global_batch=4)
    quarter = whole.matmul_flops / 4
    assert quarter <= traced.matmul_flops <= 1.1 * quarter
    assert traced.cost.coll["collective-permute"] > 0 and traced.cost.coll["all-reduce"] > 0
    assert traced.mem["argument_bytes"] > 0 and not torch.distributed.is_initialized()


# ------------------------------------------------------------------ the rows
def test_run_pair_writes_the_reference_row(tmp_path):
    """qwen3-1.7b x decode_32k on 16x16, at full size, in its own process."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    run = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                          "qwen3-1.7b", "--shape", "decode_32k", "--out-dir", str(tmp_path)],
                         capture_output=True, text=True, timeout=600, env=env, cwd=tmp_path)
    assert run.returncode == 0, run.stderr[-2000:]
    row = json.loads((tmp_path / "qwen3-1_7b_decode_32k_16x16.json").read_text())
    ref = JR.RooflineReport("a", "s", "m", 1.0, 1.0, {}, 1.0, 1).row()
    assert set(row) == set(ref) | {"compile_s"}
    assert set(row["mem_per_device"]) >= {"argument_bytes", "output_bytes", "temp_bytes",
                                          "generated_code_bytes"}
    mem = row["mem_per_device"]
    assert mem["peak_bytes"] == mem["argument_bytes"] + mem["output_bytes"] + mem["temp_bytes"]
    assert row["dominant"] in ("compute", "memory", "collective") and row["hlo_flops_per_dev"] > 0
    assert "1/1 OK" in run.stdout


@pytest.mark.parametrize("arch", ["whisper-small", "internvl2-2b"])
def test_long_500k_skips_full_attention(arch, tmp_path):
    """The reference's SKIP (``repro/launch/dryrun.py:55``), without a world."""
    row = TD.run_pair(arch, "long_500k", False, verbose=False, out_dir=str(tmp_path))
    assert row["skipped"] == f"{arch} does not support long_500k (full attention; see DESIGN)"
    assert not list(tmp_path.iterdir())


def test_production_mesh_needs_its_world():
    with pytest.raises(RuntimeError, match="needs 256 ranks"):
        make_production_mesh()
    with fake_world(512):
        mesh = make_production_mesh(multi_pod=True)
        assert mesh.mesh_dim_names == ("pod", "data", "model") and tuple(mesh.shape) == (2, 16, 16)
        assert node_axes(mesh) == ("pod", "data") and num_nodes(mesh) == 32
    assert not torch.distributed.is_initialized()


def test_roofline_table_formats_the_reference_rows(tmp_path):
    """The table's lines are the reference's ``fmt_row`` of each row, in the
    registry's arch order and the shapes' order; other meshes and tagged
    rows stay out."""
    from repro.launch import roofline_table as JRT
    from repro_torch.launch import roofline_table as TRT

    def row(arch, shape, mesh="16x16", **kw):
        r = JR.RooflineReport(arch, shape, mesh, 2e12, 3e11, {"all-reduce": 5e8}, 1e15, 256,
                              {"temp_bytes": 3 * 2**30}).row()
        return {**r, **kw}

    rows = [row("qwen3-1.7b", "decode_32k"), row("internvl2-2b", "prefill_32k"),
            row("qwen3-1.7b", "train_4k"), row("qwen3-1.7b", "train_4k", "2x16x16"),
            row("qwen3-1.7b", "prefill_32k", tag="cp")]
    for r in rows:
        tag = f"_{r['tag']}" if "tag" in r else ""
        name = f"{r['arch'].replace('.', '_')}_{r['shape']}_{r['mesh']}{tag}.json"
        (tmp_path / name).write_text(json.dumps(r))
    got = TRT.table(TRT.load_rows("16x16", out_dir=str(tmp_path)))
    want = [JRT.fmt_row(r) for r in (rows[1], rows[2], rows[0])]
    assert got[2:] == want and len(got[0].split("|")) == len(want[0].split("|"))
    assert [r["tag"] for r in TRT.load_rows("16x16", "cp", str(tmp_path))] == ["cp"]

