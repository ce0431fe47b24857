"""Placements for every parameter / cache / batch / trainer-state tree (port
of ``repro.launch.sharding``).

Megatron-style tensor parallelism over the ``model`` mesh dim inside each
AD-GDA node; the node dimension (stacked leading axis of the trainer state)
shards over ``data`` (x ``pod``).  The rules are the reference's, name-based
on the tree path and checking divisibility: a dim that does not divide the
axis stays replicated (llama4's 40 heads over 16, ``_leaf_spec``).

Decode caches: KV heads shard over ``model`` when divisible; archs with
fewer kv heads than the axis (granite-20b's one) shard the cache *sequence*
dim instead (flash-decoding layout).

A spec is first the reference's ``PartitionSpec`` entries, one per tensor
dim (``None``, an axis name or a tuple of them), then one DTensor placement
per mesh dim (:func:`to_placements`): ``Shard(d)`` on every mesh dim named
by tensor dim ``d``'s entry (a node axis ``("pod", "data")`` is ``Shard(0)``
on both, pod outer), ``Replicate()`` on the others.  The rules read only
``mesh.mesh_dim_names`` and ``mesh.shape``.  :func:`shardings` places an
abstract tree on a mesh as DTensors of empty local shards (fake tensors
under a ``FakeTensorMode``).
"""
from __future__ import annotations

from typing import Any

from torch.distributed.tensor import Replicate, Shard

__all__ = [
    "to_placements",
    "param_pspecs",
    "batch_pspecs",
    "cache_pspecs",
    "trainer_state_pspecs",
    "node_shardings",
    "adgda_state_pspecs",  # deprecated alias
    "shardings",
]


def _axis_size(mesh, name: str) -> int:
    return dict(zip(mesh.mesh_dim_names, mesh.shape)).get(name, 1)


def to_placements(spec, mesh) -> tuple:
    """``PartitionSpec`` entries -> one placement per mesh dim."""
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        for axis in (entry if isinstance(entry, tuple) else (entry,)):
            if axis is not None:
                out[names.index(axis)] = Shard(d)
    return tuple(out)


def _with_paths(tree, fn, names=()):
    """``fn(names, leaf)`` over a tree of dicts / lists / tuples."""
    if isinstance(tree, dict):
        return {k: _with_paths(v, fn, names + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_with_paths(v, fn, names + (str(i),)) for i, v in enumerate(tree))
    return fn(list(names), tree)


def _leaf_spec(names: list[str], shape: tuple[int, ...], msize: int) -> tuple:
    """Spec for an *unstacked* model leaf (no node axis, no block axis)."""
    name = names[-1]

    def div(d):
        return d < len(shape) and shape[d] % msize == 0 and shape[d] >= msize

    if name == "table":  # embedding [V, d]: shard vocab
        return ("model", None) if div(0) else (None, None)
    if name in ("wq", "wk", "wv"):
        return (None, "model", None) if div(1) else (None, None, None)
    if name == "wo":
        return ("model", None, None) if div(0) else (None, None, None)
    if name in ("bq", "bk", "bv"):
        return ("model", None) if div(0) else (None, None)
    if name in ("w_gate", "w_up"):
        if len(shape) == 3:  # MoE experts [E, d, f]: expert parallelism
            return ("model", None, None) if div(0) else (
                None, None, "model" if shape[2] % msize == 0 else None)
        return (None, "model") if div(1) else (None, None)
    if name == "w_down":
        if len(shape) == 3:
            return ("model", None, None) if div(0) else (
                None, "model" if shape[1] % msize == 0 else None, None)
        return ("model", None) if div(0) else (None, None)
    if name == "w1":
        return (None, "model") if div(1) else (None, None)
    if name == "w2":
        return ("model", None) if div(0) else (None, None)
    if name == "b1":
        return ("model",) if div(0) else (None,)
    if name == "in_proj":  # mamba2 [d, 2di+2N+H]: column-parallel
        return (None, "model") if div(1) else (None, None)
    if name == "out_proj":
        return ("model", None) if div(0) else (None, None)
    if name in ("w_gate_branch", "w_in", "w_a", "w_x"):
        return (None, "model") if div(1) else (None, None)
    if name == "w_out":
        return ("model", None) if div(0) else (None, None)
    # router, norms, biases, conv weights, SSM scalars: replicate
    return (None,) * len(shape)


def param_pspecs(params: Any, mesh, *, node_axes: tuple[str, ...] = ()) -> Any:
    """Placement tree mirroring ``params`` (the reference's tree, e.g.
    ``steps.abstract_params``).

    ``node_axes``: mesh axes of a leading stacked AD-GDA node dimension
    (("data",) or ("pod", "data")), sharding dim 0 of every leaf.  Stacked
    pattern-block leaves (under "blocks" / "encoder") keep their repeat
    dimension replicated.
    """
    msize = _axis_size(mesh, "model")
    lead: tuple = (tuple(node_axes),) if node_axes else ()

    def spec_for(names, leaf):
        shape = tuple(leaf.shape)
        block = ("blocks" in names) or ("encoder" in names and "final_norm" not in names)
        drop = len(lead) + (1 if block else 0)
        inner = _leaf_spec(names, shape[drop:], msize)
        return to_placements(lead + ((None,) if block else ()) + tuple(inner), mesh)

    return _with_paths(params, spec_for)


def batch_pspecs(batch: Any, mesh, *, lead_axes: tuple[str, ...] = ("data",)) -> Any:
    """Token / frame / patch batches: shard the leading (node or batch) dim
    over ``lead_axes`` when divisible, else replicate."""
    lsize = 1
    for a in lead_axes:
        lsize *= _axis_size(mesh, a)

    def spec_for(_, leaf):
        if leaf.ndim >= 1 and leaf.shape[0] % lsize == 0 and leaf.shape[0] >= lsize:
            return to_placements((tuple(lead_axes),), mesh)
        return to_placements((), mesh)

    return _with_paths(batch, spec_for)


def _cache_spec(names, shape, msize, batch_ax) -> tuple:
    block = "blocks" in names
    inner = shape[1:] if block else shape
    lead = (None,) if block else ()
    name = names[-1]
    if name in ("k", "v") and len(inner) == 4:
        _, s, kv, _ = inner
        if kv % msize == 0 and kv >= msize:
            spec = (batch_ax, None, "model", None)
        elif s % msize == 0 and s >= msize:
            spec = (batch_ax, "model", None, None)  # seq-sharded (MQA)
        else:
            spec = (batch_ax, None, None, None)
    elif name == "ssm" and len(inner) == 4:  # [B, H, P, N]
        spec = (batch_ax, "model" if inner[1] % msize == 0 and inner[1] >= msize else None,
                None, None)
    elif name == "conv" and len(inner) == 3:  # [B, W, C]
        spec = (batch_ax, None, "model" if inner[2] % msize == 0 else None)
    elif name == "h" and len(inner) == 2:  # rglru state [B, dr]
        spec = (batch_ax, "model" if inner[1] % msize == 0 else None)
    elif len(inner) == 4 and "cross_kv" in names:
        kv = inner[2]
        spec = (batch_ax, None, "model" if kv % msize == 0 and kv >= msize else None, None)
    else:
        spec = (batch_ax,) + (None,) * (len(inner) - 1) if inner else ()
    return lead + tuple(spec)


def cache_pspecs(cache: Any, mesh, batch: int, *,
                 lead_axes: tuple[str, ...] = ("data",)) -> Any:
    """Decode-cache placements (the reference's cache layout,
    ``steps.abstract_cache``): batch over ``data`` (x ``pod``); heads over
    ``model`` when divisible, else the sequence dim."""
    msize = _axis_size(mesh, "model")
    dsize = 1
    for a in lead_axes:
        dsize *= _axis_size(mesh, a)
    batch_ax = tuple(lead_axes) if batch % dsize == 0 and batch >= dsize else None
    return _with_paths(cache, lambda names, leaf: to_placements(
        _cache_spec(names, tuple(leaf.shape), msize, batch_ax), mesh))


def trainer_state_pspecs(state: Any, params_spec: Any, mesh, node_axes: tuple[str, ...]):
    """Placements of a trainer state, shaped like its reference-named tree
    (``checkpoint.npz.state_tree(state)``): theta / theta_hat / s / the
    mirrors / the optimizer moments like ``params_spec`` (with node axis),
    lam [m, m] on the node dim, counters replicated; ``theta_avg`` (no node
    axis) by :func:`param_pspecs`."""
    repl = to_placements((), mesh)

    def choco(cons) -> dict:
        if hasattr(cons, "tracker"):  # GTState
            return {"model": choco(cons.model), "tracker": choco(cons.tracker),
                    "y": params_spec, "d_prev": params_spec}
        tree = {"theta_hat": params_spec, "s": params_spec}
        if cons.cache:
            tree["cache"] = [params_spec for _ in cons.cache]
        if cons.fault != ():
            tree["fault"] = {k: repl for k in cons.fault._asdict()}
        return tree

    opt = {"step": repl}
    for name in ("mu", "nu"):
        if getattr(state.opt, name):
            opt[name] = params_spec
    tree = {"step": repl, "theta": params_spec,
            "lam": to_placements((tuple(node_axes), None), mesh), "opt": opt}
    cons = state.consensus
    if not (isinstance(cons, tuple) and not cons):
        tree["consensus"] = {"bits": repl} if hasattr(cons, "bits") else choco(cons)
    if state.theta_avg != ():
        tree["theta_avg"] = param_pspecs(state.theta_avg, mesh)
    return tree


def node_shardings(tree: Any, mesh, num_nodes: int,
                   node_axes: tuple[str, ...] = ("data",)) -> Any:
    """Placements that *place the node shards*: every stacked
    ``[num_nodes, ...]`` leaf gets its leading axis on ``node_axes``,
    everything else is replicated."""
    node = to_placements((tuple(node_axes),), mesh)
    repl = to_placements((), mesh)
    return _with_paths(tree, lambda _, leaf: node if len(getattr(leaf, "shape", ())) >= 1
                       and leaf.shape[0] == num_nodes else repl)


# deprecated alias (pre-refactor name)
adgda_state_pspecs = trainer_state_pspecs


def shardings(mesh, spec_tree: Any, tree: Any) -> Any:
    """DTensors on ``mesh`` with ``spec_tree``'s placements and the shapes
    and dtypes of ``tree``'s leaves (abstract tensors): each local shard an
    empty tensor on the mesh's device -- a fake one, allocating nothing,
    under a ``FakeTensorMode``.  The placements must divide the dims."""
    from torch.distributed.tensor import empty

    def place(names, leaf):
        placements = _at(spec_tree, names)
        return empty(tuple(leaf.shape), dtype=leaf.dtype, device_mesh=mesh,
                     placements=placements)

    return _with_paths(tree, place)


def _at(tree, names):
    for n in names:
        tree = tree[n] if isinstance(tree, dict) else tree[int(n)]
    return tree
