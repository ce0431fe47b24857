"""Pytree checkpoints in ``.npz`` (port of ``repro.checkpoint.npz``).

Leaves are addressed by their ``|``-joined tree path (``layers|0|mixer|wq``),
the reference's naming, so a checkpoint the JAX package wrote loads here:
:func:`restore_jax_params` reads one into the port's parameter layout.
bf16 leaves are stored as the 2-byte void type the reference's files carry
and read back through int16, so neither side needs ml_dtypes.  Writes are
atomic and durable: ``<file>.tmp``, fsync, ``os.replace``, fsync of the
directory.  :func:`restore_latest` walks past unreadable steps to the
newest one that loads.

A whole trainer state (:func:`save_state` / :func:`restore_state`) is
written under the reference's ``TrainerState`` names -- ``step``,
``theta|...``, ``lam``, ``opt|step``, ``opt|mu|...``, ``consensus|theta_hat|...``,
``consensus|s|...`` (gradient tracking: ``consensus|model|...``,
``consensus|tracker|...``, ``consensus|y|...``, ``consensus|d_prev|...``;
on a faulted wire also ``consensus|cache|<op>|...`` and
``consensus|fault|{synced,stale,wait,backoff,detected,resyncs,bits}``, or
``consensus|bits`` for the exact wire's meter), ``theta_avg|...`` -- so a
checkpoint of the reference's state restores into the port.  The port's
random generators have no counterpart there (the reference keeps one JAX
key, ``rng``, which the port ignores): their states go under the port-only
keys ``generator|gossip``, ``generator|dual``, ``generator|mask`` and
``generator|fault``, as uint8 arrays; a file without them leaves the
generators as they are.

On the ``ppermute`` backend each ``torch.distributed`` rank holds its rows
of the node-stacked leaves (:func:`state_parts` declares which).  With the
trainer's ``mesh`` every rank calls :func:`save_state`: rank 0 writes the
one file a one-process run writes at that step, whole ``[m, ...]`` leaves,
gathering each sharded leaf from the ranks as it writes it; and
:func:`restore_state` reads each rank's rows of those leaves straight from
the file.  So a file from either backend, or from the JAX package, resumes
on either.
"""
from __future__ import annotations

import dataclasses
import math
import os
import re
import warnings
import zipfile

import numpy as np
import torch

from repro_torch.core.exchange import WireMeter
from repro_torch.core.faults import FaultState, WireBits
from repro_torch.device import resolve_device
from repro_torch.models.transformer import _to_tensor, params_from_jax
from repro_torch.optim import OptState
from repro_torch.tree import unflatten as tree_unflatten

__all__ = [
    "save",
    "restore",
    "load_flat",
    "unflatten",
    "restore_jax_params",
    "restore_latest",
    "restore_state",
    "save_state",
    "state_leaves",
    "state_parts",
    "state_tree",
    "gather_bytes_sent",
    "latest_step",
    "all_steps",
    "step_path",
]

_SEP = "|"


def _flatten(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, prefix + (str(i),))
    else:
        yield _SEP.join(prefix), tree


def _to_numpy(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2")
        return t.numpy()
    return np.asarray(t)


def _strip_npz(path: str) -> str:
    return path[: -len(".npz")] if path.endswith(".npz") else path


def step_path(path: str, step: int) -> str:
    """The file :func:`save` writes for (path, step)."""
    return f"{_strip_npz(path)}_{step:08d}.npz"


def save(path: str, tree, step: int | None = None, *, mesh=None) -> str:
    """Write ``tree`` (nested dicts / lists of tensors) to ``<path>[_<step>].npz``,
    leaf by leaf.  On a ``mesh`` of several ranks ``tree`` is the same on
    every rank: rank 0 writes it and the others wait until it is visible."""
    return _write(_target(path, step), [(name, leaf, False) for name, leaf in _flatten(tree)],
                  mesh)


def _target(path: str, step: int | None) -> str:
    return step_path(path, step) if step is not None else (
        path if path.endswith(".npz") else path + ".npz")


def _write_npz(fname: str, items) -> None:
    """Write ``(name, numpy array)`` pairs as an ``.npz`` -- a stored zip of
    ``.npy`` members, as ``np.savez`` writes it -- each member as it arrives,
    so host memory holds one leaf at a time; atomically: ``<file>.tmp``,
    fsync, ``os.replace``, fsync of the directory."""
    os.makedirs(os.path.dirname(fname) or ".", exist_ok=True)
    tmp = fname + ".tmp"
    try:
        with open(tmp, "wb") as f:
            with zipfile.ZipFile(f, "w", zipfile.ZIP_STORED, allowZip64=True) as zf:
                for name, arr in items:
                    with zf.open(name + ".npy", "w", force_zip64=True) as member:
                        np.lib.format.write_array(member, np.asanyarray(arr), allow_pickle=False)
            f.flush()
            os.fsync(f.fileno())  # durable before it becomes visible
        os.replace(tmp, fname)
        _fsync_dir(os.path.dirname(fname) or ".")  # the rename itself
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


#: bytes of sharded leaves this process sent to rank 0 (:func:`save_state`)
gather_bytes_sent = WireMeter()

# the status rank 0 broadcasts before each leaf and at the end of a write
_NEXT, _FAILED, _WRITTEN = 1, 0, 2


def _gather_rows(x: torch.Tensor, mesh) -> torch.Tensor | None:
    """Every rank's ``[block, ...]`` rows of ``x`` on rank 0, as ``[m, ...]``
    on the host (None elsewhere); the bytes travel as uint8."""
    import torch.distributed as dist

    src = x.detach().to("cpu").contiguous()
    raw = src.reshape(-1).view(torch.uint8)
    if mesh.rank != 0:
        dist.gather(raw, None, dst=0, group=mesh.group)
        gather_bytes_sent.count += raw.numel()
        return None
    whole = torch.empty((mesh.size,) + tuple(src.shape), dtype=src.dtype)
    dist.gather(raw, list(whole.reshape(mesh.size, -1).view(torch.uint8).unbind(0)), dst=0,
                group=mesh.group)
    return whole.reshape((-1,) + tuple(src.shape[1:]))


def _write(fname: str, leaves, mesh) -> str:
    """Write ``(name, tensor, sharded)`` leaves to ``fname``: in one process
    as they are; on a mesh of several ranks rank 0 writes, each sharded leaf
    gathered from every rank's rows as it comes.  Before each leaf rank 0
    broadcasts whether it is still writing, and at the end whether the file
    is visible: a failed write raises on every rank, and no rank goes on
    before the file is there."""
    if mesh is None or mesh.size == 1:
        _write_npz(fname, ((name, _to_numpy(x)) for name, x, _ in leaves))
        return fname
    import torch.distributed as dist

    status = torch.zeros(1, dtype=torch.int32)

    def tell(value=None) -> int:
        if value is not None:
            status.fill_(value)
        dist.broadcast(status, 0, group=mesh.group)
        return int(status)

    if mesh.rank == 0:
        def items():
            for name, x, sharded in leaves:
                tell(_NEXT)
                yield name, _to_numpy(_gather_rows(x, mesh) if sharded else x)

        try:
            _write_npz(fname, items())
        except Exception:
            tell(_FAILED)
            raise
        tell(_WRITTEN)
        return fname
    for name, x, sharded in leaves:
        if tell() != _NEXT:
            raise RuntimeError(f"rank 0 failed to write {fname}; see its error")
        if sharded:
            _gather_rows(x, mesh)
    if tell() != _WRITTEN:
        raise RuntimeError(f"rank 0 failed to write {fname}; see its error")
    return fname


def _fsync_dir(dirname: str) -> None:
    """fsync a directory so a completed rename survives power loss.
    Best-effort: some filesystems refuse an fsync of a directory."""
    try:
        fd = os.open(dirname, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def load_flat(fname: str) -> dict[str, np.ndarray]:
    """{leaf path: numpy array} of a checkpoint file."""
    with np.load(fname) as data:
        return {k: data[k] for k in data.files}


def unflatten(flat: dict[str, np.ndarray]):
    """Rebuild the nested tree from ``|``-joined paths (integer parts are
    list indices)."""
    root: dict = {}
    for path, leaf in flat.items():
        node = root
        parts = path.split(_SEP)
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = leaf

    def listify(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [listify(node[str(i)]) for i in range(len(node))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def restore(fname: str, tree_like, device="cuda"):
    """Load into the structure of ``tree_like`` (shapes validated, dtypes
    cast to the template leaf's) on ``device``."""
    dev = resolve_device(device)
    flat = load_flat(fname)

    def build(node, prefix=()):
        if isinstance(node, dict):
            return {k: build(v, prefix + (str(k),)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [build(v, prefix + (str(i),)) for i, v in enumerate(node)]
        key = _SEP.join(prefix)
        if key not in flat:
            raise KeyError(f"checkpoint {fname} missing leaf {key!r}")
        t = _to_tensor(flat[key], dev)
        if tuple(t.shape) != tuple(node.shape):
            raise ValueError(f"{key}: shape {tuple(t.shape)} != expected {tuple(node.shape)}")
        return t.to(node.dtype)

    return build(tree_like)


def restore_jax_params(fname: str, cfg, device="cuda"):
    """A model parameter checkpoint written by the JAX package -> the port's
    parameters (see ``models.transformer.params_from_jax``)."""
    return params_from_jax(unflatten(load_flat(fname)), cfg, device=device)


def all_steps(path: str) -> list[int]:
    """All steps with a ``<path>_<step>.npz`` file, ascending."""
    path = _strip_npz(path)
    d = os.path.dirname(path) or "."
    pat = re.compile(re.escape(os.path.basename(path)) + r"_(\d{8})\.npz$")
    if not os.path.isdir(d):
        return []
    return sorted(int(m.group(1)) for f in os.listdir(d) if (m := pat.match(f)))


def latest_step(path: str) -> int | None:
    steps = all_steps(path)
    return steps[-1] if steps else None


def restore_latest(path: str, tree_like, *, log=print, device="cuda"):
    """Restore the newest *loadable* step-tagged checkpoint under ``path``
    onto ``device``.  Returns ``(tree, step)``, or ``(None, None)`` when no
    checkpoint loads: a corrupt, truncated or mismatched file is reported
    through ``log`` and skipped, falling back to the previous one."""
    for step in reversed(all_steps(path)):
        fname = step_path(path, step)
        try:
            return restore(fname, tree_like, device=device), step
        except Exception as e:  # BadZipFile / KeyError / ValueError / OSError
            log(f"checkpoint {fname} is unreadable ({type(e).__name__}: {e}); "
                f"falling back to the previous complete checkpoint")
    return None, None


_GENERATORS = ("gossip", "dual", "mask", "fault")


def _consensus_tree(cons):
    if isinstance(cons, tuple) and not cons:
        return {}
    if isinstance(cons, WireBits):  # the exact wire's faulted meter
        return {"bits": cons.bits}
    if hasattr(cons, "tracker"):  # GTState
        return {"model": _consensus_tree(cons.model), "tracker": _consensus_tree(cons.tracker),
                "y": cons.y, "d_prev": cons.d_prev}
    tree = {"theta_hat": cons.theta_hat, "s": cons.s}
    if cons.cache:  # the NeighborCache: one mirror tree per union op
        tree["cache"] = list(cons.cache)
    if isinstance(cons.fault, FaultState):
        tree["fault"] = cons.fault._asdict()
    return tree


def _generators(state) -> dict:
    return dict(zip(_GENERATORS, (state.generator, state.dual_generator,
                                  state.mask_generator, state.fault_generator)))


def state_parts(state, *, federated: bool = False) -> list[tuple[dict, bool]]:
    """A trainer state under the reference's names, in the file's order, as
    ``(subtree, sharded)`` parts: ``sharded`` says whether the part's leaves
    carry the node axis, so that on the ``ppermute`` backend each rank holds
    its ``[block, ...]`` rows of them -- theta (not a federated state's
    server model), a per-node lambda ``[m, m]``, the optimizer moments and
    the whole consensus state (theta_hat, s, GT's lanes and tracker, the
    NeighborCache mirrors, the fault state and meters, all receiver-major
    rows) -- or is the same on every rank -- the step counters, a vector
    lambda ``[m]`` and theta_avg.  Declared here by position, never read
    off a shape.  The tensors are the state's own (no copies), the step
    counters fresh int32 scalars.  Holds no generator."""
    moments = {name: tree_unflatten(state.theta, list(getattr(state.opt, name)))
               for name in ("mu", "nu") if getattr(state.opt, name)}
    parts = [({"step": torch.tensor(state.step, dtype=torch.int32)}, False),
             ({"theta": state.theta}, not federated),
             ({"lam": state.lam}, state.lam.ndim == 2),
             ({"opt": {"step": torch.tensor(state.opt.step, dtype=torch.int32)}}, False)]
    if moments:
        parts.append(({"opt": moments}, True))
    cons = _consensus_tree(state.consensus)
    if cons:
        parts.append(({"consensus": cons}, True))
    if state.theta_avg != ():
        parts.append(({"theta_avg": state.theta_avg}, False))
    return parts


def state_leaves(state, *, federated: bool = False):
    """``(name, tensor, sharded)`` for every leaf of :func:`state_parts`."""
    for tree, sharded in state_parts(state, federated=federated):
        for name, leaf in _flatten(tree):
            yield name, leaf, sharded


def state_tree(state) -> dict:
    """A trainer state as one nested tree under the reference's names (the
    parts of :func:`state_parts`, merged)."""
    tree: dict = {}
    for part, _ in state_parts(state):
        for key, sub in part.items():
            tree[key] = {**tree[key], **sub} if key in tree else sub
    return tree


def save_state(path: str, state, step: int | None = None, *, mesh=None,
               federated: bool = False) -> str:
    """Write a whole trainer state (see the module docstring), generator
    states included, to ``<path>[_<step>].npz``.  On a ``mesh`` of several
    ranks (the ``ppermute`` backend) every rank calls it: rank 0 writes the
    one file a one-process run writes, whole ``[m, ...]`` leaves, each
    sharded leaf gathered from the ranks' rows as it is written, and the
    replicated leaves and the generators from its own copy (every rank
    draws the whole node axis, so they are the same on every rank)."""
    gens = [(f"generator{_SEP}{k}", g.get_state(), False) for k, g in _generators(state).items()]
    return _write(_target(path, step), [*state_leaves(state, federated=federated), *gens], mesh)


_HEADERS = {(1, 0): np.lib.format.read_array_header_1_0,
            (2, 0): np.lib.format.read_array_header_2_0}


def _read_leaf(zf: zipfile.ZipFile, key: str, rows: slice | None, total: int | None):
    """Leaf ``key`` of an open ``.npz``, or only its rows ``rows`` of a
    leading axis that must hold ``total`` of them: a stored C-order member
    is read from the rows' offset, so host memory holds just those rows."""
    with zf.open(key + ".npy") as member:
        reader = _HEADERS.get(np.lib.format.read_magic(member))
        shape, fortran, dtype = reader(member) if reader else ((), True, None)
        if rows is not None and shape and shape[0] != total:
            raise ValueError(f"{key}: {shape[0]} rows in the file, {total} expected")
        if rows is None or fortran or dtype.hasobject:
            member.seek(0)
            arr = np.lib.format.read_array(member, allow_pickle=False)
            return arr if rows is None else arr[rows]
        row = math.prod(shape[1:]) * dtype.itemsize
        member.seek(member.tell() + rows.start * row)
        n = rows.stop - rows.start
        data = member.read(n * row)
        if len(data) != n * row:
            raise ValueError(f"{key}: the member ends before its rows {rows}")
        return np.frombuffer(data, dtype).reshape((n,) + tuple(shape[1:]))


def restore_state(fname: str, state, *, mesh=None, federated: bool = False):
    """Fill ``state`` (a trainer state of the same structure, e.g. a fresh
    ``trainer.init``) from ``fname`` in place -- leaf by leaf, each copied
    into the live tensor, so neither a second copy of the state on the
    device nor the whole file in host memory is made -- and return it with
    the file's step counters.  Dtypes are cast to the template's; shapes
    must match.  On a ``mesh`` of several ranks each rank reads its rows of
    every sharded leaf (:func:`state_parts`) and the whole of the others;
    the file is the one any run writes, whichever backend."""
    sharded_rows = mesh is not None and mesh.size > 1
    with zipfile.ZipFile(fname) as zf:
        names = {n[:-len(".npy")] for n in zf.namelist() if n.endswith(".npy")}
        for key, dst, sharded in state_leaves(state, federated=federated):
            if key not in names:
                raise KeyError(f"checkpoint {fname} missing leaf {key!r}")
            rows = total = None
            if sharded and sharded_rows:
                b = dst.shape[0]
                rows, total = slice(mesh.rank * b, (mesh.rank + 1) * b), b * mesh.size
            arr = _read_leaf(zf, key, rows, total)
            if arr.dtype.itemsize == 2 and (arr.dtype.kind == "V" or arr.dtype.name == "bfloat16"):
                arr = arr.view(np.int16)
            if tuple(arr.shape) != tuple(dst.shape):
                raise ValueError(f"{key}: shape {tuple(arr.shape)} != expected {tuple(dst.shape)}")
            with warnings.catch_warnings():  # a read-only buffer, only read by the copy
                warnings.simplefilter("ignore", UserWarning)
                src = torch.from_numpy(arr)
            if dst.dtype == torch.bfloat16 and src.dtype == torch.int16:
                src = src.view(torch.bfloat16)
            dst.copy_(src)
        for name, gen in _generators(state).items():
            key = f"generator{_SEP}{name}"
            if key in names:
                gen.set_state(torch.from_numpy(np.array(_read_leaf(zf, key, None, None),
                                                        np.uint8)))
        step = int(_read_leaf(zf, "step", None, None))
        opt_step = int(_read_leaf(zf, f"opt{_SEP}step", None, None))
    return dataclasses.replace(state, step=step, opt=OptState(opt_step, state.opt.mu,
                                                              state.opt.nu))
