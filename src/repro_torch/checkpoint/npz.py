"""Pytree checkpoints in ``.npz`` (port of ``repro.checkpoint.npz``).

Leaves are addressed by their ``|``-joined tree path (``layers|0|mixer|wq``),
the reference's naming, so a checkpoint the JAX package wrote loads here:
:func:`restore_jax_params` reads one into the port's parameter layout.
bf16 leaves are stored as the 2-byte void type the reference's files carry
and read back through int16, so neither side needs ml_dtypes.  Writes are
atomic and durable: ``<file>.tmp``, fsync, ``os.replace``, fsync of the
directory.  :func:`restore_latest` walks past unreadable steps to the
newest one that loads.
"""
from __future__ import annotations

import os
import re

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.transformer import _to_tensor, params_from_jax

__all__ = [
    "save",
    "restore",
    "load_flat",
    "unflatten",
    "restore_jax_params",
    "restore_latest",
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


def save(path: str, tree, step: int | None = None) -> str:
    """Write ``tree`` (nested dicts / lists of tensors) to ``<path>[_<step>].npz``."""
    payload = {name: _to_numpy(leaf) for name, leaf in _flatten(tree)}
    fname = step_path(path, step) if step is not None else (
        path if path.endswith(".npz") else path + ".npz")
    os.makedirs(os.path.dirname(fname) or ".", exist_ok=True)
    tmp = fname + ".tmp"
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **payload)
            f.flush()
            os.fsync(f.fileno())  # durable before it becomes visible
        os.replace(tmp, fname)
        _fsync_dir(os.path.dirname(fname) or ".")  # the rename itself
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
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
