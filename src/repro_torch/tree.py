"""Parameter trees: nested dicts and lists of tensors, flattened in the
reference's (jax) order -- dict keys sorted, lists in order.  The gossip's
per-leaf random draws, chunk plan and bit accounting follow that order."""
from __future__ import annotations

from typing import Any, Callable


def leaves(tree) -> list:
    """The tree's leaves in jax flatten order (``None`` holds no leaf)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [] if tree is None else [tree]


def unflatten(template, flat: list):
    """A tree shaped like ``template`` with ``flat`` as its leaves (in
    :func:`leaves` order)."""
    it = iter(flat)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return None if t is None else next(it)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out


def tree_map(fn: Callable[..., Any], tree, *rest):
    """``fn`` over corresponding leaves of trees of one structure."""
    flats = [leaves(t) for t in (tree, *rest)]
    if any(len(f) != len(flats[0]) for f in flats):
        raise ValueError("trees of different structure")
    return unflatten(tree, [fn(*xs) for xs in zip(*flats)])
