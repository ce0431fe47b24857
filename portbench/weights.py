"""Seeded weights, made by the benchmark on the device: each leaf from a
``torch.Generator`` of its own (seeded from the run's seed and the leaf's
place in the tree), in one ``randn`` call, in the configuration's type.  A
leaf can so be made again alone: the reference and the reading of the
program's change after the checked rounds make the start weights leaf by
leaf, from the seed, without keeping a copy."""
from __future__ import annotations

import math

import torch

from portbench.spec import leaf_list, nest

_MASK = (1 << 63) - 1


def leaf_seed(seed: int, index: int) -> int:
    return (seed * 1_000_003 + 7919 * (index + 1)) & _MASK


def make_leaf(seed: int, index: int, shape, init, dtype: str, device) -> torch.Tensor:
    """Leaf ``index``: normal / sqrt(fan_in), or ones / zeros, in ``dtype``."""
    dt = getattr(torch, dtype)
    if init == "ones":
        return torch.ones(shape, dtype=dt, device=device)
    if init == "zeros":
        return torch.zeros(shape, dtype=dt, device=device)
    gen = torch.Generator(device=device).manual_seed(leaf_seed(seed, index))
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return w.mul_(1.0 / math.sqrt(init)).to(dt)


def make_params(model: dict, seed: int, device):
    """The whole training tree (nested as the port's) from ``seed``."""
    return nest({path: make_leaf(seed, i, shape, init, dt, device)
                 for i, (path, shape, init, dt) in enumerate(leaf_list(model))})


def check_layout(model: dict, program_tree) -> None:
    """Raise unless the port's abstract training tree has this layout's
    leaves: the same paths, shapes and types, in the same order."""
    from portbench.spec import paths_of

    want = [(p, tuple(s), dt) for p, s, _, dt in leaf_list(model)]
    got = [(p, tuple(t.shape), str(t.dtype).removeprefix("torch."))
           for p, t in paths_of(program_tree)]
    if want != got:
        diff = [(w, g) for w, g in zip(want, got) if w != g][:3]
        raise ValueError(f"the port's training tree differs from the benchmark's layout: "
                         f"{len(want)} against {len(got)} leaves; first differences {diff}")
