"""Bytes the gossip kernels of one round must move, from the chunk plan's
shapes: each input byte read once and each output byte written once,
whatever a kernel reads again (the fused mix reads each neighbour's payload
once per shift; it counts once).

* ``fused_encode``: reads theta_new and theta_hat (leaf type) and the f32
  noise over the padded ``[m, rows, 128]`` grid and the [m, 2] scales;
  writes the packed levels (b/8 byte an element), the packed signs (1/8)
  and theta_hat (leaf type).
* ``fused_mix``: reads the packed payload and the f32 s grid and the
  [K, m] weights; writes the f32 s grid.
* ``block_topk``: reads and writes the f32 residual, padded to whole blocks.

:func:`plan` returns the kernels a compressor launches (substrings of their
names in the trace) and the bytes a round, or None for a compressor whose
kernels are not counted here.
"""
from __future__ import annotations

import math

from portbench.reference.gossip import LANES, scan_plan
from portbench.spec import leaf_list

ESIZE = {"bfloat16": 2, "float16": 2, "float32": 4}


def _encodes(model: dict, m: int):
    """(elements a node, element size) of every encode of a round."""
    for _, shape, _, dt in leaf_list(model):
        full = (m,) + tuple(shape)
        plan = scan_plan(full)
        inner = math.prod(shape)
        n = 1 if plan is None else plan[1]
        for _ in range(n):
            yield inner // n, ESIZE[dt]


def plan(model: dict, wl: dict) -> dict | None:
    m = wl["nodes"]
    comp = wl["compressor"]
    shifts = 3 if m >= 3 else m
    total = 0.0
    if comp.get("spec", "").startswith("kq") and wl.get("fused_gossip"):
        bits = int(comp["spec"][2:-1])
        unit = (8 // bits) * 8 * LANES
        for d, es in _encodes(model, m):
            grid = m * (-(-d // unit) * unit)
            payload = grid * (bits + 1) / 8
            total += grid * (2 * es + 4 + es) + payload + m * 2 * 4  # encode
            total += payload + 2 * grid * 4 + shifts * m * 4  # mix
        return {"kernels": ("fused_encode_kernel", "fused_mix_kernel"), "bytes": total}
    if comp.get("kind") == "block_topk":
        block = comp["block"]
        for d, _ in _encodes(model, m):
            total += 2 * 4 * m * (-(-d // block) * block)
        return {"kernels": ("block_topk_kernel",), "bytes": total}
    return None

