"""The numbers ``correct`` is decided by: each a gap between the program's
readings and the reference's, held to the cell's limit (its workload
file's ``limits``).

Norm gaps are taken by the worst leaf and node: |a - r| / max(r, the
reference's median leaf of that node), since some leaves' norms are all but
zero.  A leaf whose reference gradient is under a thousandth of the median
leaf's moves by round-off alone (a key bias under softmax does), and is
left out of ``delta_gap``.  ``delta_median_gap`` is the median over those
leaves of each leaf's worst node: where one leaf's change is noisy by
nature (block top-k's selections flip with the gradient's round-off) the
median is steady from seed to seed, and a cell compares it by naming it in
its limits (:data:`OPTIONAL`).  ``bits_gap`` holds the trainer's meter to the
reference's count of what its round encoded, relative, worst round.
"""
from __future__ import annotations

import math
import statistics

#: the compared numbers, in the order they are printed
CHECKS = ("loss_gap", "grad_gap", "delta_gap", "hat_gap", "s_gap", "cerr_gap", "lambda_gap",
          "bits_gap")
#: compared only where a cell's limits name them
OPTIONAL = ("delta_median_gap",)
QUIET = 1e-3


def _rel(a: float, r: float, floor: float) -> float:
    if not (math.isfinite(a) and math.isfinite(r)):
        return math.inf
    return abs(a - r) / max(abs(r), floor, 1e-30)


def _leaf_gaps(prog, ref, keep=None) -> list[float]:
    """Each leaf's worst node of |a - r| / max(r, median leaf of the node),
    over the nodes ``keep`` marks (a leaf with none is left out)."""
    meds = [statistics.median(row[i] for row in ref) for i in range(len(ref[0]))]
    out = []
    for j, (pa, ra) in enumerate(zip(prog, ref)):
        row = [_rel(pa[i], ra[i], med) for i, med in enumerate(meds)
               if keep is None or keep[j][i]]
        if row:
            out.append(max(row))
    return out


def _leaf_gap(prog, ref, keep=None) -> float:
    """Worst leaf and node."""
    return max(_leaf_gaps(prog, ref, keep), default=0.0)


def worst_leaves(prog: dict, ref: dict, paths: list[str]) -> dict:
    """For each norm reading, the (leaf path, node, gap) of the worst leaf:
    a diagnostic of the readings a limit is set from."""
    out = {}
    for key in ("grad_norm", "delta_norm", "hat_norm", "s_norm"):
        best = (-1.0, "", -1)
        for i in range(len(ref[key][0])):
            med = statistics.median(row[i] for row in ref[key])
            for path, pa, ra in zip(paths, prog[key], ref[key]):
                best = max(best, (_rel(pa[i], ra[i], med), path, i))
        out[key] = [best[1], best[2], best[0]]
    return out


def gaps(prog: dict, ref: dict) -> dict:
    grad = ref["grad_norm"]
    nodes = len(grad[0])
    meds = [statistics.median(row[i] for row in grad) for i in range(nodes)]
    moved = [[row[i] >= QUIET * meds[i] for i in range(nodes)] for row in grad]
    loss = max(_rel(a, r, 0.0) for pa, ra in zip(prog["loss"], ref["loss"])
               for a, r in zip(pa, ra))
    lam = max((abs(a - r) if math.isfinite(a) else math.inf)
              for pa, ra in zip(prog["lam"], ref["lam"]) for a, r in zip(pa, ra))
    return {
        "loss_gap": loss,
        "grad_gap": _leaf_gap(prog["grad_norm"], grad),
        "delta_gap": _leaf_gap(prog["delta_norm"], ref["delta_norm"], moved),
        "delta_median_gap": statistics.median(_leaf_gaps(prog["delta_norm"],
                                                         ref["delta_norm"], moved)),
        "hat_gap": _leaf_gap(prog["hat_norm"], ref["hat_norm"]),
        "s_gap": _leaf_gap(prog["s_norm"], ref["s_norm"]),
        "cerr_gap": max(_rel(a, r, 0.0) for a, r in zip(prog["cerr"], ref["cerr"])),
        "lambda_gap": lam,
        "bits_gap": max(_rel(a, r, 0.0) for a, r in zip(prog["bits"], ref["bits"])),
    }


def verdict(found: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): every compared number (each
    of :data:`CHECKS`, and of :data:`OPTIONAL` those ``limits`` names) at or
    under its limit.  A limit of None marks a number the cell does not
    compare (one that neither the control nor a fault moves past its sound
    readings); a number missing from ``limits`` fails."""
    checks = {}
    ok = True
    for name in CHECKS + tuple(n for n in OPTIONAL if n in limits):
        value = found[name]
        if name not in limits:
            ok = False
        elif limits[name] is not None:
            ok &= math.isfinite(value) and value <= limits[name]
        checks[name] = {"value": value, "limit": limits.get(name)}
    return ok, checks
