"""Readings that the limits of ``correct`` are set from, on the card at the
cell's own size (the benchmark's runs do not run this):

* the program against the reference on each of ``--seeds`` (the lower
  readings: the largest gap of sound runs);
* the control, the reference in float8 e4m3 put in the program's place,
  on ``--control-seeds`` (the upper readings);
* the faults the comparison must catch, planted in the reference put in the
  program's place: ``half_batch`` and ``no_mix`` (``reference.follow``);
  a step that returns its state unchanged reads 1 in ``delta_gap`` and
  needs no run.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        --control-seeds 1,2,3 --faults half_batch,no_mix [--out FILE]

``--probe-rounds N --eta a,b`` instead runs the program N rounds past the
checked ones at each learning rate and prints the losses (to pick a cell's
``eta_theta``).  ``--look`` instead runs :func:`look` on each seed.  One JSON
object a reading, on standard output and in ``--out``; a reading of the
program, the control or a fault carries both sides' readings whole.
"""
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
os.environ["USE_FLAX"] = "0"
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def _ints(s):
    return [int(x) for x in s.split(",") if x]


def leaf_gaps(a: dict, r: dict, key: str, paths: list[str]) -> dict:
    """{leaf path: worst node's gap} of one norm reading."""
    from portbench.reference.compare import _leaf_gaps

    return dict(zip(paths, _leaf_gaps(a[key], r[key])))


def look(model: dict, wl: dict, seed: int, checked_np, dev) -> dict:
    """Where a float32 leaf's change (``delta_gap``) under block top-k comes
    from.  The reference in float32 (A) against itself with every matrix
    product's operands in bfloat16, the program's precision: (B) as it
    stands, (C) with each token's experts pinned to A's, (D) with the
    float32 leaves' block top-k selections pinned to A's; and under kq4b on
    the same sizes, bfloat16 (F) against float32 (E).  Counts the tokens
    whose expert set differs from A's, the selected entries of the float32
    leaves that differ from A's, and, in A, those on which a node's
    selection differs from node 0's."""
    import math

    import torch

    from portbench import spec
    from portbench.reference import follow
    from portbench.reference import gossip as G

    leaves = spec.leaf_list(model)
    paths = [p for p, _, _, _ in leaves]
    wide = {p for p, _, _, dt in leaves if dt == "float32"}
    sizes = {math.prod(s) for p, s, _, _ in leaves if p in wide}
    assert all(math.prod(s) not in sizes for p, s, _, _ in leaves if p not in wide)
    topk, make = torch.topk, G.make_compressor
    route = {"mode": None, "rec": [], "i": 0, "diff": []}
    sel = {"mode": None, "rec": [], "i": 0, "diff": [], "nodes": []}

    def routed(probs, k, dim=-1):
        vals, idx = topk(probs, k, dim=dim)
        if route["mode"] == "record":
            route["rec"].append(idx)
        elif route["mode"] in ("pin", "count"):
            ref = route["rec"][route["i"]]
            route["i"] += 1
            route["diff"].append(int((idx.sort(-1).values != ref.sort(-1).values)
                                     .any(-1).sum()))
            if route["mode"] == "pin":
                return probs.gather(-1, ref), ref
        return vals, idx

    class Selected(G.BlockTopK):
        def keep(self, r):
            mask = super().keep(r)
            if r.shape[1] not in sizes or sel["mode"] is None:
                return mask
            if sel["mode"] == "record":
                sel["rec"].append(mask)
                sel["nodes"].append(int((mask != mask[:1]).sum()))
                return mask
            ref = sel["rec"][sel["i"]]
            sel["i"] += 1
            sel["diff"].append(int((mask != ref).sum()))
            return ref if sel["mode"] == "pin" else mask

    def run(precision, comp, r_mode, s_mode):
        route.update(mode=r_mode, i=0, diff=[])
        sel.update(mode=s_mode, i=0, diff=[])
        w = dict(wl, compressor=comp)
        return follow(model, w, seed, checked_np, dev, precision=precision)

    def summary(a, r):
        gaps = leaf_gaps(a, r, "delta_norm", paths)
        rest = max((g, p) for p, g in gaps.items() if p not in wide)
        return {"f32_leaves": max(gaps[p] for p in wide), "other": [rest[1], rest[0]],
                "median_leaf": sorted(gaps.values())[len(gaps) // 2],
                "routing_diff": list(route["diff"]), "selection_diff": list(sel["diff"])}

    topk_comp = wl["compressor"]
    G.make_compressor = lambda c: (Selected(c["fraction"], c["block"])
                                   if c.get("kind") == "block_topk" else make(c))
    torch.topk = routed
    try:
        out = {}
        a = run("f32", topk_comp, "record", "record")
        out["A_selection_node_diff"] = list(sel["nodes"])
        out["tokens_a_call"] = int(route["rec"][0].shape[0])
        out["B"] = summary(run("bf16", topk_comp, "count", "count"), a)
        out["C"] = summary(run("bf16", topk_comp, "pin", "count"), a)
        out["D"] = summary(run("bf16", topk_comp, "count", "pin"), a)
        route["rec"] = []
        e = run("f32", {"spec": "kq4b"}, "record", None)
        out["F"] = summary(run("bf16", {"spec": "kq4b"}, "count", None), e)
    finally:
        torch.topk, G.make_compressor = topk, make
    return out


def main(argv=None):
    import argparse
    import gc
    import json

    import torch

    from portbench import data, harness, spec
    from portbench.reference import compare, follow, seeds

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_ints, default=[])
    ap.add_argument("--control-seeds", type=_ints, default=[])
    ap.add_argument("--faults", default="")
    ap.add_argument("--probe-rounds", type=int, default=0)
    ap.add_argument("--eta", default="")
    ap.add_argument("--look", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    bench = spec.load_benchmark()
    cell = spec.find_cell(bench, args.workload)
    model = spec.load_config(cell["config"])["model"]
    wl = spec.load_workload(cell["traffic"])
    out = open(args.out, "a") if args.out else None
    paths = [p for p, _, _, _ in spec.leaf_list(model)]

    def emit(rec):
        rec["workload"] = args.workload
        text = json.dumps(rec)
        print(text, flush=True)
        if out:
            out.write(text + "\n")
            out.flush()

    def free():
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    def program(seed, w, extra_rounds=0):
        checked_np, pool_np = data.batches(w, model["vocab_size"], seeds(seed)["data"])
        to_dev = lambda b: {"tokens": torch.from_numpy(b).to(dev)}  # noqa: E731
        t0 = time.perf_counter()
        trainer, state = harness.build(model, w, seed, dev)
        state, auxes, grad = harness.checked_rounds(trainer, state,
                                                    [to_dev(b) for b in checked_np])
        prog = harness.readings(model, seed, state, auxes, grad, dev)
        losses = []
        for r in range(extra_rounds):
            state, aux = trainer.step(state, to_dev(pool_np[r % len(pool_np)]))
            losses.append(aux["losses"])
        losses = [[round(float(v), 4) for v in x.float().cpu()] for x in losses]
        peak = torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda" else 0.0
        del trainer, state, auxes, grad
        free()
        return prog, checked_np, losses, time.perf_counter() - t0, peak

    if args.probe_rounds:
        for eta in [float(x) for x in args.eta.split(",")]:
            w = dict(wl, eta_theta=eta)
            for seed in args.seeds:
                prog, checked_np, losses, sec, peak = program(seed, w, args.probe_rounds)
                ref = follow(model, w, seed, checked_np, dev)
                free()
                emit({"probe": eta, "seed": seed, "checked": prog["loss"],
                      "every_10th": losses[::10] + losses[-1:], "seconds": sec,
                      "peak_gib": peak, "gaps": compare.gaps(prog, ref),
                      "worst": compare.worst_leaves(prog, ref, paths)})
        return 0

    if args.look:
        for seed in args.seeds:
            checked_np, _ = data.batches(wl, model["vocab_size"], seeds(seed)["data"])
            t0 = time.perf_counter()
            rec = look(model, wl, seed, checked_np, dev)
            free()
            emit({"look": seed, "seconds": time.perf_counter() - t0, **rec})
        return 0

    for seed in args.seeds:
        prog, checked_np, _, sec, peak = program(seed, wl)
        t0 = time.perf_counter()
        ref = follow(model, wl, seed, checked_np, dev)
        ref_s = time.perf_counter() - t0
        free()
        emit({"kind": "program", "seed": seed, "gaps": compare.gaps(prog, ref),
              "worst": compare.worst_leaves(prog, ref, paths),
              "program_s": sec, "reference_s": ref_s, "peak_gib": peak,
              "program": prog, "reference": ref})
        if seed in args.control_seeds:
            for kind, kw in [("control", {"precision": "fp8"})] + [
                    (f, {"fault": f}) for f in args.faults.split(",") if f]:
                other = follow(model, wl, seed, checked_np, dev, **kw)
                free()
                emit({"kind": kind, "seed": seed, "gaps": compare.gaps(other, ref),
                      "worst": compare.worst_leaves(other, ref, paths), "program": other})
    return 0


if __name__ == "__main__":
    sys.exit(main())
