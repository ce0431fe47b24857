"""The dry run's rows (``experiments/dryrun_torch/*.json``, written by
``launch/dryrun.py``) as the roofline markdown table (port of
``repro.launch.roofline_table``).

  PYTHONPATH=src python -m repro_torch.launch.roofline_table [--mesh 16x16] [--tag TAG]
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.shapes import SHAPES
from repro_torch.launch.dryrun import OUT_DIR


def load_rows(mesh: str = "16x16", tag: str = "", out_dir: str = OUT_DIR) -> list[dict]:
    """The rows of one mesh: untagged ones, or those of ``tag``."""
    rows = []
    pattern = f"*_{mesh}{('_' + tag) if tag else ''}.json"
    for f in sorted(glob.glob(os.path.join(out_dir, pattern))):
        with open(f) as fh:
            r = json.load(fh)
        if r.get("mesh") != mesh or r.get("tag", "") != tag:
            continue
        rows.append(r)
    return rows


def fmt_row(r: dict) -> str:
    coll = sum(r["coll_bytes"].values()) / 1e9
    temp = (r.get("mem_per_device") or {}).get("temp_bytes")
    temp_gb = f"{temp / 2**30:.1f}" if temp else "—"
    return (
        f"| {r['arch']} | {r['shape']} | {r['compute_s']*1e3:9.1f} | "
        f"{r['memory_s']*1e3:9.1f} | {r['collective_s']*1e3:9.1f} | **{r['dominant']}** | "
        f"{r['useful_flops_frac']*100:5.1f}% | {coll:7.1f} | {temp_gb} |"
    )


def table(rows: list[dict]) -> list[str]:
    order = {get_config(a).name: i for i, a in enumerate(ARCHS)}
    shape_order = {s: i for i, s in enumerate(SHAPES)}
    rows = sorted(rows, key=lambda r: (order.get(r["arch"], 99), shape_order.get(r["shape"], 9)))
    return (["| arch | shape | compute ms | memory ms | collective ms | dominant | useful FLOPs "
             "| coll GB/dev | temp GiB/dev |", "|---|---|---:|---:|---:|---|---:|---:|---:|"]
            + [fmt_row(r) for r in rows])


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--mesh", default="16x16")
    ap.add_argument("--tag", default="")
    ap.add_argument("--out-dir", default=OUT_DIR, help="where the dry run wrote its rows")
    args = ap.parse_args(argv)
    devices = 512 if args.mesh == "2x16x16" else 256
    print(f"Mesh {args.mesh} ({devices} H100s)"
          + (f", variant tag: {args.tag}" if args.tag else " (paper-faithful baseline)"))
    for line in table(load_rows(args.mesh, args.tag, args.out_dir)):
        print(line)


if __name__ == "__main__":
    main()
