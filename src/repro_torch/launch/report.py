"""Markdown tables from the dry-run JSONs (port of `repro.launch.report`).

Usage:  python -m repro_torch.launch.report [--dir results/dryrun_torch]
prints markdown to stdout: the per-device dry-run table, a roofline table
per mesh, and the bottlenecks.
"""

from __future__ import annotations

import argparse
import glob
import json
import os

__all__ = ["load", "dryrun_table", "roofline_table", "bottleneck_notes", "main"]


def load(dir_: str) -> list[dict]:
    cells = []
    for f in sorted(glob.glob(os.path.join(dir_, "*.json"))):
        with open(f) as fh:
            cells.append(json.load(fh))
    return cells


def _fits_header(cells) -> str:
    sizes = sorted({c["memory"]["hbm_bytes"] for c in cells})
    return "fits " + "/".join(f"{s / 1e9:g} GB" for s in sizes) if sizes else "fits"


def roofline_table(cells, mesh: str = "pod16x16") -> str:
    rows = [c for c in cells if c["mesh"] == mesh]
    rows.sort(key=lambda c: (c["arch"], c["shape"]))
    out = [
        f"| arch | shape | peak GiB | {_fits_header(rows)} | compute s | memory s | "
        "collective s | collective GB | dominant | MODEL_FLOPS/counted | micro | mode |",
        "|---|---|---:|---|---:|---:|---:|---:|---|---:|---:|---|",
    ]
    for c in rows:
        r = c["roofline"]
        m = c["memory"]
        out.append(
            f"| {c['arch']} | {c['shape']} | "
            f"{m['peak_estimate_bytes'] / 2**30:.2f} | "
            f"{'yes' if m.get('fits_hbm') else 'NO'} | "
            f"{r['compute_s']:.4f} | {r['memory_s']:.4f} | "
            f"{r['collective_s']:.4f} | {c['collectives']['total'] / 1e9:.3f} | "
            f"{r['dominant'].replace('_s', '')} | "
            f"{c['useful_flops_ratio']:.3f} | {c.get('num_microbatches', 1)} | "
            f"{c.get('param_mode', 'tp')} |"
        )
    return "\n".join(out)


def dryrun_table(cells) -> str:
    out = [
        "| arch | shape | mesh | partition | meta run s | arg GiB | temp GiB | "
        "AR GB | AG GB | RS GB | A2A GB | CP GB |",
        "|---|---|---|---|---:|---:|---:|---:|---:|---:|---:|---:|",
    ]
    for c in sorted(cells, key=lambda c: (c["arch"], c["shape"], c["mesh"])):
        m = c["memory"]
        coll = c["collectives"]
        out.append(
            f"| {c['arch']} | {c['shape']} | {c['mesh']} | {c['partition']} | "
            f"{c['trace_s']:.1f} | {m['argument_bytes'] / 2**30:.2f} | "
            f"{m['temp_bytes'] / 2**30:.2f} | "
            f"{coll.get('all-reduce', 0) / 1e9:.1f} | "
            f"{coll.get('all-gather', 0) / 1e9:.1f} | "
            f"{coll.get('reduce-scatter', 0) / 1e9:.1f} | "
            f"{coll.get('all-to-all', 0) / 1e9:.1f} | "
            f"{coll.get('collective-permute', 0) / 1e9:.1f} |"
        )
    return "\n".join(out)


def bottleneck_notes(cells, mesh: str = "pod16x16") -> str:
    notes = {
        "compute_s": "more chips / higher-arithmetic-intensity kernels "
        "(fused attention, larger microbatches) move this down",
        "memory_s": "fusing elementwise chains and softmax interiors into "
        "hand-written kernels and bf16 intermediates cut HBM round-trips",
        "collective_s": "collective schedule/overlap (the paper's planner), "
        "gradient compression, or reduced EP span cut link bytes",
    }
    rows = [c for c in cells if c["mesh"] == mesh]
    out = ["| arch | shape | bottleneck | what would move it down |", "|---|---|---|---|"]
    for c in sorted(rows, key=lambda c: (c["arch"], c["shape"])):
        d = c["roofline"]["dominant"]
        out.append(f"| {c['arch']} | {c['shape']} | {d.replace('_s', '')} | {notes[d]} |")
    return "\n".join(out)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="results/dryrun_torch")
    ap.add_argument("--section", default="all", choices=["all", "roofline", "dryrun"])
    args = ap.parse_args(argv)
    cells = load(args.dir)
    if args.section in ("all", "dryrun"):
        print("### Dry-run (per device)\n")
        print(dryrun_table(cells))
        print()
    if args.section in ("all", "roofline"):
        for mesh in sorted({c["mesh"] for c in cells}):
            chips = next(c["chips"] for c in cells if c["mesh"] == mesh)
            print(f"### Roofline -- {mesh} ({chips} chips)\n")
            print(roofline_table(cells, mesh))
            print()
        print("### Bottlenecks\n")
        first = sorted({c["mesh"] for c in cells})
        print(bottleneck_notes(cells, "pod16x16" if "pod16x16" in first else first[0]))


if __name__ == "__main__":
    main()
