"""Perf-iteration driver for the roofline hillclimb (port of
`repro.launch.perf`).

Runs one (arch x shape) cell's dry-run with config and sharding-rule
overrides and prints the three roofline terms next to the recorded
baseline, so each hypothesis -> change -> measure cycle is one command:

  python -m repro_torch.launch.perf --arch xlstm-1.3b --shape prefill_32k \\
      --override mlstm_chunk=128 --tag chunk128

Also home of `measured_roofline`: how far a measured time sits from the
roofline bound of a step's counted work (`repro_torch.launch.op_cost` for
the counts, where the reference reads HLO text; `launch.roofline` for the
bound).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from repro_torch.launch import roofline
from repro_torch.launch.op_cost import OpCost

__all__ = ["measured_roofline", "parse_overrides", "parse_rules_overrides", "main"]


def measured_roofline(cost: OpCost, measured_s: float, hw=None) -> dict:
    """Roofline terms and achieved fraction for one counted step.

    ``cost`` is the `op_cost.OpCost` of one run of the step; ``measured_s``
    the measured time of one run on the card.  Returns the `roofline_terms`
    dict extended with the counts and ``roofline_frac = bound_s /
    measured_s`` (1.0 at the hardware roofline; tiny values when latency
    or overhead bound).
    """
    terms = roofline.roofline_terms(
        cost.flops, cost.bytes, cost.collective_total,
        hw=hw if hw is not None else roofline.HW,
    )
    terms["flops"] = cost.flops
    terms["bytes"] = cost.bytes
    terms["collective_bytes"] = cost.collective_total
    terms["measured_s"] = measured_s
    terms["roofline_frac"] = roofline.roofline_fraction(terms["bound_s"], measured_s)
    return terms


def parse_overrides(pairs: list[str]) -> dict:
    """``key=value`` config overrides: ints, then floats, then
    ``true``/``false``, else the string."""
    overrides = {}
    for kv in pairs:
        k, v = kv.split("=", 1)
        try:
            v = int(v)
        except ValueError:
            try:
                v = float(v)
            except ValueError:
                v = {"true": True, "false": False}.get(v.lower(), v)
        overrides[k] = v
    return overrides


def parse_rules_overrides(pairs: list[str]) -> dict:
    """``axis=mesh_axis`` sharding-rule overrides (``none`` replicates);
    ``param_tp=...`` as given."""
    rules_overrides = {}
    for kv in pairs:
        k, v = kv.split("=", 1)
        if k == "param_tp":
            rules_overrides[k] = v
        else:
            rules_overrides[k] = ((),) if v == "none" else ((v,), ())
    return rules_overrides


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--override", action="append", default=[],
                    help="cfg field override key=value (repeatable)")
    ap.add_argument("--microbatches", type=int, default=0)
    ap.add_argument("--zero1", action="store_true")
    ap.add_argument("--mixed-precision", action="store_true")
    ap.add_argument(
        "--rules-override", action="append", default=[],
        help="sharding-rule override, e.g. seq=none or seq=model",
    )
    ap.add_argument("--baseline-dir", default="results/dryrun_torch")
    ap.add_argument("--out", default="results/perf_torch")
    ap.add_argument("--tag", default="iter")
    args = ap.parse_args(argv)

    overrides = parse_overrides(args.override)
    rules_overrides = parse_rules_overrides(args.rules_override)

    from repro_torch.launch.dryrun import run_cell

    mesh = "multi" if args.multi_pod else "single"
    res = run_cell(
        args.arch,
        args.shape,
        mesh,
        zero1=args.zero1,
        num_microbatches=args.microbatches,
        cfg_overrides=overrides or None,
        mixed_precision=args.mixed_precision,
        rules_overrides=rules_overrides or None,
    )
    base_path = Path(args.baseline_dir) / f"{args.arch}__{args.shape}__{mesh}.json"
    base = json.loads(base_path.read_text()) if base_path.exists() else None

    def fmt(d):
        r = d["roofline"]
        return (
            f"c={r['compute_s']:.4f} m={r['memory_s']:.4f} "
            f"n={r['collective_s']:.4f} bound={r['bound_s']:.4f} "
            f"({r['dominant']}) peak={d['memory']['peak_estimate_bytes'] / 2**30:.2f}GiB "
            f"coll={d['collectives']['total'] / 1e9:.3f}GB [{d.get('partition', '?')}]"
        )

    if base:
        if base.get("partition") != res["partition"]:
            print(f"note: the baseline was partitioned {base.get('partition')!r}, "
                  f"this run {res['partition']!r}")
        print(f"baseline: {fmt(base)}")
    print(f"{args.tag:>8s}: {fmt(res)}")
    if base:
        b, a = base["roofline"]["bound_s"], res["roofline"]["bound_s"]
        print(f"bound delta: {b:.4f} -> {a:.4f}  ({(1 - a / b) * 100:+.1f}%)")
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    tagp = out / f"{args.arch}__{args.shape}__{mesh}__{args.tag}.json"
    res["overrides"] = overrides
    res["rules_overrides"] = {k: str(v) for k, v in rules_overrides.items()}
    res["mixed_precision"] = args.mixed_precision
    tagp.write_text(json.dumps(res, indent=1))
    print(f"saved {tagp}")


if __name__ == "__main__":
    main()
