#!/usr/bin/env python3
"""Serving and training `gemma3-1b` at full width: two checkouts of the
repo side by side on one NVIDIA GPU.

    python3 scripts/compare_trees.py BEFORE AFTER [--out DIR]

Runs each checkout in a fresh process, in the order BEFORE, AFTER, AFTER,
BEFORE, so that a drift of the host's clock over the call shows as a gap
between the two runs of one checkout.  Each run builds that checkout's
kernels, times the host's cost of issuing one `flash_attention` call at
gemma3-1b's decode shape (4 slots, 4 query heads on 1 kv head, 617 keys,
offset 600, bf16; with and without the 512 window), then runs the
checkout's own `chip_smoke.py` phase 6 (serving gemma3-1b) and phase 8
(training it with compressed gradients), all their checks included.
Each run's log lands in DIR/<n>_<BEFORE|AFTER>.log (default
``results/compare_trees``); the lines that carry the end-to-end numbers are
printed run by run.  Exits non-zero if any run fails.
"""

from __future__ import annotations

import argparse
import importlib.util
import statistics
import subprocess
import sys
import time
from pathlib import Path

# Lines of a run's log that carry the numbers compared.
KEYS = ("issue", "tokens/s", "prefill s per wave", "profiled decode tick:",
        "train step", "profiled train step:")


def issue_cost(torch, fa) -> None:
    """Host microseconds to issue one decode-shaped call (the device runs
    behind: 200 calls queue at most 400 kernels, under the launch queue's
    depth), median of 7 batches; where the wrapper plans its route and
    allocates scratch, those two alone as well."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn(4, 4, 1, 256, generator=gen, device="cuda").bfloat16()
    k = torch.randn(4, 1, 617, 256, generator=gen, device="cuda").bfloat16()
    v = torch.randn(4, 1, 617, 256, generator=gen, device="cuda").bfloat16()
    calls = 200

    def per_call_us(fn) -> float:
        times = []
        for _ in range(7):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            times.append((time.perf_counter() - t0) / calls * 1e6)
            torch.cuda.synchronize()
        return statistics.median(times)

    with torch.inference_mode():
        for window in (None, 512):
            us = per_call_us(lambda: fa.flash_attention(q, k, v, True, window, 600))
            print(f"issue: flash_attention decode (4, 4, 1, 1, 617, 256), window "
                  f"{window}: {us:.2f} us of host time per call", flush=True)
        if hasattr(fa, "plan"):
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            p = fa.plan(q.dtype, 4, 4, 1, 1, 617, True, None, 600, sms)
            us = per_call_us(lambda: fa.plan(q.dtype, 4, 4, 1, 1, 617, True, None, 600, sms))
            print(f"issue: of which plan() {us:.2f} us ({p.route}, {p.n_split} runs)",
                  flush=True)
            n = 4 * 4 * p.n_split * (256 + 2)
            us = per_call_us(lambda: torch.empty(n, dtype=torch.float32, device="cuda"))
            print(f"issue: of which the scratch's torch.empty {us:.2f} us", flush=True)


def run_tree(tree: Path) -> int:
    """One run: that checkout's kernels, the issue cost, phases 6 and 8."""
    import torch

    if not torch.cuda.is_available():
        print("compare_trees: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(tree / "src"))
    spec = importlib.util.spec_from_file_location("tree_smoke", tree / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from repro_torch.kernels import common
    from repro_torch.kernels import flash_attention as fa

    t0 = time.perf_counter()
    common.library()
    print(f"tree {tree}: kernel build and load {time.perf_counter() - t0:.2f} s", flush=True)
    # As `chip_smoke.main` sets them before its phases.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    issue_cost(torch, fa)
    smoke.phase_serving(torch)
    smoke.phase_training(torch)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("before", type=Path)
    ap.add_argument("after", type=Path)
    ap.add_argument("--out", type=Path, default=Path("results/compare_trees"))
    ap.add_argument("--run", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.run:  # child: `before` is the one checkout to run
        return run_tree(args.before.resolve())
    args.out.mkdir(parents=True, exist_ok=True)
    rc = 0
    order = [("BEFORE", args.before), ("AFTER", args.after),
             ("AFTER", args.after), ("BEFORE", args.before)]
    for n, (name, tree) in enumerate(order):
        log = args.out / f"{n}_{name}.log"
        t0 = time.perf_counter()
        with log.open("w") as f:
            proc = subprocess.run(
                [sys.executable, __file__, str(tree.resolve()), str(tree.resolve()), "--run"],
                stdout=f, stderr=subprocess.STDOUT, timeout=900)
        print(f"== run {n}: {name} ({tree}), rc {proc.returncode}, "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        for line in log.read_text().splitlines():
            if any(key in line for key in KEYS):
                print("   " + line[:400], flush=True)
        if proc.returncode:
            print("   " + "\n   ".join(log.read_text().splitlines()[-15:]), flush=True)
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
