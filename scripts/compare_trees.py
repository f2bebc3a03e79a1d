#!/usr/bin/env python3
"""Serving gemma3-1b and xlstm-1.3b and training gemma3-1b at full width:
two checkouts of the repo side by side on one NVIDIA GPU.

    python3 scripts/compare_trees.py BEFORE AFTER [--phases 6,7,8] [--out DIR]

Runs each checkout in a fresh process, in the order BEFORE, AFTER, AFTER,
BEFORE, so that a drift of the host's clock over the call shows as a gap
between the two runs of one checkout.  Each run builds that checkout's
kernels, times the host's cost of issuing one `flash_attention` call at
gemma3-1b's decode shape (4 slots, 4 query heads on 1 kv head, 617 keys,
offset 600, bf16; with and without the 512 window) and one `mlstm_chunk`
call at xlstm-1.3b's (4 slots x 4 heads, one position, Dh 512, bf16, a
carried state), then runs the checkout's own `chip_smoke.py` phases among
6 (serving gemma3-1b), 7 (serving xlstm-1.3b) and 8 (training gemma3-1b
with compressed gradients), all their checks included; ``--phases``
picks them (default: all three).  Each run's log lands in
DIR/<n>_<BEFORE|AFTER>.log (default ``results/compare_trees``); the lines
that carry the end-to-end numbers are printed run by run.  Exits non-zero
if any run fails.
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
KEYS = ("issue", "tokens/s", "prefill s per wave", "prefill wave (", "profiled decode tick:",
        "train step", "profiled train step:")
PHASES = {"6": "phase_serving", "7": "phase_serving_xlstm", "8": "phase_training"}


def per_call_us(torch, fn, calls: int = 200) -> float:
    """Host microseconds per call of ``fn`` (the device runs behind: 200
    calls queue at most 400 kernels, under the launch queue's depth),
    median of 7 batches."""
    times = []
    for _ in range(7):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return statistics.median(times)


def issue_cost(torch, fa, mc) -> None:
    """Host cost of issuing one decode-shaped call of each serving kernel;
    where a wrapper plans its route and allocates scratch, those alone as
    well."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn(4, 4, 1, 256, generator=gen, device="cuda").bfloat16()
    k = torch.randn(4, 1, 617, 256, generator=gen, device="cuda").bfloat16()
    v = torch.randn(4, 1, 617, 256, generator=gen, device="cuda").bfloat16()

    with torch.inference_mode():
        for window in (None, 512):
            us = per_call_us(torch, lambda: fa.flash_attention(q, k, v, True, window, 600))
            print(f"issue: flash_attention decode (4, 4, 1, 1, 617, 256), window "
                  f"{window}: {us:.2f} us of host time per call", flush=True)
        if hasattr(fa, "plan"):
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            p = fa.plan(q.dtype, 4, 4, 1, 1, 617, True, None, 600, sms)
            us = per_call_us(torch, lambda: fa.plan(q.dtype, 4, 4, 1, 1, 617, True, None, 600, sms))
            print(f"issue: of which plan() {us:.2f} us ({p.route}, {p.n_split} runs)",
                  flush=True)
            n = 4 * 4 * p.n_split * (256 + 2)
            us = per_call_us(torch, lambda: torch.empty(n, dtype=torch.float32, device="cuda"))
            print(f"issue: of which the scratch's torch.empty {us:.2f} us", flush=True)

        # xlstm-1.3b's decode: 4 slots x 4 heads, one position, a carried state.
        qkv = [torch.randn(16, 1, 512, generator=gen, device="cuda").bfloat16() for _ in range(3)]
        gates = [torch.randn(16, 1, generator=gen, device="cuda") for _ in range(2)]
        state = (torch.randn(16, 512, 512, generator=gen, device="cuda"),
                 torch.randn(16, 512, generator=gen, device="cuda"))
        us = per_call_us(torch, lambda: mc.mlstm_chunk(*qkv, *gates, state=state))
        print(f"issue: mlstm_chunk decode (16, 1, 512), carried state: {us:.2f} us of "
              f"host time per call", flush=True)
        if hasattr(mc, "plan"):
            us = per_call_us(torch, lambda: mc.plan(torch.bfloat16, 16, 1, 512, 1))
            print(f"issue: of which plan() {us:.2f} us ({mc.plan(torch.bfloat16, 16, 1, 512, 1)})",
                  flush=True)


def run_tree(tree: Path, phases: list[str]) -> int:
    """One run: that checkout's kernels, the issue costs, its phases."""
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
    from repro_torch.kernels import mlstm_chunk as mc

    t0 = time.perf_counter()
    common.library()
    print(f"tree {tree}: kernel build and load {time.perf_counter() - t0:.2f} s", flush=True)
    # As `chip_smoke.main` sets them before its phases.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    issue_cost(torch, fa, mc)
    for phase in phases:
        getattr(smoke, PHASES[phase])(torch)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("before", type=Path)
    ap.add_argument("after", type=Path)
    ap.add_argument("--phases", default="6,7,8",
                    help="chip_smoke.py phases to run, among 6, 7 and 8 (default: all)")
    ap.add_argument("--out", type=Path, default=Path("results/compare_trees"))
    ap.add_argument("--run", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    phases = args.phases.split(",")
    if not set(phases) <= set(PHASES):
        ap.error(f"--phases takes a comma-separated list among {sorted(PHASES)}")
    if args.run:  # child: `before` is the one checkout to run
        return run_tree(args.before.resolve(), phases)
    args.out.mkdir(parents=True, exist_ok=True)
    rc = 0
    order = [("BEFORE", args.before), ("AFTER", args.after),
             ("AFTER", args.after), ("BEFORE", args.before)]
    for n, (name, tree) in enumerate(order):
        log = args.out / f"{n}_{name}.log"
        t0 = time.perf_counter()
        with log.open("w") as f:
            proc = subprocess.run(
                [sys.executable, __file__, str(tree.resolve()), str(tree.resolve()),
                 "--phases", args.phases, "--run"],
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
