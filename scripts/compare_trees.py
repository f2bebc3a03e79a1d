#!/usr/bin/env python3
"""The `port_stats` kernel's device and host cost, the calendar round
kernels' host cost, the LP stage of the paper-default ensemble, serving
gemma3-1b and xlstm-1.3b and training gemma3-1b at full width: two
checkouts of the repo side by side on one NVIDIA GPU.

    python3 scripts/compare_trees.py BEFORE AFTER [--phases ps,2,3,6,7,8] [--out DIR]

Runs each checkout in a fresh process, in the order BEFORE, AFTER, AFTER,
BEFORE, so that a drift of the host's clock over the call shows as a gap
between the two runs of one checkout.  Each run builds that checkout's
kernels, then runs the phases picked among:

* ps, the `port_stats` kernel: the host's cost of issuing one call at the
  main path's shape (the paper-default ensemble's stacked (3200, 10, 10)
  demands; random here).  After the four runs a fifth process loads both
  checkouts' wrappers and times that call through each in turn, as for
  phase 3, then profiles each checkout's device microseconds per launch
  (30 launches a window, BEFORE, AFTER, AFTER, BEFORE) at the shapes both
  take: (3200, 10, 10), (192, 48, 48), (256, 150, 150) and (526, 150,
  150) (`pack_lp_arrays(wide)` and the whole `fb_full` trace);
* 2, the calendar rounds: the host's cost of issuing one `pair_resolve`
  call at the main path's shape (G = 96, N = 12) and one `event_resolve`
  call at its bucket's (G = 96, F = 336, N = 12; greedy).  After the four
  runs a fifth process loads both checkouts' wrappers and times the two
  calls through each in turn, as for phase 3;
* 3, the LP stage: the host's cost of issuing one `lp_terms` call at one
  paper instance's shape (M = 100, P = 20) and one `lp_terms_batch` call
  at the paper bucket's (B = 32, M = 104, P = 24), then the checkout's own
  `chip_smoke.stage_times` on the 32 paper-default instances (stage
  seconds, the LP at 3000 steps included, and traced passes: the LP's 100
  steps with their busy time and `lp_terms_batch` share).  After the four
  runs a fifth process loads both checkouts' `lp_terms` wrappers and times
  the same two calls through each in turn, BEFORE, AFTER, AFTER, BEFORE
  in every one of 50 rounds, so that the host's drift falls on both
  alike: the per-round difference AFTER - BEFORE is the wrappers' own;
* 6, 7 and 8, the checkout's own `chip_smoke.py` phases (serving
  gemma3-1b, serving xlstm-1.3b, training gemma3-1b with compressed
  gradients), all their checks included, after the host's cost of issuing
  one `flash_attention` call at gemma3-1b's decode shape (4 slots, 4
  query heads on 1 kv head, 617 keys, offset 600, bf16; with and without
  the 512 window) and one `mlstm_chunk` call at xlstm-1.3b's (4 slots x 4
  heads, one position, Dh 512, bf16, a carried state).

``--phases`` picks them (default: 6, 7 and 8; ps, 2 and 3 each add the
fifth, interleaved process).  Each run's log lands in
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
KEYS = ("issue", "device us", "stage seconds", "traced lp_100_steps", "tokens/s",
        "prefill s per wave", "prefill wave (", "profiled decode tick:", "train step",
        "profiled train step:")
# chip_smoke.py's phase functions; phase 3 is `phase_lp_stage` here.
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


def lp_issue_cost(torch) -> None:
    """Host cost of issuing one call of each LP-terms kernel at the main
    path's shapes (random operands on the card)."""
    from repro_torch.kernels import lp_terms as lt

    gen = torch.Generator(device="cuda").manual_seed(0)

    def rand(*shape):
        return torch.rand(*shape, generator=gen, device="cuda")

    x, rho, tau = rand(100, 100), rand(100, 20), rand(100, 20)
    us = per_call_us(torch, lambda: lt.lp_terms(x, rho, tau, 0.05, 2.5))
    print(f"issue: lp_terms (M=100, P=20): {us:.2f} us of host time per call", flush=True)
    args = (rand(32, 104, 104), rand(32, 104, 24), rand(32, 104, 24), rand(32), rand(32))
    us = per_call_us(torch, lambda: lt.lp_terms_batch(*args))
    print(f"issue: lp_terms_batch (B=32, M=104, P=24): {us:.2f} us of host time per call",
          flush=True)
    if hasattr(lt, "plan"):
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        us = per_call_us(torch, lambda: lt.plan(32, 104, 24, sms))
        print(f"issue: of which plan() {us:.2f} us", flush=True)


def resolve_operands(torch):
    """Random operands on the card at the main path's shapes: (96, 12, 12)
    claims and idle flags; a (96, 336) flow bucket on 12 ports."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    G, N, F = 96, 12, 336
    claim = torch.randint(0, N * N + 1, (G, N, N), generator=gen, device="cuda",
                          dtype=torch.int32)
    idle = torch.rand((G, N, N), generator=gen, device="cuda") < 0.6

    def f64(*shape):
        return 10.0 * torch.rand(shape, generator=gen, device="cuda", dtype=torch.float64)

    ports = [torch.randint(0, N, (G, F), generator=gen, device="cuda", dtype=torch.int32)
             for _ in range(2)]
    flows = (*ports, f64(G, F), f64(G, N), f64(G, N),
             torch.rand((G, F), generator=gen, device="cuda") < 0.7, f64(G))
    return (claim, idle), flows


def resolve_issue_cost(torch) -> None:
    """Host cost of issuing one call of each calendar round kernel at the
    main path's shapes."""
    from repro_torch.kernels import event_resolve as er
    from repro_torch.kernels import pair_resolve as pr

    pair, flows = resolve_operands(torch)
    us = per_call_us(torch, lambda: pr.pair_resolve(*pair))
    print(f"issue: pair_resolve (96, 12, 12): {us:.2f} us of host time per call", flush=True)
    us = per_call_us(torch, lambda: er.event_resolve(*flows, "greedy"))
    print(f"issue: event_resolve (96, 336, 12): {us:.2f} us of host time per call", flush=True)


def port_stats_demands(torch, M: int, N: int):
    """(M, N, N) f64 demands on the card from a seed, half of them zero."""
    gen = torch.Generator(device="cuda").manual_seed(M + N)
    d = 100.0 * torch.rand((M, N, N), generator=gen, device="cuda", dtype=torch.float64)
    return torch.where(torch.rand((M, N, N), generator=gen, device="cuda") < 0.5, d, 0.0)


def port_stats_issue_cost(torch) -> None:
    """Host cost of issuing one `port_stats` call at the main path's shape."""
    from repro_torch.kernels import port_stats as ps

    d = port_stats_demands(torch, 3200, 10)
    us = per_call_us(torch, lambda: ps.port_stats(d))
    print(f"issue: port_stats (3200, 10, 10): {us:.2f} us of host time per call", flush=True)


def load_kernels(tree: Path, names: tuple[str, ...]) -> list:
    """Checkout ``tree``'s `repro_torch.kernels.<name>` modules, its kernels
    built and loaded.  Its modules leave `sys.modules` once imported (they
    keep their own references), so the next call imports the next
    checkout's."""
    import importlib

    src = str(tree / "src")
    sys.path.insert(0, src)
    try:
        mods = [importlib.import_module(f"repro_torch.kernels.{n}") for n in names]
        importlib.import_module("repro_torch.kernels.common").library()
    finally:
        sys.path.remove(src)
        for name in [n for n in sys.modules if n.split(".")[0] == "repro_torch"]:
            del sys.modules[name]
    return mods


def lp_calls(torch, before: Path, after: Path) -> dict:
    """(tree, kind) -> one `lp_terms` (M = 100, P = 20) or `lp_terms_batch`
    (B = 32, M = 104, P = 24) call through that checkout's wrapper."""
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rand(*shape):
        return torch.rand(*shape, generator=gen, device="cuda")

    single = (rand(100, 100), rand(100, 20), rand(100, 20), 0.05, 2.5)
    batch = (rand(32, 104, 104), rand(32, 104, 24), rand(32, 104, 24), rand(32), rand(32))
    fns = {}
    for name, tree in (("BEFORE", before), ("AFTER", after)):
        (lt,) = load_kernels(tree, ("lp_terms",))
        fns[name, "lp_terms"] = lambda lt=lt: lt.lp_terms(*single)
        fns[name, "lp_terms_batch"] = lambda lt=lt: lt.lp_terms_batch(*batch)
    return fns


def resolve_calls(torch, before: Path, after: Path) -> dict:
    """(tree, kind) -> one `pair_resolve` or `event_resolve` call at the
    main path's shapes (`resolve_operands`) through that checkout's
    wrapper."""
    pair, flows = resolve_operands(torch)
    fns = {}
    for name, tree in (("BEFORE", before), ("AFTER", after)):
        pr, er = load_kernels(tree, ("pair_resolve", "event_resolve"))
        fns[name, "pair_resolve"] = lambda pr=pr: pr.pair_resolve(*pair)
        fns[name, "event_resolve"] = lambda er=er: er.event_resolve(*flows, "greedy")
    return fns


def port_stats_calls(torch, before: Path, after: Path) -> dict:
    """(tree, kind) -> one `port_stats` call at the main path's shape
    through that checkout's wrapper."""
    d = port_stats_demands(torch, 3200, 10)
    fns = {}
    for name, tree in (("BEFORE", before), ("AFTER", after)):
        (ps,) = load_kernels(tree, ("port_stats",))
        fns[name, "port_stats"] = lambda ps=ps: ps.port_stats(d)
    return fns


#: Shapes at which both checkouts' `port_stats` are profiled: the parent
#: takes at most 168 ports.
PORT_STATS_SHAPES = ((3200, 10), (192, 48), (256, 150), (526, 150))


def port_stats_device(torch, before: Path, after: Path) -> None:
    """Each checkout's `port_stats` device microseconds per launch at
    `PORT_STATS_SHAPES`, in the order BEFORE, AFTER, AFTER, BEFORE, and
    whether the two give the same bits."""
    from resolve_tiles import device_us

    mods = {name: load_kernels(tree, ("port_stats",))[0]
            for name, tree in (("BEFORE", before), ("AFTER", after))}
    for M, N in PORT_STATS_SHAPES:
        d = port_stats_demands(torch, M, N)
        same = all(torch.equal(a, b) for a, b in zip(mods["BEFORE"].port_stats(d),
                                                     mods["AFTER"].port_stats(d)))
        times = [(name, device_us(torch, lambda ps=mods[name]: ps.port_stats(d), "port_stats"))
                 for name in ("BEFORE", "AFTER", "AFTER", "BEFORE")]
        print(f"device us: port_stats ({M}, {N}, {N}): "
              + ", ".join(f"{name} {us:.2f}" for name, us in times)
              + f" (30 launches a window; bits {'equal' if same else 'DIFFER'})", flush=True)


#: The calls each phase times through both checkouts in turn.
INTERLEAVED = {"ps": port_stats_calls, "2": resolve_calls, "3": lp_calls}


def issue_interleaved(torch, before: Path, after: Path, phase: str, rounds: int = 50,
                      calls: int = 200) -> None:
    """Host microseconds per call of phase ``phase``'s calls through both
    checkouts' wrappers in this one process, timed in turn (module doc):
    each tree's median over its 2 ``rounds`` batches of ``calls`` calls,
    and the median and quartiles of the per-round difference AFTER -
    BEFORE."""
    fns = INTERLEAVED[phase](torch, before, after)
    kinds = list(dict.fromkeys(kind for _, kind in fns))
    with torch.inference_mode():
        for fn in fns.values():  # warm: first launches, plan caches
            fn()
        torch.cuda.synchronize()
        samples = {key: [] for key in fns}
        for _ in range(rounds):
            for name in ("BEFORE", "AFTER", "AFTER", "BEFORE"):
                for kind in kinds:
                    fn = fns[name, kind]
                    t0 = time.perf_counter()
                    for _ in range(calls):
                        fn()
                    samples[name, kind].append((time.perf_counter() - t0) / calls * 1e6)
                    torch.cuda.synchronize()
    for kind in kinds:
        b, a = samples["BEFORE", kind], samples["AFTER", kind]
        # Round r's two BEFORE and two AFTER batches.
        diff = [(a[2 * r] + a[2 * r + 1] - b[2 * r] - b[2 * r + 1]) / 2 for r in range(rounds)]
        q1, med, q3 = statistics.quantiles(diff, n=4)
        print(f"issue interleaved: {kind}: BEFORE {statistics.median(b):.2f} us, AFTER "
              f"{statistics.median(a):.2f} us of host time per call; AFTER - BEFORE per "
              f"round median {med:+.2f} us (quartiles {q1:+.2f}, {q3:+.2f}; {rounds} rounds "
              f"of {calls} calls)", flush=True)


def phase_lp_stage(torch, smoke) -> None:
    """Phase 3: the LP-terms issue costs, then the checkout's stage pass
    on the paper-default ensemble."""
    from repro_torch.traffic.instances import paper_default_instance

    lp_issue_cost(torch)
    smoke.stage_times(torch, "paper default",
                      [paper_default_instance(seed=s) for s in smoke.SEEDS])


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
    if set(phases) - set(INTERLEAVED):
        issue_cost(torch, fa, mc)
    for phase in phases:
        if phase == "ps":
            port_stats_issue_cost(torch)
        elif phase == "2":
            resolve_issue_cost(torch)
        elif phase == "3":
            phase_lp_stage(torch, smoke)
        else:
            getattr(smoke, PHASES[phase])(torch)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("before", type=Path)
    ap.add_argument("after", type=Path)
    ap.add_argument("--phases", default="6,7,8",
                    help="phases to run, among ps, 2, 3, 6, 7 and 8 (default: 6,7,8)")
    ap.add_argument("--out", type=Path, default=Path("results/compare_trees"))
    ap.add_argument("--run", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--interleave", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    phases = args.phases.split(",")
    if not set(phases) <= {*INTERLEAVED, *PHASES}:
        ap.error(f"--phases takes a comma-separated list among "
                 f"{sorted({*INTERLEAVED, *PHASES})}")
    if args.run:  # child: `before` is the one checkout to run
        return run_tree(args.before.resolve(), phases)
    if args.interleave:  # child: both checkouts' wrappers in turn
        import torch

        for phase in phases:
            if phase in INTERLEAVED:
                issue_interleaved(torch, args.before.resolve(), args.after.resolve(), phase)
            if phase == "ps":
                port_stats_device(torch, args.before.resolve(), args.after.resolve())
        return 0
    args.out.mkdir(parents=True, exist_ok=True)
    rc = 0
    runs = [("BEFORE", [args.before, args.before, "--run"]),
            ("AFTER", [args.after, args.after, "--run"]),
            ("AFTER", [args.after, args.after, "--run"]),
            ("BEFORE", [args.before, args.before, "--run"])]
    if set(phases) & set(INTERLEAVED):
        runs.append(("INTERLEAVED", [args.before, args.after, "--interleave"]))
    for n, (name, (first, second, mode)) in enumerate(runs):
        log = args.out / f"{n}_{name}.log"
        t0 = time.perf_counter()
        with log.open("w") as f:
            proc = subprocess.run(
                [sys.executable, __file__, str(first.resolve()), str(second.resolve()),
                 "--phases", args.phases, mode],
                stdout=f, stderr=subprocess.STDOUT, timeout=900)
        print(f"== run {n}: {name} ({first if first == second else f'{first}, {second}'}), "
              f"rc {proc.returncode}, {time.perf_counter() - t0:.1f} s", flush=True)
        for line in log.read_text().splitlines():
            if any(key in line for key in KEYS):
                print("   " + line[:400], flush=True)
        if proc.returncode:
            print("   " + "\n   ".join(log.read_text().splitlines()[-15:]), flush=True)
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
