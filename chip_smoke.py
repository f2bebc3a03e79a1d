#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` and runs:

1. the card's name and power limit, and the kernels' build time;
2. every kernel against its plain PyTorch twin on the card, at the main
   path's shapes, with its time (CUDA events, median of 30 runs after
   warm-up), the twin's, one library call's where one computes the same
   function, and the least time the card could take (`bound_ms`);
3. the main path end to end on the paper's default setting (Sec. V-A:
   N=10, M=100, K=3, rates 10/20/30, delta=8, zero releases), 32 seeds:
   `solve_ensemble_lp` (3000 iterations), then
   ``get_pipeline("ours").run_batch(..., validate=True)`` under the greedy
   and the reserving discipline; every schedule validates, every weighted
   CCT is within (8K+1) times its LP objective, and each kernel's launch
   count moved as expected; then a stage-by-stage timing pass;
4. the same LP solutions through `run_batch` on the GPU and on the CPU:
   orders, core choices, establish and complete times and CCTs must be
   bit-identical; phases 3 and 4 again on 8 trace-release instances;
5. the ``kernels`` JSON line, then ``{"ok": true, "device": ...}`` last.

Any failed check raises, so the script exits non-zero and prints no
result.  It exits non-zero as well without a CUDA device.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SEEDS = range(32)
TRACE_SEEDS = range(8)
LP_ITERS = 3000

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, and the
# non-tensor-core f32 and f64 rates.  32-bit integer compares are counted
# against the f32 rate.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
F64_OPS_PER_S = 34e12


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def time_ms(torch, fn, runs: int = 30, warmup: int = 5) -> float:
    """Median wall time of ``fn()`` on the card, from CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(nbytes: float, ops: float, peak: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def profile_device(torch, fn):
    """Run ``fn()`` under `torch.profiler`; return the wall seconds and,
    per device kernel name, (total device microseconds, launches)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = {
        e.key: (e.self_device_time_total, e.count)
        for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA
    }
    return wall, kernels


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain twins
# ---------------------------------------------------------------------------


def random_claims(torch, G, N, gen, dev):
    """Unique head ids per member, ~40% replaced by the no-claim sentinel."""
    ids = torch.stack([torch.randperm(N * N, generator=gen) for _ in range(G)])
    sentinel = torch.rand((G, N * N), generator=gen) < 0.4
    claim = torch.where(sentinel, N * N, ids).to(torch.int32).view(G, N, N)
    idle = (torch.rand((G, N, N), generator=gen) < 0.6)
    return claim.to(dev).contiguous(), idle.to(dev).contiguous()


def phase_kernels(torch, paper_demands, ens_lp_arrays, mixed_lp_arrays):
    from repro_torch.core.lp import _precedence_X
    from repro_torch.kernels import lp_terms as lt
    from repro_torch.kernels import pair_resolve as pr
    from repro_torch.kernels import port_stats as ps

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    rows = []

    # pair_resolve: exact.
    for G, N in ((96, 12), (8, 48)):
        claim, idle = random_claims(torch, G, N, gen, dev)
        got = pr.pair_resolve(claim, idle)
        torch.cuda.synchronize()
        want = pr.pair_resolve_plain(claim, idle)
        check(torch.equal(got, want), f"pair_resolve ({G},{N},{N}) != plain")
        log(f"pair_resolve ({G},{N},{N}): exact match, {int(want.sum())} starts")
    claim, idle = random_claims(torch, 96, 12, gen, dev)
    G, N = 96, 12
    nbytes = G * N * N * (4 + 1 + 1)
    ops = G * N * N * 5  # row and column min, two compares, one and
    b_ms, b_by = bound_ms(nbytes, ops, F32_OPS_PER_S)
    rows.append(dict(
        name="pair_resolve", route="cuda",
        source="src/repro_torch/csrc/pair_resolve.cu",
        replaces="src/repro/kernels/event_resolve/kernel.py:149",
        max_abs_err=0.0,
        ms=time_ms(torch, lambda: pr.pair_resolve(claim, idle)),
        plain_ms=time_ms(torch, lambda: pr.pair_resolve_plain(claim, idle)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
    ))

    # port_stats: f64 sums in NumPy's order, so exact (0 ulp); tau exact.
    # The paper ensemble's stacked demands are the main path's input.
    main_d = torch.from_numpy(paper_demands).to(dev)
    g = torch.Generator().manual_seed(48)
    d48 = torch.rand((192, 48, 48), generator=g, dtype=torch.float64) * 100.0
    d48 = torch.where(torch.rand((192, 48, 48), generator=g) < 0.5, d48, 0.0)
    for d in (main_d, d48.to(dev)):
        M, N = d.shape[:2]
        rho, tau = ps.port_stats(d)
        torch.cuda.synchronize()
        rho_p, tau_p = ps.port_stats_plain(d)
        check(torch.equal(tau, tau_p), f"port_stats tau ({M},{N},{N}) != plain")
        check(torch.equal(rho, rho_p), f"port_stats rho ({M},{N},{N}) != plain")
        # The same sums on the host, in NumPy's own order.
        dh = d.cpu().numpy()
        rho_np = np.concatenate([dh.sum(axis=2), dh.sum(axis=1)], axis=-1)
        check(np.array_equal(rho.cpu().numpy(), rho_np), "port_stats rho != NumPy")
        log(f"port_stats ({M},{N},{N}): rho and tau exact (plain and NumPy)")
    M, N = main_d.shape[:2]
    nbytes = M * N * N * 8 + M * 2 * N * (8 + 4)
    ops = M * N * N * 4  # row add, column add, two compares
    b_ms, b_by = bound_ms(nbytes, ops, F64_OPS_PER_S)
    rows.append(dict(
        name="port_stats", route="cuda",
        source="src/repro_torch/csrc/port_stats.cu",
        replaces="src/repro/kernels/port_stats/kernel.py:37",
        max_abs_err=0.0,
        ms=time_ms(torch, lambda: ps.port_stats(main_d)),
        plain_ms=time_ms(torch, lambda: ps.port_stats_plain(main_d)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(torch, lambda: (
            main_d.sum(dim=2), main_d.sum(dim=1),
            (main_d > 0).sum(dim=2), (main_d > 0).sum(dim=1),
        )),
    ))

    # lp_terms_batch: f32 sums in different orders, stated tolerance.
    err = 0.0
    main_args = None
    for label, arrays in (("paper bucket", ens_lp_arrays), ("mixed-N bucket", mixed_lp_arrays)):
        g = torch.Generator().manual_seed(7)
        Y = arrays["Y0"] + 0.3 * torch.rand(arrays["Y0"].shape, generator=g).to(dev)
        X = _precedence_X(torch.clamp(Y, 0.0, 1.0), arrays["coflow_mask"]).contiguous()
        args = (X, arrays["p_rho"], arrays["p_tau"], arrays["inv_R"], arrays["delta_over_K"])
        got = lt.lp_terms_batch(*args)
        torch.cuda.synchronize()
        want = lt.lp_terms_batch_plain(*args)
        M = X.shape[1]
        label_err = 0.0
        for a, b in zip(got, want):
            check(bool((a - b).abs().le(lt.rtol(M) * b.abs()).all()),
                  f"lp_terms_batch {label} outside rtol {lt.rtol(M)}")
            label_err = max(label_err, float((a - b).abs().max()))
        err = max(err, label_err)
        log(f"lp_terms_batch {label} {tuple(X.shape)} P={args[1].shape[2]}: "
            f"within rtol {lt.rtol(M):.3g}, max abs err {label_err:.3g}")
        if main_args is None:
            main_args = args
    X, p_rho, p_tau, inv_R, dok = main_args
    B, M, _ = X.shape
    P = p_rho.shape[2]
    nbytes = 4 * (B * M * M + 2 * B * M * P + 2 * B) + 4 * 2 * B * M
    ops = 2 * (2 * B * M * M * P)
    b_ms, b_by = bound_ms(nbytes, ops, F32_OPS_PER_S)

    def library():
        Xt = X.transpose(1, 2)
        return (
            torch.bmm(Xt, p_rho).amax(dim=2) * inv_R[:, None],
            torch.bmm(Xt, p_tau).amax(dim=2) * dok[:, None],
        )

    rows.append(dict(
        name="lp_terms_batch", route="cuda",
        source="src/repro_torch/csrc/lp_terms.cu",
        replaces="src/repro/kernels/lp_terms/kernel.py:101",
        max_abs_err=err,
        ms=time_ms(torch, lambda: lt.lp_terms_batch(*main_args)),
        plain_ms=time_ms(torch, lambda: lt.lp_terms_batch_plain(*main_args)),
        bound_ms=b_ms, bound_by=b_by, library_ms=time_ms(torch, library),
    ))
    launches = dict(
        pair_resolve=lambda: pr.pair_resolve(claim, idle),
        port_stats=lambda: ps.port_stats(main_d),
        lp_terms_batch=lambda: lt.lp_terms_batch(*main_args),
    )
    for r in rows:
        log(f"kernel {r['name']}: kernel_ms {r['ms']:.4f} plain_ms "
            f"{r['plain_ms']:.4f} library_ms {r['library_ms']} bound_ms "
            f"{r['bound_ms']:.6f} ({r['bound_by']})")
        _, kernels = profile_device(
            torch, lambda: [launches[r["name"]]() for _ in range(30)]
        )
        mine = [v for k, v in kernels.items() if f"{r['name']}_kernel" in k]
        if mine:
            total_us, count = mine[0]
            log(f"kernel {r['name']}: device-only {total_us / count:.2f} us "
                f"per launch (profiler, {count} launches)")
        else:
            log(f"kernel {r['name']}: device-only time not measured "
                f"(the profiler saw no device activity)")
    return rows


# ---------------------------------------------------------------------------
# Phases 3 and 4: the main path end to end, and GPU/CPU parity
# ---------------------------------------------------------------------------


def counters():
    from repro_torch.kernels import lp_terms, pair_resolve, port_stats

    return dict(
        port_stats=port_stats, lp_terms_batch=lp_terms, pair_resolve=pair_resolve
    )


def reset_counts():
    for mod in counters().values():
        mod.LAUNCHES = 0


def read_counts():
    return {name: mod.LAUNCHES for name, mod in counters().items()}


def phase_end_to_end(torch, label, instances):
    """Main path through the user entry points, with launch counts."""
    from repro_torch.experiments import build_buckets, solve_ensemble_lp
    from repro_torch.pipeline import batch_circuit, get_pipeline

    reset_counts()
    batch_circuit.ROUNDS = 0
    t0 = time.perf_counter()
    sols = solve_ensemble_lp(instances, iters=LP_ITERS)
    results = {}
    for d in ("greedy", "reserving"):
        results[d] = get_pipeline("ours", discipline=d).run_batch(
            instances, lp_solutions=sols, validate=True
        )
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    rounds = batch_circuit.ROUNDS

    for d, res in results.items():
        for b, (inst, sol, r) in enumerate(zip(instances, sols, res)):
            limit = (8 * inst.num_cores + 1) * sol.objective
            check(r.total_weighted_cct <= limit,
                  f"{label} {d} instance {b}: weighted CCT {r.total_weighted_cct} "
                  f"> (8K+1) x LP {limit}")
            check(np.isfinite(r.ccts).all() and r.ccts.shape == (inst.num_coflows,),
                  f"{label} {d} instance {b}: bad CCT vector")
    ratios = [
        r.total_weighted_cct / s.objective for r, s in zip(results["greedy"], sols)
    ]
    buckets = build_buckets(instances)
    n_buckets = len(buckets)
    expect_lp = n_buckets * (LP_ITERS + 2)
    # One launch per distinct port count: per LP bucket, and per
    # run_batch ensemble build (two disciplines).
    expect_ps = sum(
        len({instances[i].num_ports for i in bk.indices}) for bk in buckets
    ) + 2 * len({inst.num_ports for inst in instances})
    check(counts["lp_terms_batch"] == expect_lp,
          f"{label}: lp_terms_batch launched {counts['lp_terms_batch']} times, "
          f"expected {expect_lp}")
    check(counts["port_stats"] == expect_ps,
          f"{label}: port_stats launched {counts['port_stats']} times, "
          f"expected {expect_ps}")
    check(counts["pair_resolve"] == rounds > 0,
          f"{label}: pair_resolve launched {counts['pair_resolve']} times, "
          f"expected {rounds} (one per calendar round)")
    log(f"{label}: {len(instances)} instances validated under both "
        f"disciplines; weighted CCT / LP objective (greedy) min "
        f"{min(ratios):.4f} max {max(ratios):.4f}; bound 8K+1 = "
        f"{8 * instances[0].num_cores + 1}; wall {wall:.2f} s")
    log(f"{label}: launches {json.dumps(counts)} (lp_terms_batch expected "
        f"{expect_lp} = {n_buckets} bucket(s) x ({LP_ITERS} steps + start + "
        f"result); port_stats expected {expect_ps}; pair_resolve expected "
        f"{rounds} = calendar rounds of both disciplines)")
    return sols, counts


def stage_times(torch, label, instances):
    """Stage-by-stage wall times of the main path (greedy discipline)."""
    from repro_torch.core import lp
    from repro_torch.pipeline import build_ensemble_batch, get_pipeline

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    arrays, t_pack = timed(lambda: lp.pack_lp_arrays(instances))
    sols, t_lp = timed(lambda: lp.solve_subgradient_batch_arrays(
        arrays, iters=LP_ITERS).unpack([i.num_coflows for i in instances]))
    pipe = get_pipeline("ours", discipline="greedy")
    ens, t_build = timed(lambda: build_ensemble_batch(instances))
    comp = np.zeros(tuple(ens.weights.shape))
    for b, s in enumerate(sols):
        comp[b, : s.completion.shape[0]] = s.completion
    orders, t_order = timed(lambda: pipe.order_stage.order_batch(
        ens, torch.from_numpy(comp).cuda()))
    alloc, t_alloc = timed(lambda: pipe.allocate_stage.allocate_batch_arrays(ens, orders))
    _, t_cal = timed(lambda: pipe.circuit_stage.schedule_batch_arrays(ens, alloc))
    times = dict(pack=t_pack, lp=t_lp, build=t_build, order=t_order,
                 allocation=t_alloc, calendar=t_cal)
    log(f"{label} stage seconds: " + json.dumps({k: round(v, 4) for k, v in times.items()}))

    # A traced pass: device busy share per stage (the LP at 100 steps).
    traced = dict(
        lp_100_steps=lambda: lp.solve_subgradient_batch_arrays(arrays, iters=100),
        allocation=lambda: pipe.allocate_stage.allocate_batch_arrays(ens, orders),
        calendar=lambda: pipe.circuit_stage.schedule_batch_arrays(ens, alloc),
    )
    for name, fn in traced.items():
        wall, kernels = profile_device(torch, fn)
        if not kernels:
            log(f"{label} traced {name}: device busy share not measured "
                f"(the profiler saw no device activity)")
            continue
        busy_us = sum(t for t, _ in kernels.values())
        top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:3]
        log(f"{label} traced {name}: wall {wall:.4f} s, device busy "
            f"{busy_us / 1e6:.4f} s ({100 * busy_us / 1e6 / wall:.1f} %), "
            f"{sum(c for _, c in kernels.values())} device kernels; top: "
            + "; ".join(f"{k[:60]} {t / 1e3:.2f} ms x{c}" for k, (t, c) in top))
    return times


def phase_parity(label, instances, sols):
    """Injected LP: GPU and CPU runs must agree bit for bit."""
    from repro_torch.pipeline import get_pipeline

    for d in ("greedy", "reserving"):
        pipe = get_pipeline("ours", discipline=d)
        gpu = pipe.run_batch(instances, sols, validate=True, device="cuda")
        cpu = pipe.run_batch(instances, sols, validate=True, device="cpu")
        for b, (g, c) in enumerate(zip(gpu, cpu)):
            ctx = f"{label} {d} instance {b}"
            check(np.array_equal(g.order, c.order), f"{ctx}: orders differ")
            check(np.array_equal(g.allocation.core, c.allocation.core),
                  f"{ctx}: core choices differ")
            check(np.array_equal(g.allocation.prefix_lb, c.allocation.prefix_lb),
                  f"{ctx}: prefix bounds differ")
            for k, (sg, sc) in enumerate(zip(g.core_schedules, c.core_schedules)):
                check(np.array_equal(sg.establish, sc.establish),
                      f"{ctx} core {k}: establish times differ")
                check(np.array_equal(sg.complete, sc.complete),
                      f"{ctx} core {k}: complete times differ")
            check(np.array_equal(g.ccts, c.ccts), f"{ctx}: CCTs differ")
    log(f"{label}: GPU and CPU runs with injected LP bit-identical "
        f"(orders, cores, establish/complete, CCTs; both disciplines)")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.lp import pack_lp_arrays
    from repro_torch.kernels import common
    from repro_torch.traffic.instances import paper_default_instance, sample_instance

    # Phase 1: the card and the build.
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    common.library()
    log(f"kernel build and load {time.perf_counter() - t0:.2f} s")
    for line in common.library_path().with_suffix(".log").read_text().splitlines():
        if "registers" in line or "Compiling entry" in line:
            log(f"ptxas: {line.strip()}")

    paper = [paper_default_instance(seed=s) for s in SEEDS]
    trace = [sample_instance(seed=s, release="trace") for s in TRACE_SEEDS]
    mixed = [sample_instance(num_ports=n, num_coflows=40, seed=n) for n in (4, 6, 8, 10)]

    # Phase 2: kernels against their plain twins.
    from repro_torch.experiments.ensemble import bucket_shape
    Mp, Pp = bucket_shape(paper[0])
    rows = phase_kernels(
        torch,
        np.concatenate([inst.demands for inst in paper]),
        pack_lp_arrays(paper, pad_coflows=Mp, pad_ports=Pp),
        pack_lp_arrays(mixed, pad_coflows=40, pad_ports=24),
    )

    # Phases 3 and 4: the main path, then GPU/CPU parity, on both ensembles.
    sols, counts = phase_end_to_end(torch, "paper default", paper)
    stage_times(torch, "paper default", paper)
    phase_parity("paper default", paper, sols)
    trace_sols, _ = phase_end_to_end(torch, "trace releases", trace)
    phase_parity("trace releases", trace, trace_sols)

    # Phase 5: the kernels line, then the result.
    for r in rows:
        r["launches"] = counts[r["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
