#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` and runs:

1. the card's name and power limit, and the kernels' build time;
2. every kernel against its plain PyTorch twin on the card, at the main
   path's shapes and at the widths of the whole trace (`pair_resolve` at
   48 and 152 ports, both LP-terms kernels at 300 flat ports), with its time
   (CUDA events, median of 30 runs after warm-up), the twin's, one library
   call's where one computes the same function, the least time the card
   could take (`bound_ms`) and the profiler's device-only time, the
   library call's beside it (all its kernels); `port_stats` is held
   bit for bit against its twin and host NumPy under its plan and every
   tiling, and timed, at the stacked demands the port feeds it (the main
   path's (3200, 10, 10), `pack_lp_arrays(wide)`'s (256, 150, 150), the
   whole trace's (526, 150, 150)) and at (192, 48, 48) and (64, 240, 240),
   each shape logging its plan, and the stacked inputs' pageable
   host-to-device copy is logged beside the kernel; each LP-terms shape logs
   the tiles `lp_terms.plan` picked (grid, tiles, split p), and the
   ``kernels`` line carries the main path's as ``plan``.  The calendar
   round kernels log the route their `plan` picked at each shape (the
   ``kernels`` line carries the main path's) and are held under the plan
   and under every other tiling (`tilings`: each route of the kernel).
   `event_resolve` is held against its twin once phases 3 and 5 have given
   it real calendar states: mask for mask (start, first claimers, blocked)
   under both disciplines, on every round of a flow calendar run on the
   main path's bucket (G = 96, Nmax = 12), on 64 rounds at the fig5 width
   (N = 32) and 3 rounds of the whole trace's one member (F = 266,260,
   N = 152), and on a random state of each shape.  Then the calendars run
   on the whole trace's member at 152 ports: `pair_resolve` held mask for
   mask on 32 real pair-calendar rounds of each discipline (the pair
   calendar's int32 keys take the trace's first 91,368 flows), and a
   profiled window of 20 rounds of each engine's calendar logs the resolve
   kernel's share of the device time;
3. the main path end to end on the paper's default setting (Sec. V-A:
   N=10, M=100, K=3, rates 10/20/30, delta=8, zero releases), 32 seeds:
   `solve_ensemble_lp` (3000 iterations), then
   ``get_pipeline("ours").run_batch(..., validate=True)`` under the greedy
   and the reserving discipline; every schedule validates, every weighted
   CCT is within (8K+1) times its LP objective, and each kernel's launch
   count moved as expected; the same LP solutions again through
   ``get_pipeline("ours", discipline=d, circuit_engine="jax")`` (the
   flow-space calendar), counted apart: schedules bit-identical to the
   pair engine's and to the flow engine's on the CPU, `event_resolve`
   launched once per flow-calendar round and `pair_resolve` never, and
   under reserving as many rounds as the pair engine; then a
   stage-by-stage timing pass, the calendar under both engines, and
   traced passes (the LP's 100 steps with its `lp_terms_batch` share);
4. the same LP solutions through `run_batch` on the GPU and on the CPU:
   orders, core choices, establish and complete times and CCTs must be
   bit-identical; phases 3 and 4 again on 8 trace-release instances;
5. per-instance ``ours`` solving its own LP, through
   ``get_pipeline("ours", lp_method=...).run(inst)``: two paper-default
   instances (seed 0, and seed 1 with trace releases) with the
   subgradient LP (3000 iterations, the `lp_terms` kernel), and those two
   plus a fig5-width instance (N = 32) and an fb_quick cell (48 coflows,
   24 ports, K = 2, trace releases) with the exact LP (HiGHS); every
   schedule validates, every weighted CCT is within (8K+1) times the
   exact LP optimum, the subgradient objective lies within
   [1 - 1e-4, 1.005] times it, the reserving runs' certificates hold
   (`certify(...).ok()`) and the approximation ratio is within its bound
   under both disciplines, `lp_terms` launched exactly
   solves x (iterations + 2) times, and every run repeated on the CPU
   with the same LP solution is bit-identical; then
   ``get_pipeline("ours", circuit_engine="jax").run(inst, sol)`` on paper
   seed 0 and at fig5 N = 32, each bit-identical to the pair engine's run;
6. serving ``gemma3-1b`` at full width (26 layers, d_model 1152, vocab
   262144, head_dim 256, window 512; random weights from a seed) through
   `repro_torch.launch.serve.serve`: 8 requests of 600 prompt tokens, 4
   slots (2 waves), 16 new tokens each; every request gets its tokens,
   every logit is finite, the `flash_attention` kernels called exactly
   waves x (1 + max_new) x layers = 884 times (`LAUNCHES` counts one per
   call: a split-route call launches two CUDA kernels, the runs and their
   merge); one decode step after a
   prefill of P - 1 tokens matches the teacher-forced forward over P
   within 4 bf16 units of the largest logit; a reduced gemma3 in f32
   serves identical tokens on the card and on the host, logits within
   2e-4; one decode tick profiled.  The kernel phase (2) holds
   `flash_attention` against its twin at the serving shapes (prefill
   (4, 4, 600, 617, 256) and decode (4, 4, 1, 617, 256) at offset 600,
   with and without the window), at the training shape (4, 4, 1, 1024,
   1024, 256) and at cases of the reference's sweep, logging the route
   (``mma``, ``split`` or ``simt``) each took;
7. serving ``xlstm-1.3b`` at full width (48 layers: 42 mLSTM and 6 sLSTM,
   d_model 2048, 4 heads of 512, vocab 50304; random weights from a seed)
   through the same `serve`, 8 requests of 600 prompt tokens (two full
   chunks of 256 and a padded one), 4 slots, 16 new tokens each: every
   request gets its tokens, every logit is finite, the `mlstm_chunk`
   kernel launched exactly waves x (1 + max_new) x 42 = 1428 times and no
   other kernel; the sLSTM loop's share of a prefill wave and the largest
   |S| of the carried states; decode after a prefill of P - 1 tokens
   within 1e-3 of the largest logit of the teacher-forced forward on the
   served weights in f32, and within 4 bf16 units of it in bf16 on the
   served weights of the first 8 layers (the 48-layer bf16 gap is logged
   beside the spread of two valid forwards, chunks of 128 and 256); a
   reduced xLSTM in
   f32 (``mlstm_chunk`` 8, prompts of 36) serves identical tokens on the
   card and on the host, logits within 2e-4; one decode tick profiled,
   its `mlstm_chunk` device time by route.  The kernel phase (2) holds
   `mlstm_chunk` against its twin on each of its three routes (`plan`:
   `mma` for bf16 prefill, `stream` for C = 1, `simt` for the rest) at
   the serving shapes (prefill (16, 768, 512) with C = 256 and (16, 640,
   512) with C = 128, decode (16, 1, 512)), at the reference's cases
   (`tests/test_mlstm_kernel.py`) and at those with chunks of 1, each with
   a zero and a carried state in f32 and bf16, then times prefill and
   decode on each route with both bounds (tensor-core and f32-rate);
8. training ``gemma3-1b`` at full width through
   ``repro_torch.launch.train.main`` (``--full-config --compress-grads
   --batch 4 --seq 1024 --steps 3 --plan-collectives``: past the 512
   window, two loss chunks of 512; f32 masters; random weights from a
   seed): the collective plan over the parameter tree's 16 MB buckets
   covers every bucket, schedules every flow once, is no worse than FIFO
   and equals ``plan(..., device="cpu")`` (its calendar launches
   `pair_resolve` once per round, its build `port_stats` once); every loss finite,
   every one of the 236 parameter leaves gets a finite, nonzero gradient
   on the card (attention's backward included), the new error feedback
   within one quantization step of its row's scale (plus f32 rounding,
   ``EF_BOUND``), `quantize` launched steps x leaves = 708 times,
   `dequantize` twice that and `flash_attention` steps x 26 layers = 78;
   ms per step, tokens/s, the compressed exchange's share and peak
   memory; one more step profiled; a reduced f32 gemma3 trained 3
   compressed steps on the card and on the host with the same host-drawn
   noise: gradients within 1e-4 (step 0) and 1e-2 (later steps) of each
   leaf's largest value, losses within 1e-4.  The kernel phase (2) holds
   `quantize` and `dequantize` to their twins exactly at the reference's
   cases, the embedding's (589,824, 512) rows, a padded norm leaf and
   all-zero rows;
9. the paper's Sec. V-B schemes (``PAPER_SCHEMES``: ``ours``,
   ``wspt_order``, ``load_only``, ``sunflow_s``, ``bvn_s``) through
   ``get_pipeline(s).run_batch(..., validate=True)`` on the 32
   paper-default and the 8 trace-release instances with phase 3's LP
   solutions, each scheme counted alone: kept schedules validate, every
   weighted CCT is at least its LP objective / 1.005, the card's run is
   bit-identical to the host's (and ``ours`` to phase 3's), `pair_resolve`
   launches once per calendar round for the list circuits and neither
   calendar kernel for ``sunflow_s`` / ``bvn_s`` (host calendars); a
   fig3-style table (means over the ensemble of weighted CCT, p95 and p99
   over ours', and the stage seconds of each scheme's run on the card),
   with Fig. 3's claims
   gated on the means (``bvn_s`` > ours, ``sunflow_s`` > 1,
   ``load_only`` > 0.95, ``wspt_order`` < 1.3); then ``eps`` through
   `run_eps` on four paper-default instances with delta = 0 and the exact
   LP: within 4H (+1), card equal to host, and delta > 0 refused;
10. ``ours_ls`` (Algorithm 1 + batched candidate-search refinement, the
   `RefineSpec` defaults: 2 rounds of 8 candidates, 256 expanded members)
   through ``get_pipeline("ours_ls", circuit_engine=e).run_batch(...,
   require_batch=True)`` on the 32 paper-default instances with phase 3's
   LP solutions, ``e`` the pair and then the flow calendar, each counted
   alone: the search ran batched, kept schedules validate, every weighted
   CCT is at most ours' and (8K+1) x its LP objective, both engines give
   the same bits, the round kernel launched once per calendar round and
   `port_stats` once (the expansion is a gather); each round's
   evaluations, instances improved, mean refined / ours ratio and stage
   seconds, and one profiled round's device busy time; card equal to host
   on the 8 trace instances, and to `refine_sequential` through the host's
   per-instance stages on 4 paper instances.  Then the calendar's other
   executors against phase 3's bits: ``engine="wide"`` (host NumPy) on
   phase 3's allocation with no calendar kernel launched, ``"auto"``
   resolving to ``"kernel"`` on the card and, with
   ``REPRO_CIRCUIT_ENGINE=jax``, running the flow calendar, and ``ours``
   under ``circuit_backend="loop"``;
11. the streaming service through ``repro_torch.experiments.stream`` on
   the card.  First the kernels at the streams' own shapes against their
   twins: `lp_terms_batch` on a full pool's LP as the resident epoch
   gathers it ((1, 16, 48) and (1, 32, 96), within rtol(M), the plan
   logged) and `port_stats` on an `update_slots` stack ((16, 24, 24)
   and (32, 48, 48), bit for bit under the plan and every tiling).  Then
   (a) the reference's CI service cell (`benchmarks/
   trace_scale.py`, ``fb_quick``'s ``service``: 48 coflows, 24 ports,
   K = 2, trace releases, pool 16, 6 batches, 600 iterations), resident
   and warm, validated on every epoch, every coflow finished, within
   (8K+1) of the exact LP, one build, `port_stats` launched once per
   `update_slots` call plus the build, `lp_terms_batch` each epoch's
   steps + 2, `pair_resolve` once per calendar round; (b) the cell's
   first 24 coflows in release order in 3 batches (pool kept) with warm
   starts off (20 iterations): resident equal to rebuild, bit for bit;
   (c) the same prefix with the exact LP on the rebuild mode, preemption
   on and off, under the pair and the flow calendar: each stream equal to
   the host's, and committed circuits carried into a calendar without
   preemption; (d) one batch without preemption of
   ``paper_default_instance(0)`` with the exact LP equal to
   ``get_pipeline("ours").run_batch``; (e) the long-horizon cell
   (``fb_full``'s ``service``: 192 coflows, 48 ports, K = 4, pool 32,
   900 iterations, 300 warm), cut to its first 64 coflows in release
   order in 8 batches, logged: epochs, weighted CCT, the margin against
   the subgradient objective, warm re-solve p50 / p95 / p99, the
   warm-epoch wall, the mean host seconds a stage (`EpochRecord.stage_s`:
   slot writes, LP, order, allocation, calendar), and one profiled warm
   epoch's busy share and launches (left out of the walls);
12. the experiment fabric (`repro_torch.experiments.sweep`, `SweepCache`,
   the runner) on the card, results and caches in a temporary directory:
   (a) Fig. 3, a cached ``sweep`` of phase 3's 32 paper-default instances
   over ``PAPER_SCHEMES`` and ``ours_ls`` with the batch LP (3000
   iterations): cells valid, ``ours_ls`` <= ours, ours <= (8K+1) x the LP
   objective, Fig. 3's four claims on the means, launch counts; its LP
   solutions against phase 3's bit for bit (then every cell equals phase
   9's; else each scheme's `run_batch` on the sweep's own solutions); a
   replay computes no cell, launches no kernel and writes byte-identical
   rows; seed 99 in place of one instance computes exactly its 6 cells,
   valid and equal to each scheme's `run_batch` on the host, and its
   one-member LP bucket's `lp_terms_batch` and `port_stats` are held
   against their twins at that shape;
   (b) Fig. 6, ours with the exact LP and ``certify=True`` at K = 3 and 5,
   zero and trace releases: ratios within their bounds, reserving
   certificates hold, one ensemble build for both disciplines, cells equal
   `run_batch` on the host; (c) Fig. 5, the grid N = 8, 16, 32 x K = 3, 5
   (M = 100, delta = 8, imbalanced rates, 800 iterations) as one ensemble:
   3 LP buckets, one build, `lp_terms_batch` = buckets x 802, cells
   equal each scheme's `run_batch` on the host, and each bucket's
   `lp_terms_batch` and each stack of one port count's demands'
   `port_stats` held against their twins at their shapes; (d) the
   runner on the reference runner test's 7 cells: shards 0 and 1 of 2
   sharing a cache merge to one sweep's rows byte for byte, a re-run
   computes none, `run_distributed` in one process equals one sweep;
13. the ``kernels`` JSON line (the calendar kernels' and `port_stats`'
   launches summed over phases 3, 8, 10, 11 and 12, `lp_terms_batch`'s over
   phases 3, 11 and 12), then ``{"ok": true, "device": ...}`` last.

Any failed check raises, so the script exits non-zero and prints no
result.  It exits non-zero as well without a CUDA device.
"""

from __future__ import annotations

import dataclasses
import json
import re
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
# The serving phase: gemma3-1b's default server shape, prompts past the
# 512-token window.
SERVE = dict(slots=4, requests=8, prompt_len=600, max_new=16, seed=0)

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, the
# non-tensor-core f32 and f64 rates, and the dense bf16 tensor-core rate.
# 32-bit integer compares are counted against the f32 rate.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
F64_OPS_PER_S = 34e12
BF16_OPS_PER_S = 989e12


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


class DeviceWindow:
    """A `torch.profiler` window opened by `start` and closed by `stop`,
    which returns the wall seconds and, per device kernel name, (total
    device microseconds, launches).  ``cpu=False`` records device activity
    only and sums the trace's raw device events, building no host event
    tree: the same sums, without the tree that makes a window of tens of
    thousands of kernels slow to summarize."""

    def __init__(self, torch, cpu: bool = True):
        self.torch, self.cpu = torch, cpu

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if self.cpu else [])
        self.torch.cuda.synchronize()
        self.prof = profile(activities=activities)
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self):
        torch, prof = self.torch, self.prof
        torch.cuda.synchronize()
        wall = time.perf_counter() - self.t0
        prof.stop()
        cuda = torch.autograd.DeviceType.CUDA
        if self.cpu:
            return wall, {
                e.key: (e.self_device_time_total, e.count)
                for e in prof.key_averages()
                if e.device_type == cuda
            }
        kernels = {}
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == cuda:
                us, n = kernels.get(e.name(), (0.0, 0))
                kernels[e.name()] = (us + e.duration_ns() / 1e3, n + 1)
        return wall, kernels


def profile_device(torch, fn, cpu: bool = True):
    """Run ``fn()`` in a `DeviceWindow`; return its wall seconds and
    per-kernel device sums."""
    window = DeviceWindow(torch, cpu)
    window.start()
    fn()
    return window.stop()


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


#: Launches in one profiled window of `timed_call`.
PROFILED_LAUNCHES = 30
#: Name parts of the CUDA kernels a call launches beside its main one:
#: `flash_attention`'s split route merges its runs in ``..._combine``, the
#: `mlstm_chunk` mma route runs ``..._scan`` before its output kernel.
HELPER_KERNELS = ("_combine", "_scan")


def profiled_launches(torch, kernel, fn, n):
    """Profile ``n`` calls of ``fn``; return the device microseconds of
    every CUDA kernel named ``<kernel>_kernel...`` (a call may launch more
    than one, `HELPER_KERNELS`) and the number of calls the profiler
    recorded (launches of the kernels not named as helpers), and the
    microseconds per kernel name.  It
    now and then reports no device activity for a window this short: up
    to three windows are tried.  After a traced session of tens of
    thousands of kernels it may also record only part of a window's
    launches, so the count is returned, not assumed."""
    for _ in range(3):
        _, kernels = profile_device(torch, lambda: [fn() for _ in range(n)])
        mine = {k: v for k, v in kernels.items() if f"{kernel}_kernel" in k}
        calls = sum(c for k, (_, c) in mine.items()
                    if not any(h in k for h in HELPER_KERNELS))
        if calls:
            return sum(t for t, _ in mine.values()), calls, {k: t for k, (t, _) in mine.items()}
    return 0.0, 0, {}


def library_device_us(torch, fn, n):
    """Device microseconds per call of ``fn`` summed over every kernel it
    launches (the profiler; up to three windows, as `profiled_launches`)."""
    for _ in range(3):
        _, kernels = profile_device(torch, lambda: [fn() for _ in range(n)])
        if kernels:
            return sum(t for t, _ in kernels.values()) / n
    return None


def timed_call(torch, label, kernel, fn, plain, library, nbytes, ops, peak):
    """Time one kernel call at one shape and log it: ``kernel_ms`` and
    ``plain_ms`` (CUDA events), ``library_ms`` where one PyTorch call
    computes the same function, the bound, and the profiler's device-only
    time per launch (the library call's too, over all its kernels, so the
    two compare like with like).  Returns the numbers of the ``kernels``
    line."""
    b_ms, b_by = bound_ms(nbytes, ops, peak)
    t = dict(
        ms=time_ms(torch, fn), plain_ms=time_ms(torch, plain),
        library_ms=None if library is None else time_ms(torch, library),
        bound_ms=b_ms, bound_by=b_by,
    )
    lib = "none" if t["library_ms"] is None else f"{t['library_ms']:.4f}"
    log(f"kernel {label}: kernel_ms {t['ms']:.4f} plain_ms {t['plain_ms']:.4f} "
        f"library_ms {lib} bound_ms {b_ms:.6f} ({b_by})")
    total_us, count, by_name = profiled_launches(torch, kernel, fn, PROFILED_LAUNCHES)
    if count:
        short = re.compile(kernel + r"_kernel\w*(<[^>]*>)?")
        split = "" if len(by_name) < 2 else "; " + ", ".join(
            f"{short.search(name).group(0)} {us / count:.2f}"
            for name, us in sorted(by_name.items(), key=lambda kv: -kv[1]))
        log(f"kernel {label}: device-only {total_us / count:.2f} us per launch "
            f"(profiler, {count} of {PROFILED_LAUNCHES} launches recorded{split})")
    else:
        log(f"kernel {label}: device-only time not measured (the profiler "
            f"saw no device activity)")
    if library is not None:
        us = library_device_us(torch, library, PROFILED_LAUNCHES)
        log(f"kernel {label}: library device-only "
            + ("not measured (the profiler saw no device activity)" if us is None
               else f"{us:.2f} us per call (profiler, all its kernels)"))
    return t


def lp_terms_bytes_ops(M, P, B=1):
    """Bytes (inputs read once, outputs written once) and FMA operations
    of the two LP-terms products."""
    nbytes = 4 * (B * M * M + 2 * B * M * P) + 4 * 2 * B * M
    return nbytes, 2 * (2 * B * M * M * P)


def lp_terms_library(torch, X, p_rho, p_tau, inv_R, dok):
    """The same function as one library product and row max per term."""
    if X.dim() == 2:
        Xt = X.T
        return (Xt @ p_rho).amax(dim=1) * inv_R, (Xt @ p_tau).amax(dim=1) * dok
    Xt = X.transpose(1, 2)
    return (
        torch.bmm(Xt, p_rho).amax(dim=2) * inv_R[:, None],
        torch.bmm(Xt, p_tau).amax(dim=2) * dok[:, None],
    )


def lp_plan(p):
    """The JSON form of an LP-terms plan: its grid, tiles and split."""
    return dict(grid=list(p.grid), rows=p.rows, ports=p.ports,
                rows_per_thread=p.rows_per_thread, groups=p.groups, split=p.split)


def check_lp_terms(label, got, want, M, rtol):
    """Kernel within rtol(M) of its twin, relative (summands >= 0)."""
    err = 0.0
    for a, b in zip(got, want):
        check(bool((a - b).abs().le(rtol * b.abs()).all()),
              f"{label} outside rtol {rtol}")
        err = max(err, float((a - b).abs().max()))
    log(f"{label}: within rtol {rtol:.3g}, max abs err {err:.3g}")
    return err


def single_lp_args(torch, inst, seed):
    """One instance's `lp_terms` operands on the card: X~ from its warm
    start perturbed into the box, its port stats, its scales."""
    from repro_torch.core import lp

    dev = torch.device("cuda")
    ((rho, tau),) = lp.instance_port_stats([inst], dev)
    w = torch.from_numpy(inst.weights).to(dev)
    Y0 = lp.warm_start_Y0_dense(w, lp.global_lower_bound(inst, rho))
    g = torch.Generator().manual_seed(seed)
    Y = torch.clamp(Y0 + 0.3 * torch.rand(Y0.shape, generator=g).to(dev), 0.0, 1.0)
    return (
        lp._precedence_X(Y).contiguous(), rho.to(torch.float32),
        tau.to(torch.float32), 1.0 / inst.aggregate_rate,
        inst.delta / inst.num_cores,
    )


def check_pair_tilings(torch, pr, claim, idle, want, label):
    """`pair_resolve` under its plan and every other tiling equal to
    ``want`` (the twin's); returns the routes held, as text."""
    routes = []
    for p in [None] + pr.tilings(*claim.shape[:2]):
        got = pr.pair_resolve(claim, idle, plan=p)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"pair_resolve {label} plan {p} != plain")
        if p is not None:
            routes.append(f"{p.route} {p.per_block or p.cluster}")
    return "plan, " + ", ".join(routes)


def check_event_tilings(torch, er, args, discipline, want, label):
    """`event_resolve` under every tiling but its plan equal to ``want``
    (the twin's: start, first claimers, blocked); returns how many."""
    plans = er.tilings(*args[0].shape, args[3].shape[1])
    for p in plans:
        got = er.event_resolve(*args, discipline, plan=p)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              f"event_resolve {label} {discipline} plan {p} != plain")
    return len(plans)


def host_copy(torch, host_parts):
    """What `lp.instance_port_stats` pays before its `port_stats` launch:
    ``np.concatenate`` of the instances' demands, then the pageable
    host-to-device copy.  Median of 10 of each, host clock (the copy ending
    in a synchronize) and CUDA events around the copy."""
    concat, host, events = [], [], []
    for _ in range(10):
        t0 = time.perf_counter()
        stacked = torch.from_numpy(np.concatenate(host_parts))
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t2 = time.perf_counter()
        start.record()
        stacked.to("cuda")
        end.record()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t2) * 1e3)
        events.append(start.elapsed_time(end))
        concat.append((t1 - t0) * 1e3)
    return (statistics.median(concat), statistics.median(host),
            statistics.median(events), stacked.numel() * 8)


def hold_port_stats(torch, label, d):
    """`port_stats` on the card's stacked demands ``d`` against its twin and
    host NumPy bit for bit (rho f64, tau exact) under its plan and every
    tiling; logs and returns the plan."""
    from repro_torch.kernels import port_stats as ps
    from repro_torch.kernels.common import sm_count

    M, N = d.shape[:2]
    p = ps.plan(M, N, sm_count(d.device))
    rho_p, tau_p = ps.port_stats_plain(d)
    dh = d.cpu().numpy()
    rho_np = np.concatenate([dh.sum(axis=2), dh.sum(axis=1)], axis=-1)
    check(np.array_equal(rho_p.cpu().numpy(), rho_np), f"port_stats twin {label} != NumPy")
    plans = [None] + ps.tilings(M, N)
    for q in plans:
        rho, tau = ps.port_stats(d, plan=q)
        torch.cuda.synchronize()
        check(torch.equal(tau, tau_p), f"port_stats tau {label} plan {q} != plain")
        check(torch.equal(rho, rho_p), f"port_stats rho {label} plan {q} != plain")
    log(f"port_stats {label} ({M},{N},{N}): rho and tau exact (plain and NumPy) under "
        f"the plan and {len(plans) - 1} tilings; plan {json.dumps(dataclasses.asdict(p))}")
    return p


def phase_port_stats(torch, demands):
    """`port_stats` against its twin and host NumPy bit for bit (rho f64,
    tau exact) under its plan and every tiling (`tilings`), at the
    stacked demands the port feeds it (``demands``: label -> the instances'
    (M_b, N, N) arrays) and at random ones at 48 and 240 ports; each shape
    logs its plan and is timed (the main path's last, which the ``kernels``
    line reports), and the pageable copy of each stacked input is logged
    beside the kernel."""
    from repro_torch.kernels import port_stats as ps

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(48)
    parts = {}
    for label, (M, N) in (("48 ports, random", (192, 48)), ("240 ports, random", (64, 240))):
        d = torch.rand((M, N, N), generator=g, dtype=torch.float64) * 100.0
        parts[label] = [torch.where(torch.rand((M, N, N), generator=g) < 0.5, d, 0.0).numpy()]
    parts.update(demands)
    main = list(demands)[0]
    for label in [k for k in parts if k != main] + [main]:  # the main path's last
        host_parts = parts[label]
        d = torch.from_numpy(np.concatenate(host_parts)).to(dev)
        M, N = d.shape[:2]
        p = hold_port_stats(torch, label, d)
        # Bytes: f64 demands in, f64 rho and int32 tau out; operations:
        # row add, column add, two compares.
        t = timed_call(
            torch, f"port_stats {label} ({M},{N},{N}) route {p.route}", "port_stats",
            lambda: ps.port_stats(d), lambda: ps.port_stats_plain(d),
            lambda: (d.sum(dim=2), d.sum(dim=1), (d > 0).sum(dim=2), (d > 0).sum(dim=1)),
            M * N * N * 8 + M * 2 * N * (8 + 4), M * N * N * 4, F64_OPS_PER_S,
        )
        if label in demands:
            concat_ms, copy_ms, copy_ev_ms, nbytes = host_copy(torch, host_parts)
            log(f"port_stats {label}: input {nbytes} bytes; np.concatenate {concat_ms:.4f} ms, "
                f"pageable host-to-device copy {copy_ms:.4f} ms host clock, "
                f"{copy_ev_ms:.4f} ms CUDA events; the kernel {t['ms']:.4f} ms (events)")
    return dict(name="port_stats", route="cuda",
                source="src/repro_torch/csrc/port_stats.cu",
                replaces="src/repro/kernels/port_stats/kernel.py:37",
                max_abs_err=0.0, **t, extra=dict(plan=dataclasses.asdict(p)))


def phase_kernels(torch, port_stats_demands, ens_lp_arrays, mixed_lp_arrays,
                  wide_lp_arrays, single_insts):
    from repro_torch.core.lp import _precedence_X
    from repro_torch.kernels import lp_terms as lt
    from repro_torch.kernels.common import sm_count
    from repro_torch.kernels import pair_resolve as pr

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    rows = []

    # pair_resolve: exact on every route (the plan's and every other
    # tiling), up to the widened 152 ports (150 + the quantum); timed at
    # the wide shapes, then the main path's.
    sms = sm_count(dev)
    for G, N in ((96, 12), (8, 48), (8, 152)):
        claim, idle = random_claims(torch, G, N, gen, dev)
        want = pr.pair_resolve_plain(claim, idle)
        routes = check_pair_tilings(torch, pr, claim, idle, want, f"({G},{N},{N})")
        log(f"pair_resolve ({G},{N},{N}): exact match on {routes}, {int(want.sum())} starts; "
            f"plan {json.dumps(dataclasses.asdict(pr.plan(G, N, sms)))}")
        if N > 12:
            timed_call(
                torch, f"pair_resolve ({G},{N},{N})", "pair_resolve",
                lambda: pr.pair_resolve(claim, idle),
                lambda: pr.pair_resolve_plain(claim, idle), None,
                G * N * N * (4 + 1 + 1), G * N * N * 5, F32_OPS_PER_S,
            )
    claim, idle = random_claims(torch, 96, 12, gen, dev)
    G, N = 96, 12
    rows.append(dict(
        name="pair_resolve", route="cuda",
        source="src/repro_torch/csrc/pair_resolve.cu",
        replaces="src/repro/kernels/event_resolve/kernel.py:149",
        max_abs_err=0.0,
        # Bytes: int32 claims and bool idle in, bool starts out; operations:
        # row and column min, two compares, one and.
        **timed_call(
            torch, f"pair_resolve ({G},{N},{N})", "pair_resolve",
            lambda: pr.pair_resolve(claim, idle),
            lambda: pr.pair_resolve_plain(claim, idle), None,
            G * N * N * (4 + 1 + 1), G * N * N * 5, F32_OPS_PER_S,
        ),
        extra=dict(plan=dataclasses.asdict(pr.plan(G, N, sms))),
    ))

    rows.append(phase_port_stats(torch, port_stats_demands))

    # lp_terms_batch: f32 sums in different orders, stated tolerance; the
    # paper bucket (the main path's shape), a mixed-N bucket and 300 ports.
    err = 0.0
    batch_args = {}
    for label, arrays in (("paper bucket", ens_lp_arrays),
                          ("mixed-N bucket", mixed_lp_arrays),
                          ("wide bucket", wide_lp_arrays)):
        g = torch.Generator().manual_seed(7)
        Y = arrays["Y0"] + 0.3 * torch.rand(arrays["Y0"].shape, generator=g).to(dev)
        X = _precedence_X(torch.clamp(Y, 0.0, 1.0), arrays["coflow_mask"]).contiguous()
        args = (X, arrays["p_rho"], arrays["p_tau"], arrays["inv_R"], arrays["delta_over_K"])
        got = lt.lp_terms_batch(*args)
        torch.cuda.synchronize()
        B, M, _ = X.shape
        err = max(err, check_lp_terms(
            f"lp_terms_batch {label} B={B} M={M} P={args[1].shape[2]}",
            got, lt.lp_terms_batch_plain(*args), M, lt.rtol(M),
        ))
        batch_args[label] = args
    for label in ("wide bucket", "paper bucket"):  # the main path's last
        args = batch_args[label]
        B, M, P = args[1].shape
        plan = lp_plan(lt.plan(B, M, P, sms))
        log(f"lp_terms_batch {label} (B={B}, M={M}, P={P}): plan {json.dumps(plan)}")
        t = timed_call(
            torch, f"lp_terms_batch {label} (B={B}, M={M}, P={P})", "lp_terms_batch",
            lambda: lt.lp_terms_batch(*args), lambda: lt.lp_terms_batch_plain(*args),
            lambda: lp_terms_library(torch, *args),
            *lp_terms_bytes_ops(M, P, B), F32_OPS_PER_S,
        )
    rows.append(dict(
        name="lp_terms_batch", route="cuda",
        source="src/repro_torch/csrc/lp_terms.cu",
        replaces="src/repro/kernels/lp_terms/kernel.py:101",
        max_abs_err=err, **t, extra=dict(plan=plan),
    ))

    # lp_terms: one instance, scalar scales; the paper instance (the main
    # path's shape), a small one and the whole trace's (526, 300).
    err = 0.0
    single = {}
    for label, inst in single_insts:
        args = single_lp_args(torch, inst, seed=len(single))
        got = lt.lp_terms(*args)
        torch.cuda.synchronize()
        M, P = args[1].shape
        err = max(err, check_lp_terms(
            f"lp_terms {label} (M={M}, P={P})", got, lt.lp_terms_plain(*args),
            M, lt.rtol(M),
        ))
        single[label] = args
    for label in reversed(list(single)):  # the main path's shape last
        args = single[label]
        M, P = args[1].shape
        plan = lp_plan(lt.plan(1, M, P, sms))
        log(f"lp_terms {label} (M={M}, P={P}): plan {json.dumps(plan)}")
        t = timed_call(
            torch, f"lp_terms {label} (M={M}, P={P})", "lp_terms",
            lambda: lt.lp_terms(*args), lambda: lt.lp_terms_plain(*args),
            lambda: lp_terms_library(torch, *args),
            *lp_terms_bytes_ops(M, P), F32_OPS_PER_S,
        )
    rows.append(dict(
        name="lp_terms", route="cuda",
        source="src/repro_torch/csrc/lp_terms.cu",
        replaces="src/repro/kernels/lp_terms/kernel.py:183",
        max_abs_err=err, **t, extra=dict(plan=plan),
    ))
    return rows


# The reference's sweep (tests/test_kernels.py ATTN_CASES), a subset:
# B, Hq, Hkv, Sq, Skv, D, causal, window, q_offset.
ATTN_SWEEP = [
    (2, 4, 2, 256, 256, 64, True, None, 0),
    (1, 2, 2, 256, 256, 64, True, 100, 0),
    (1, 2, 1, 8, 512, 64, True, None, 504),
    (1, 2, 2, 128, 128, 128, False, None, 0),
    (1, 3, 1, 64, 320, 32, True, None, 256),
    (2, 4, 2, 40, 57, 16, True, 16, 0),
]


def attention_mask(torch, Sq, Skv, causal, window, q_offset, dev):
    """The (Sq, Skv) visibility mask of the kernel's arguments."""
    qi = q_offset + torch.arange(Sq, device=dev)[:, None]
    kj = torch.arange(Skv, device=dev)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=dev)
    if causal:
        mask &= qi >= kj
    if window is not None:
        mask &= (qi - kj) < window
    return mask


def phase_flash_kernel(torch):
    """`flash_attention` against its twin: f32 within 2e-5 (the reference
    sweep's tolerance); bf16 within one bf16 rounding (2**-7 of the value
    plus 1e-5), since both compute in f32 and round once.  Each case logs
    the route `flash_attention.plan` gave it.  Then the serving shapes and
    the training shape timed."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator().manual_seed(15)
    timed = {
        "prefill local": (4, 4, 1, 600, 617, 256, True, 512, 0),
        "prefill global": (4, 4, 1, 600, 617, 256, True, None, 0),
        "decode global": (4, 4, 1, 1, 617, 256, True, None, 600),
        "decode local": (4, 4, 1, 1, 617, 256, True, 512, 600),
        "training": (4, 4, 1, 1024, 1024, 256, True, None, 0),
    }
    err = 0.0
    inputs = {}
    for label, case in [*timed.items(), *(("sweep", c) for c in ATTN_SWEEP)]:
        B, Hq, Hkv, Sq, Skv, D, causal, window, off = case
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (
                torch.randn(shape, generator=gen).to(dev, dtype)
                for shape in ((B, Hq, Sq, D), (B, Hkv, Skv, D), (B, Hkv, Skv, D))
            )
            got = fa.flash_attention(q, k, v, causal, window, off)
            torch.cuda.synchronize()
            want = fa.flash_attention_plain(q, k, v, causal, window, off).float()
            e = (got.float() - want).abs()
            if dtype == torch.float32:
                check(bool((e <= 2e-5).all()), f"flash_attention {label} {case} f32 "
                      f"off by {float(e.max())}")
            else:
                check(bool((e <= 2**-7 * want.abs() + 1e-5).all()),
                      f"flash_attention {label} {case} bf16 beyond one rounding")
                err = max(err, float(e.max()))
            plan = fa.plan(dtype, B, Hq, Hkv, Sq, Skv, causal, window, off, sms)
            log(f"flash_attention {label} {case} {str(dtype)[6:]}: route {plan.route}"
                + (f" ({plan.n_split} runs of {plan.length} keys from {plan.begin})"
                   if plan.route == "split" else "")
                + f", max abs err {float(e.max()):.3g}")
            if label in timed and dtype == torch.bfloat16:
                inputs[label] = (q, k, v, case)
            del q, k, v, got, want, e
    # The model hands the kernel (B, S, H, D) tensors viewed as (B, H, S, D).
    for label in ("prefill local", "decode local"):
        q, k, v, case = inputs[label]
        views = [t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v)]
        check(torch.equal(fa.flash_attention(*views, *case[6:]),
                          fa.flash_attention(q, k, v, *case[6:])),
              f"flash_attention {label} on strided views differs from contiguous inputs")
    log("flash_attention: strided (B, S, H, D) views give the same bits")

    times = {}
    for label in timed:
        q, k, v, case = inputs[label]
        B, Hq, Hkv, Sq, Skv, D, causal, window, off = case
        mask = attention_mask(torch, Sq, Skv, causal, window, off, dev)
        # Bytes: q in and out once, each live key/value row once per kv
        # head; operations: 2 products x 2 flops x D per live pair, at the
        # bf16 tensor-core rate (the least time for bf16 work).
        pairs = int(mask.sum())
        live_rows = int(mask.any(dim=0).sum())
        nbytes = 2 * (2 * B * Hq * Sq * D + 2 * B * Hkv * live_rows * D)
        ops = 4 * D * pairs * B * Hq
        times[label] = timed_call(
            torch, f"flash_attention {label} (B={B}, Hq={Hq}, Hkv={Hkv}, Sq={Sq}, "
            f"Skv={Skv}, D={D}, window={window}, q_offset={off}, bf16)",
            "flash_attention",
            lambda: fa.flash_attention(q, k, v, causal, window, off),
            lambda: fa.flash_attention_plain(q, k, v, causal, window, off),
            lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, enable_gqa=True),
            nbytes, ops, BF16_OPS_PER_S,
        )
    # The row carries the most launched shape: a decode step of a local layer.
    return dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:99",
        max_abs_err=err, **times["decode local"],
    )


# The reference's mLSTM kernel cases (tests/test_mlstm_kernel.py):
# BH, S, Dh, chunk.
MLSTM_CASES = [(2, 64, 32, 16), (1, 128, 64, 32), (3, 96, 16, 32), (2, 256, 128, 128)]


def mlstm_inputs(torch, BH, S, Dh, dtype, carried, gen):
    """The reference test's distributions on the card: q, v N(0, 1), k
    N(0, 1/Dh), log_f = log U(0.8, 0.999), log_i U(-2, 1); a carried state
    (S0 N(0, 0.01), n0 N(0, 1)) or None."""
    dev = torch.device("cuda")
    q = torch.randn((BH, S, Dh), generator=gen)
    k = torch.randn((BH, S, Dh), generator=gen) / Dh**0.5
    v = torch.randn((BH, S, Dh), generator=gen)
    log_f = torch.log(0.8 + 0.199 * torch.rand((BH, S), generator=gen))
    log_i = -2.0 + 3.0 * torch.rand((BH, S), generator=gen)
    args = [t.to(dev, dtype) for t in (q, k, v)] + [t.to(dev) for t in (log_f, log_i)]
    if not carried:
        return args, None
    return args, ((0.1 * torch.randn((BH, Dh, Dh), generator=gen)).to(dev),
                  torch.randn((BH, Dh), generator=gen).to(dev))


def mlstm_bytes_ops(BH, S, Dh, C, itemsize, carried):
    """Bytes, and two counts of operations with their peaks.  Bytes: q, k,
    v read and h written once, the two f32 gates, the f32 state written
    (and read when carried).  Operations per chunk: 2 Dh flops per live
    pair t >= s for q k^T and again for the scores against v, 2 C Dh^2 each
    for inter and the state update.  Restated (for the tensor-core routes):
    with bf16 operands every product at the bf16 dense rate, those with an
    f32 operand (scores v, inter, the update) counted twice for their hi +
    lo halves; with f32 operands the f32-rate count.  The f32-rate count:
    q k^T at the bf16 rate with bf16 operands (else f32), every other
    product at the f32 rate; the peak returned puts all operations in the
    sum of those two times.  Returns (bytes, (ops, peak) restated, (ops,
    peak) at the f32 rate)."""
    state = 4 * BH * (Dh * Dh + Dh)
    nbytes = 4 * BH * S * Dh * itemsize + 2 * 4 * BH * S + state * (2 if carried else 1)
    items = BH * (S // C)
    pairs = C * (C + 1) // 2
    qk = items * 2 * pairs * Dh
    rest = items * 2 * (pairs * Dh + 2 * C * Dh * Dh)
    qk_peak = BF16_OPS_PER_S if itemsize == 2 else F32_OPS_PER_S
    old = (qk + rest, (qk + rest) / (qk / qk_peak + rest / F32_OPS_PER_S))
    new = (qk + 2 * rest, BF16_OPS_PER_S) if itemsize == 2 else old
    return nbytes, new, old


def phase_mlstm_kernel(torch):
    """`mlstm_chunk` against its twin on every route `plan` gives: at the
    serving shapes (prefill (16, 768, 512) with C = 256 and, as phase 7's
    second forward runs it, (16, 640, 512) with C = 128; decode (16, 1,
    512)), at the reference's cases (`tests/test_mlstm_kernel.py`) and at
    those cases with chunks of 1 (the stream route over S positions), each
    with a zero and a carried state in f32 and bf16.  f32: h, S and n within
    2e-4 (rtol and atol, the reference's tolerance for its kernel); bf16: S
    and n within 2e-4 (both widen the same bf16 values), h within one bf16
    rounding of the twin's (2**-7 of the value) plus 2e-4, since both round
    an f32 result once.  Each case logs its route.  Then prefill (zeros) and
    decode (carried) timed on each route: bf16 and f32."""
    from repro_torch.kernels import mlstm_chunk as mc

    gen = torch.Generator().manual_seed(18)
    serving = {"prefill": (16, 768, 512, 256), "prefill, chunk 128": (16, 640, 512, 128),
               "decode": (16, 1, 512, 256)}
    cases = [*serving.items(), *(("reference", c) for c in MLSTM_CASES),
             *(("reference, chunk 1", (*c[:3], 1)) for c in MLSTM_CASES)]
    err, inputs, routes = 0.0, {}, set()
    for label, (BH, S, Dh, C) in cases:
        for dtype in (torch.float32, torch.bfloat16):
            route = mc.plan(dtype, BH, S, Dh, min(C, S))
            routes.add(route)
            for carried in (False, True):
                args, state = mlstm_inputs(torch, BH, S, Dh, dtype, carried, gen)
                h, (s_fin, n_fin) = mc.mlstm_chunk(*args, state=state, chunk=C)
                torch.cuda.synchronize()
                h_p, (s_p, n_p) = mc.mlstm_chunk_plain(*args, state=state, chunk=C)
                what = f"mlstm_chunk {label} {(BH, S, Dh, C)} {str(dtype)[6:]} " + (
                    "carried" if carried else "zero") + f" state, route {route}"
                pairs = [("S", s_fin, s_p), ("n", n_fin, n_p)]
                if dtype == torch.float32:
                    pairs.append(("h", h, h_p))
                for name, a, b in pairs:
                    e = (a - b).abs()
                    check(bool((e <= 2e-4 + 2e-4 * b.abs()).all()),
                          f"{what}: {name} off by {float(e.max())}")
                    err = max(err, float(e.max()))
                eh = (h.float() - h_p.float()).abs()
                if dtype == torch.bfloat16:
                    check(bool((eh <= 2**-7 * h_p.float().abs() + 2e-4).all()),
                          f"{what}: h beyond one bf16 rounding")
                log(f"{what}: max abs err h {float(eh.max()):.3g}, S "
                    f"{float((s_fin - s_p).abs().max()):.3g}, n "
                    f"{float((n_fin - n_p).abs().max()):.3g}")
                if label in ("prefill", "decode"):
                    inputs[label, dtype, carried] = (args, state, C)
                del args, state, h, s_fin, n_fin, h_p, s_p, n_p
    check(routes == {"mma", "stream", "simt"}, f"mlstm_chunk: routes held {sorted(routes)}")
    rows = {}
    for label, carried in (("prefill", False), ("decode", True)):
        for dtype in (torch.bfloat16, torch.float32):
            args, state, C = inputs[label, dtype, carried]
            BH, S, Dh = args[0].shape
            itemsize = 2 if dtype == torch.bfloat16 else 4
            route = mc.plan(dtype, BH, S, Dh, min(C, S))
            nbytes, (ops, peak), old = mlstm_bytes_ops(BH, S, Dh, min(C, S), itemsize, carried)
            name = (f"mlstm_chunk {label} (BH={BH}, S={S}, Dh={Dh}, C={min(C, S)}, "
                    f"{'carried' if carried else 'zero'} state, {str(dtype)[6:]}, route {route})")
            t = timed_call(
                torch, name, "mlstm_chunk",
                lambda: mc.mlstm_chunk(*args, state=state, chunk=C),
                lambda: mc.mlstm_chunk_plain(*args, state=state, chunk=C),
                None, nbytes, ops, peak,
            )
            b_old, by_old = bound_ms(nbytes, *old)
            log(f"kernel {name}: bound_ms at the f32 rate {b_old:.6f} ({by_old}), "
                f"restated {t['bound_ms']:.6f} ({t['bound_by']})")
            rows[label, dtype] = dict(t, plan=route)
    # The row carries the most launched shape: a bf16 decode step; max_abs_err
    # is the largest f32 difference (h, S, n) and bf16 state difference.
    row = rows["decode", torch.bfloat16]
    return dict(
        name="mlstm_chunk", route="cuda",
        source="src/repro_torch/csrc/mlstm_chunk.cu",
        replaces="src/repro/kernels/mlstm_chunk/kernel.py:92",
        max_abs_err=err, **{k: row[k] for k in ("ms", "plain_ms", "library_ms",
                                                  "bound_ms", "bound_by")},
        extra=dict(plan=row["plan"]),
    )


# The reference's quant cases (tests/test_kernels.py::test_quant_matches_ref),
# then the trainer's rows of 512: the embedding of gemma3-1b (262144 x 1152
# values), a norm leaf (1152 values: 3 rows, the last one padded with
# zeros) and rows that are all zero.
QUANT_CASES = [(4, 128), (64, 512), (33, 300), (1, 64), (589_824, 512), (3, 512), (5, 512)]


def phase_quant_kernel(torch):
    """`quantize` and `dequantize` against their twins, exactly (every step
    is one IEEE f32 operation on both routes), then both timed at the
    embedding's rows, the largest leaf of the gradient exchange."""
    from repro_torch.kernels import quant as qt

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(19)
    inputs = None
    for R, C in QUANT_CASES:
        x = torch.randn((R, C), generator=gen) * 3.0
        if (R, C) == (3, 512):
            x[2, 128:] = 0.0  # 1152 values padded to 3 rows
        if (R, C) == (5, 512):
            x[1] = 0.0
            x[4] = 0.0
        x = x.to(dev)
        noise = torch.rand((R, C), generator=gen).to(dev)
        q, s = qt.quantize(x, noise)
        d = qt.dequantize(q, s)
        torch.cuda.synchronize()
        q_p, s_p = qt.quantize_plain(x, noise)
        d_p = qt.dequantize_plain(q_p, s_p)
        check(torch.equal(q, q_p) and torch.equal(s, s_p), f"quantize {(R, C)} differs from its twin")
        check(torch.equal(d, d_p), f"dequantize {(R, C)} differs from its twin")
        zero = s == 1e-30
        log(f"quant {(R, C)}: q, scale and dequantized values identical to the twins "
            f"({int(zero.sum())} all-zero rows at the 1e-30 floor)")
        if R == 589_824:
            inputs = (x, noise, q, s)
    x, noise, q, s = inputs
    R, C = x.shape
    t_q = timed_call(
        torch, f"quantize embedding rows (R={R}, C={C}, f32 -> int8)", "quantize",
        lambda: qt.quantize(x, noise), lambda: qt.quantize_plain(x, noise), None,
        R * C * (4 + 4 + 1) + 4 * R, 0, F32_OPS_PER_S,
    )
    t_d = timed_call(
        torch, f"dequantize embedding rows (R={R}, C={C}, int8 -> f32)", "dequantize",
        lambda: qt.dequantize(q, s), lambda: qt.dequantize_plain(q, s),
        lambda: torch.mul(q, s[:, None]), R * C * (1 + 4) + 4 * R, 0, F32_OPS_PER_S,
    )
    common = dict(route="cuda", source="src/repro_torch/csrc/quant.cu", max_abs_err=0.0)
    return [
        dict(name="quantize", replaces="src/repro/kernels/quant/kernel.py:40", **common, **t_q),
        dict(name="dequantize", replaces="src/repro/kernels/quant/kernel.py:76", **common, **t_d),
    ]


def schedule_tables(pairs):
    """Calendar member tables (the flows of each (instance, core), in
    priority order) of finished runs: ``pairs`` holds (instance, result)."""
    tabs = []
    for inst, res in pairs:
        for cs in res.core_schedules:
            if len(cs.coflow):
                tabs.append(dict(src=cs.src, dst=cs.dst, rel=inst.releases[cs.coflow],
                                 dur=cs.delta + cs.size / cs.rate))
    return tabs


def whole_trace_table(inst):
    """The one member of a single-core instance: every flow, coflows in
    release order."""
    m, i, j = np.nonzero(inst.demands)
    o = np.argsort(inst.releases[m], kind="stable")
    m, i, j = m[o], i[o], j[o]
    return dict(src=i, dst=j, rel=inst.releases[m], coflow=m,
                dur=inst.delta + inst.demands[m, i, j] / inst.rates[0])


#: Rounds of the pair calendar on the trace held mask for mask (the first
#: 16 and 16 from round 256, when more coflows are out), and the rounds of
#: each engine's calendar in a profiled window (after 256).
TRACE_HELD_ROUNDS = (range(16), range(256, 272))
TRACE_WINDOW = range(256, 276)


def pair_calendar_prefix(table, n_ports):
    """The first coflows (release order) of a member table that the pair
    calendar takes at ``n_ports``: its int32 segment keys need (P + 1)
    (Fmax + 1) < 2**31 with P the padded ports squared, so at 152 ports
    at most 92,928 flows (the whole trace has 266,260)."""
    from repro_torch.pipeline import batch_circuit as bc

    P = bc._round_up(n_ports, bc._N_QUANTUM) ** 2
    limit = ((2**31 - 1) // (P + 1) - 1) // bc._F_QUANTUM * bc._F_QUANTUM
    ends = np.flatnonzero(np.diff(table["coflow"]) != 0) + 1  # coflow boundaries
    k = int(ends[ends <= limit].max()) if table["coflow"].shape[0] > limit else None
    return {key: v[:k] for key, v in table.items()}


def phase_trace_calendars(torch, inst):
    """The whole trace's member on the calendars themselves: `pair_resolve`
    held mask for mask (plan and every tiling) on the `TRACE_HELD_ROUNDS`
    of each discipline's pair calendar at 152 ports, on the longest prefix
    the pair calendar takes; then a profiled window of `TRACE_WINDOW`
    greedy rounds of each engine's calendar, logging the resolve kernel's
    share of the window's device time (the flow engine on the prefix and
    on the whole member)."""
    from repro_torch.kernels import pair_resolve as pr
    from repro_torch.pipeline import batch_circuit as bc

    dev = torch.device("cuda")
    whole = whole_trace_table(inst)
    prefix = pair_calendar_prefix(whole, inst.num_ports)
    pads = {"prefix": bc._pad_members([prefix], inst.num_ports),
            "whole": bc._pad_members([whole], inst.num_ports)}
    pad = pads["prefix"]
    G, F, N = pad["G"], pad["Fmax"], pad["Nmax"]
    label = f"trace prefix ({prefix['src'].shape[0]} of {whole['src'].shape[0]} flows)"
    kernel = bc.pair_resolve
    for d in ("greedy", "reserving"):
        cal = bc._PairCalendar(pad, d == "reserving", dev)
        held = []

        def checking(claim, idle):
            want = pr.pair_resolve_plain(claim, idle)
            check_pair_tilings(torch, pr, claim, idle, want, f"{label} {d} round {len(held)}")
            held.append(int(want.sum()))
            return kernel(claim, idle)

        held_rounds = {r for rounds in TRACE_HELD_ROUNDS for r in rounds}
        try:
            for r in range(max(held_rounds) + 1):
                bc.pair_resolve = checking if r in held_rounds else kernel
                cal.round()
        finally:
            bc.pair_resolve = kernel
        check(len(held) == len(held_rounds), f"{label}: {len(held)} pair rounds held")
        log(f"pair_resolve on the pair calendar, {label}, (G={G}, N={N}) {d}: exact match "
            f"(plan and every tiling) on {len(held)} rounds, "
            f"{', '.join(f'{r.start}-{r.stop - 1}' for r in TRACE_HELD_ROUNDS)} "
            f"({sum(held)} starts)")
    for engine, which in (("kernel", "prefix"), ("jax", "prefix"), ("jax", "whole")):
        cal = bc._CALENDARS[engine](pads[which], False, dev)
        name = "pair_resolve" if engine == "kernel" else "event_resolve"
        for _ in range(TRACE_WINDOW.start):
            cal.round()
        wall, kernels = profile_device(
            torch, lambda: [cal.round() for _ in TRACE_WINDOW])
        busy = sum(us for us, _ in kernels.values())
        mine = [(us, n) for key, (us, n) in kernels.items() if f"{name}_kernel" in key]
        us, n = sum(u for u, _ in mine), sum(c for _, c in mine)
        log(f"calendar window, engine {engine!r}, trace {which} (G={G}, "
            f"Fmax={pads[which]['Fmax']}, N={N}), greedy rounds {TRACE_WINDOW.start}-"
            f"{TRACE_WINDOW.stop - 1}: wall "
            f"{wall * 1e3:.3f} ms, device busy {busy:.1f} us over "
            f"{sum(c for _, c in kernels.values())} kernels; {name} {us:.1f} us over {n} "
            f"recorded launches ({100 * us / busy if busy else float('nan'):.1f} % of busy)")


def random_event_state(torch, gen, G, F, N, dev):
    """`event_resolve` operands from a seed: f64 times, 70 % pending."""
    def f64(*shape):
        return (10.0 * torch.rand(shape, generator=gen, dtype=torch.float64)).to(dev)

    def ports():
        return torch.randint(0, N, (G, F), generator=gen, dtype=torch.int32).to(dev)

    return (ports(), ports(), f64(G, F), f64(G, N), f64(G, N),
            (torch.rand((G, F), generator=gen) < 0.7).to(dev), f64(G))


def phase_event_kernel(torch, shapes):
    """`event_resolve` against its twin on the card, mask for mask (start,
    first claimers, blocked), under both disciplines: on the states of a
    flow calendar run on each bucket (``shapes``: label -> (member tables,
    ports, rounds to check)) and on random states of the same shape; then
    timed at each, the main path's bucket last."""
    from repro_torch.kernels import event_resolve as er
    from repro_torch.kernels.common import sm_count
    from repro_torch.pipeline import batch_circuit as bc

    dev = torch.device("cuda")
    sms = sm_count(dev)
    gen = torch.Generator().manual_seed(17)
    states = {}
    for label, (tabs, n_ports, max_rounds) in shapes.items():
        pad = bc._pad_members(tabs, n_ports)
        G, F, N = pad["G"], pad["Fmax"], pad["Nmax"]
        plan = er.plan(G, F, N, sms)
        for d in ("greedy", "reserving"):
            cal = bc._FlowCalendar(pad, d == "reserving", dev)
            checked = starts = tilings = 0
            while checked < max_rounds and cal.live():
                args = cal.flow_args()
                if checked == 0 and d == "greedy":
                    states[label] = (args, G, F, N)
                got = er.event_resolve(*args, d)
                torch.cuda.synchronize()
                want = er.event_resolve_plain(*args, d)
                check(all(torch.equal(a, b) for a, b in zip(got, want)),
                      f"event_resolve {label} ({G},{F},{N}) {d} round {checked} != plain")
                if checked == 0:  # every other route on the first round's state
                    tilings = check_event_tilings(torch, er, args, d, want, label)
                starts += int(want[0].sum())
                checked += 1
                cal.round()
            rand = random_event_state(torch, gen, G, F, N, dev)
            got = er.event_resolve(*rand, d)
            torch.cuda.synchronize()
            want = er.event_resolve_plain(*rand, d)
            check(all(torch.equal(a, b) for a, b in zip(got, want)),
                  f"event_resolve {label} ({G},{F},{N}) {d} random state != plain")
            check_event_tilings(torch, er, rand, d, want, f"{label} random state")
            log(f"event_resolve {label} (G={G}, Fmax={F}, Nmax={N}) {d}: exact match "
                f"(start, first claimers, blocked) on {checked} calendar rounds "
                f"({starts} starts) and one random state ({int(want[0].sum())} starts) "
                f"under the plan, and under {tilings} tilings on round 0 and the random "
                f"state; plan {json.dumps(dataclasses.asdict(plan))}")
    t = None
    for label, (args, G, F, N) in reversed(list(states.items())):
        # What this state needs, padding included: the pending byte in and
        # the start byte out of every slot, the f64 release of a pending
        # flow, the two int32 ports of a waiting one (pending and
        # released); f64 free times in and int32 first claimers out per
        # port; t in and blocked out per member.  Operations: one f64
        # compare per pending flow, two more per waiting one.
        rel, pending, t_g = args[2], args[5], args[6]
        n_pending = int(pending.sum())
        n_waiting = int((pending & (rel <= t_g[:, None])).sum())
        log(f"event_resolve {label}: {G * F} slots, {n_pending} pending, "
            f"{n_waiting} waiting")
        t = timed_call(
            torch, f"event_resolve {label} (G={G}, F={F}, N={N}, greedy)",
            "event_resolve",
            lambda: er.event_resolve(*args, "greedy"),
            lambda: er.event_resolve_plain(*args, "greedy"), None,
            2 * G * F + 8 * n_pending + 8 * n_waiting
            + G * N * (8 + 8 + 4 + 4) + G * (8 + 1),
            n_pending + 2 * n_waiting, F64_OPS_PER_S,
        )
    # Control: this phase runs after the traced passes of phases 3-5, so
    # profile a kernel timed before them, at its main-path shape, here too:
    # a partial count for it as well is the profiler's, not the kernel's.
    from repro_torch.kernels import pair_resolve as pr

    claim, idle = random_claims(torch, 96, 12, gen, dev)
    _, count, _ = profiled_launches(torch, "pair_resolve",
                                    lambda: pr.pair_resolve(claim, idle), PROFILED_LAUNCHES)
    log(f"profiler control: pair_resolve (96,12,12) after phases 3-5: {count} of "
        f"{PROFILED_LAUNCHES} launches recorded")
    return dict(
        name="event_resolve", route="cuda",
        source="src/repro_torch/csrc/event_resolve.cu",
        replaces="src/repro/kernels/event_resolve/kernel.py:89",
        max_abs_err=0.0, **t, extra=dict(plan=dataclasses.asdict(er.plan(G, F, N, sms))),
    )


# ---------------------------------------------------------------------------
# Phases 3 and 4: the main path end to end, and GPU/CPU parity
# ---------------------------------------------------------------------------


def counters():
    """Kernel name -> (module, name of its launch counter)."""
    from repro_torch.kernels import (
        event_resolve, flash_attention, lp_terms, mlstm_chunk, pair_resolve, port_stats, quant,
    )

    return dict(
        port_stats=(port_stats, "LAUNCHES"),
        lp_terms_batch=(lp_terms, "LAUNCHES"),
        lp_terms=(lp_terms, "SINGLE_LAUNCHES"),
        pair_resolve=(pair_resolve, "LAUNCHES"),
        event_resolve=(event_resolve, "LAUNCHES"),
        flash_attention=(flash_attention, "LAUNCHES"),
        mlstm_chunk=(mlstm_chunk, "LAUNCHES"),
        quantize=(quant, "LAUNCHES_QUANTIZE"),
        dequantize=(quant, "LAUNCHES_DEQUANTIZE"),
    )


def reset_counts():
    """Every kernel's launch count and each calendar engine's rounds to 0."""
    from repro_torch.pipeline import batch_circuit

    for mod, attr in counters().values():
        setattr(mod, attr, 0)
    for engine in batch_circuit.ROUNDS:
        batch_circuit.ROUNDS[engine] = 0


def read_counts():
    return {name: getattr(mod, attr) for name, (mod, attr) in counters().items()}


def phase_end_to_end(torch, label, instances):
    """Main path through the user entry points, with launch counts."""
    from repro_torch.experiments import build_buckets, solve_ensemble_lp
    from repro_torch.pipeline import batch_circuit, get_pipeline

    reset_counts()
    t0 = time.perf_counter()
    sols = solve_ensemble_lp(instances, iters=LP_ITERS)
    results, pair_rounds = {}, {}
    for d in ("greedy", "reserving"):
        before = batch_circuit.ROUNDS["kernel"]
        results[d] = get_pipeline("ours", discipline=d).run_batch(
            instances, lp_solutions=sols, validate=True
        )
        pair_rounds[d] = batch_circuit.ROUNDS["kernel"] - before
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    rounds = batch_circuit.ROUNDS["kernel"]

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
    check(counts["lp_terms"] == 0,
          f"{label}: lp_terms launched {counts['lp_terms']} times on the "
          f"batched path, expected 0")
    check(counts["event_resolve"] == batch_circuit.ROUNDS["jax"] == 0,
          f"{label}: event_resolve launched {counts['event_resolve']} times under "
          f"the pair engine, expected 0")
    log(f"{label}: {len(instances)} instances validated under both "
        f"disciplines; weighted CCT / LP objective (greedy) min "
        f"{min(ratios):.4f} max {max(ratios):.4f}; bound 8K+1 = "
        f"{8 * instances[0].num_cores + 1}; wall {wall:.2f} s")
    log(f"{label}: launches {json.dumps(counts)} (lp_terms_batch expected "
        f"{expect_lp} = {n_buckets} bucket(s) x ({LP_ITERS} steps + start + "
        f"result); port_stats expected {expect_ps}; pair_resolve expected "
        f"{rounds} = calendar rounds of both disciplines)")
    return sols, counts, results, pair_rounds


def phase_flow_engine(torch, label, instances, sols, pair_results, pair_rounds):
    """The same LP solutions through ``circuit_engine="jax"`` (the
    flow-space calendar on `event_resolve`), both disciplines, counted
    apart from the pair engine's run: schedules bit-identical to the pair
    engine's on the card and to the flow engine's on the host;
    `event_resolve` launched once per flow-calendar round, `pair_resolve`
    never; under reserving as many rounds as the pair engine."""
    from repro_torch.pipeline import batch_circuit, get_pipeline

    reset_counts()
    results, rounds, walls = {}, {}, {}
    for d in ("greedy", "reserving"):
        before = batch_circuit.ROUNDS["jax"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results[d] = get_pipeline("ours", discipline=d, circuit_engine="jax").run_batch(
            instances, lp_solutions=sols, validate=True
        )
        torch.cuda.synchronize()
        walls[d] = time.perf_counter() - t0
        rounds[d] = batch_circuit.ROUNDS["jax"] - before
    counts = read_counts()
    total = batch_circuit.ROUNDS["jax"]

    for d, res in results.items():
        for b, (inst, sol, r, want) in enumerate(zip(instances, sols, res, pair_results[d])):
            check(r.total_weighted_cct <= (8 * inst.num_cores + 1) * sol.objective,
                  f"{label} jax engine {d} instance {b}: weighted CCT beyond (8K+1) x LP")
            check_same_schedule(f"{label} jax engine vs kernel engine {d} instance {b}",
                                r, want)
    expect_ps = 2 * len({inst.num_ports for inst in instances})
    check(counts["event_resolve"] == total > 0,
          f"{label}: event_resolve launched {counts['event_resolve']} times, "
          f"expected {total} (one per flow-calendar round)")
    check(counts["pair_resolve"] == batch_circuit.ROUNDS["kernel"] == 0,
          f"{label}: pair_resolve launched {counts['pair_resolve']} times under "
          f"the flow engine, expected 0")
    check(counts["port_stats"] == expect_ps,
          f"{label}: port_stats launched {counts['port_stats']} times under the "
          f"flow engine, expected {expect_ps}")
    check(counts["lp_terms_batch"] == counts["lp_terms"] == 0,
          f"{label}: LP kernels launched under the flow engine")
    check(rounds["reserving"] == pair_rounds["reserving"],
          f"{label}: reserving flow calendar ran {rounds['reserving']} rounds, the "
          f"pair calendar {pair_rounds['reserving']}")
    log(f"{label} jax engine: schedules bit-identical to the kernel engine's "
        f"(orders, cores, establish/complete, CCTs; both disciplines); rounds "
        f"greedy {rounds['greedy']} (pair engine {pair_rounds['greedy']}), "
        f"reserving {rounds['reserving']} (pair engine {pair_rounds['reserving']}); "
        f"run_batch wall greedy {walls['greedy']:.4f} s, reserving "
        f"{walls['reserving']:.4f} s")
    log(f"{label} jax engine: launches {json.dumps(counts)} (event_resolve "
        f"expected {total} = flow-calendar rounds of both disciplines; "
        f"pair_resolve 0; port_stats {expect_ps})")

    for d in ("greedy", "reserving"):
        cpu = get_pipeline("ours", discipline=d, circuit_engine="jax").run_batch(
            instances, sols, validate=True, device="cpu"
        )
        for b, (g, c) in enumerate(zip(results[d], cpu)):
            check_same_schedule(f"{label} jax engine GPU vs CPU {d} instance {b}", g, c)
    log(f"{label} jax engine: GPU and CPU runs bit-identical (both disciplines)")
    return counts, results


def stage_times(torch, label, instances):
    """Stage-by-stage wall times of the main path (greedy discipline); the
    calendar under both engines, then both again in turns (kernel, jax,
    jax, kernel) to show the spread within this call."""
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
    flow = get_pipeline("ours", discipline="greedy", circuit_engine="jax").circuit_stage
    ens, t_build = timed(lambda: build_ensemble_batch(instances))
    comp = np.zeros(tuple(ens.weights.shape))
    for b, s in enumerate(sols):
        comp[b, : s.completion.shape[0]] = s.completion
    orders, t_order = timed(lambda: pipe.order_stage.order_batch(
        ens, torch.from_numpy(comp).cuda()))
    alloc, t_alloc = timed(lambda: pipe.allocate_stage.allocate_batch_arrays(ens, orders))
    calendars = dict(
        calendar=lambda: pipe.circuit_stage.schedule_batch_arrays(ens, alloc),
        calendar_jax=lambda: flow.schedule_batch_arrays(ens, alloc),
    )
    _, t_cal = timed(calendars["calendar"])
    _, t_cal_jax = timed(calendars["calendar_jax"])
    times = dict(pack=t_pack, lp=t_lp, build=t_build, order=t_order,
                 allocation=t_alloc, calendar=t_cal, calendar_jax=t_cal_jax)
    log(f"{label} stage seconds: " + json.dumps({k: round(v, 4) for k, v in times.items()}))
    turns = [timed(calendars[k])[1] for k in ("calendar", "calendar_jax",
                                               "calendar_jax", "calendar")]
    log(f"{label} calendar seconds in turns (kernel, jax, jax, kernel): "
        + ", ".join(f"{t:.4f}" for t in turns))

    # A traced pass: device busy share per stage (the LP at 100 steps),
    # device activity only (tens of thousands of kernels a window).
    traced = dict(
        lp_100_steps=lambda: lp.solve_subgradient_batch_arrays(arrays, iters=100),
        allocation=lambda: pipe.allocate_stage.allocate_batch_arrays(ens, orders),
        **calendars,
    )
    for name, fn in traced.items():
        wall, kernels = profile_device(torch, fn, cpu=False)
        if not kernels:
            log(f"{label} traced {name}: device busy share not measured "
                f"(the profiler saw no device activity)")
            continue
        busy_us = sum(t for t, _ in kernels.values())
        top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:3]
        lp_us, lp_n = (sum(v[i] for k, v in kernels.items() if "lp_terms_batch_kernel" in k)
                       for i in (0, 1))
        log(f"{label} traced {name}: wall {wall:.4f} s, device busy "
            f"{busy_us / 1e6:.4f} s ({100 * busy_us / 1e6 / wall:.1f} %), "
            f"{sum(c for _, c in kernels.values())} device kernels; top: "
            + "; ".join(f"{k[:60]} {t / 1e3:.2f} ms x{c}" for k, (t, c) in top)
            + (f"; lp_terms_batch {lp_us / 1e3:.3f} ms x{lp_n}" if lp_n else ""))
    return times


def check_same_schedule(ctx, g, c):
    """Two `ScheduleResult`s bit-identical: order, core of each flow,
    prefix bounds, establish and complete times (where kept), CCTs."""
    check(np.array_equal(g.order, c.order), f"{ctx}: orders differ")
    check(np.array_equal(g.allocation.core, c.allocation.core),
          f"{ctx}: core choices differ")
    check(np.array_equal(g.allocation.prefix_lb, c.allocation.prefix_lb),
          f"{ctx}: prefix bounds differ")
    check((g.core_schedules is None) == (c.core_schedules is None),
          f"{ctx}: one run kept its schedules, the other not")
    for k, (sg, sc) in enumerate(zip(g.core_schedules or [], c.core_schedules or [])):
        check(np.array_equal(sg.establish, sc.establish),
              f"{ctx} core {k}: establish times differ")
        check(np.array_equal(sg.complete, sc.complete),
              f"{ctx} core {k}: complete times differ")
    check(np.array_equal(g.ccts, c.ccts), f"{ctx}: CCTs differ")


def phase_parity(label, instances, sols):
    """Injected LP: GPU and CPU runs must agree bit for bit."""
    from repro_torch.pipeline import get_pipeline

    for d in ("greedy", "reserving"):
        pipe = get_pipeline("ours", discipline=d)
        gpu = pipe.run_batch(instances, sols, validate=True, device="cuda")
        cpu = pipe.run_batch(instances, sols, validate=True, device="cpu")
        for b, (g, c) in enumerate(zip(gpu, cpu)):
            check_same_schedule(f"{label} {d} instance {b}", g, c)
    log(f"{label}: GPU and CPU runs with injected LP bit-identical "
        f"(orders, cores, establish/complete, CCTs; both disciplines)")


# ---------------------------------------------------------------------------
# Phase 5: per-instance ours solving its own LP
# ---------------------------------------------------------------------------


def phase_per_instance(torch, subgradient_insts, exact_insts):
    """`Pipeline.run` per instance, the LP solved inside it: the
    subgradient solver on the card (the `lp_terms` kernel) and HiGHS on
    the host.  Each instance is solved once, under the first discipline;
    the second discipline's run is given that solution."""
    from repro_torch.core.theory import certify
    from repro_torch.pipeline import batch_circuit, get_pipeline

    def run(inst, discipline, lp_method="exact", sol=None):
        pipe = get_pipeline("ours", discipline=discipline, lp_method=lp_method,
                            lp_iters=LP_ITERS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = pipe.run(inst, lp_solution=sol, validate=True)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    def timing(label, what, res, wall):
        log(f"per-instance {label}: run with {what} {wall:.4f} s, of which "
            f"allocation + calendar {res.wall_time_s:.4f} s and LP solve + "
            f"ensemble build + order {wall - res.wall_time_s:.4f} s")

    reset_counts()
    runs = []  # (label, LP method, instance, discipline, result)
    for label, inst in subgradient_insts:
        res, wall = run(inst, "greedy", "subgradient")
        timing(label, f"subgradient LP ({LP_ITERS} iterations)", res, wall)
        runs.append((label, "subgradient", inst, "greedy", res))
        res, _ = run(inst, "reserving", sol=res.lp)
        runs.append((label, "subgradient", inst, "reserving", res))
    for label, inst in exact_insts:
        res, wall = run(inst, "reserving", "exact")
        timing(label, "exact LP (HiGHS)", res, wall)
        runs.append((label, "exact", inst, "reserving", res))
        res, wall = run(inst, "greedy", sol=res.lp)
        timing(label, "the exact LP given", res, wall)
        runs.append((label, "exact", inst, "greedy", res))
    counts = read_counts()
    rounds = batch_circuit.ROUNDS["kernel"]

    exact = {label: res.lp for label, m, _, _, res in runs if m == "exact"}
    for label, method, inst, d, res in runs:
        ctx = f"per-instance {label} {method} {d}"
        opt = exact[label].objective
        limit = (8 * inst.num_cores + 1) * opt
        check(np.isfinite(res.ccts).all() and res.ccts.shape == (inst.num_coflows,),
              f"{ctx}: bad CCT vector")
        check(res.total_weighted_cct <= limit,
              f"{ctx}: weighted CCT {res.total_weighted_cct} > (8K+1) x exact LP {limit}")
        if method == "subgradient":
            gap = res.lp.objective / opt
            check(1 - 1e-4 <= gap <= 1.005,
                  f"{ctx}: subgradient objective {res.lp.objective} is {gap} x "
                  f"the exact optimum {opt}, outside [1 - 1e-4, 1.005]")
            log(f"{ctx}: subgradient objective / exact optimum {gap:.6f}; "
                f"weighted CCT / exact LP {res.total_weighted_cct / opt:.4f}")
            continue
        rep = certify(inst, res.order, res.lp.completion, res.allocation, res.ccts)
        check(rep.approx_ratio <= rep.bound,
              f"{ctx}: approx ratio {rep.approx_ratio} > bound {rep.bound}")
        if d == "reserving":
            check(rep.ok(), f"{ctx}: certificate fails: {rep}")
        log(f"{ctx}: approx ratio {rep.approx_ratio:.4f} (bound {rep.bound}); "
            f"certificate ok() {rep.ok()}; Lemma 5 factor {rep.lemma5_factor:.3f}")

    n_solves = len(subgradient_insts)
    expect_lp = n_solves * (LP_ITERS + 2)
    # One port_stats launch per subgradient solve and per run's ensemble
    # build (one instance, one port count).
    expect_ps = n_solves + len(runs)
    check(counts["lp_terms"] == expect_lp,
          f"per-instance: lp_terms launched {counts['lp_terms']} times, "
          f"expected {expect_lp}")
    check(counts["lp_terms_batch"] == 0,
          f"per-instance: lp_terms_batch launched {counts['lp_terms_batch']} times, "
          f"expected 0")
    check(counts["port_stats"] == expect_ps,
          f"per-instance: port_stats launched {counts['port_stats']} times, "
          f"expected {expect_ps}")
    check(counts["pair_resolve"] == rounds > 0,
          f"per-instance: pair_resolve launched {counts['pair_resolve']} times, "
          f"expected {rounds} (one per calendar round)")
    log(f"per-instance: launches {json.dumps(counts)} (lp_terms expected "
        f"{expect_lp} = {n_solves} solves x ({LP_ITERS} steps + start + "
        f"result); port_stats expected {expect_ps} = {n_solves} solves + "
        f"{len(runs)} runs; pair_resolve expected {rounds} = calendar rounds)")

    # The same LP solutions on the CPU: bit-identical schedules.
    for label, method, inst, d, res in runs:
        cpu = get_pipeline("ours", discipline=d).run(
            inst, lp_solution=res.lp, validate=True, device="cpu"
        )
        check_same_schedule(f"per-instance {label} {method} {d}", res, cpu)
    log(f"per-instance: {len(runs)} runs validated; GPU and CPU runs with the "
        f"same LP solution bit-identical (orders, cores, establish/complete, CCTs)")
    return counts, runs


def phase_per_instance_flow(torch, runs, labels):
    """``get_pipeline("ours", circuit_engine="jax").run(inst, sol)`` (greedy,
    the exact LP given) on the ``labels`` instances of phase 5, each
    bit-identical to the kernel engine's run; launches counted apart.
    Returns label -> (instance, result)."""
    from repro_torch.pipeline import batch_circuit, get_pipeline

    given = {label: (inst, res) for label, m, inst, d, res in runs
             if m == "exact" and d == "greedy"}
    reset_counts()
    out = {}
    for label in labels:
        inst, want = given[label]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = get_pipeline("ours", circuit_engine="jax").run(inst, want.lp)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check_same_schedule(f"per-instance {label} jax engine vs kernel engine", got, want)
        log(f"per-instance {label}: run with the exact LP given, circuit_engine="
            f"\"jax\": {wall:.4f} s, of which allocation + calendar "
            f"{got.wall_time_s:.4f} s (kernel engine {want.wall_time_s:.4f} s); "
            f"bit-identical to the kernel engine's run")
        out[label] = (inst, got)
    counts = read_counts()
    rounds = batch_circuit.ROUNDS
    check(counts["event_resolve"] == rounds["jax"] > 0,
          f"per-instance jax engine: event_resolve launched {counts['event_resolve']} "
          f"times, expected {rounds['jax']} (one per flow-calendar round)")
    check(counts["pair_resolve"] == rounds["kernel"] == 0,
          f"per-instance jax engine: pair_resolve launched {counts['pair_resolve']} times")
    log(f"per-instance jax engine: launches {json.dumps(counts)} (event_resolve "
        f"expected {rounds['jax']} = flow-calendar rounds)")
    return out


# ---------------------------------------------------------------------------
# Phase 6: serving gemma3-1b at full width through the flash kernel
# ---------------------------------------------------------------------------


def bf16_units(torch, x):
    """Spacing of bf16 values at the magnitude of ``x`` (2**-7 of the
    power of two at or below it)."""
    return 2.0 ** (int(torch.floor(torch.log2(x.abs().max().float()))) - 7)


def phase_serving(torch):
    """`serve` on gemma3-1b at full width, with launch counts, then the
    teacher-forcing check, card against host on a reduced model, and one
    profiled decode tick."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import serve
    from repro_torch.models.model import build_model, param_bytes, param_count

    cfg = get_arch("gemma3-1b")
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(SERVE["seed"]))
    torch.cuda.synchronize()
    log(f"serving {cfg.name}: {param_count(params)} parameters, "
        f"{param_bytes(params) / 1e9:.3f} GB held (bf16 matrices, f32 norms), "
        f"init {time.perf_counter() - t0:.2f} s")
    # One warm-up wave (cuBLAS handles, allocator), outside the counted run.
    serve(cfg, params, **{**SERVE, "requests": 1, "max_new": 1})

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    res = serve(cfg, params, **SERVE)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()

    n_req, new = SERVE["requests"], SERVE["max_new"]
    waves = -(-n_req // SERVE["slots"])
    check((res.waves, res.ticks, res.tokens) == (waves, waves * new, n_req * new),
          f"serve: waves/ticks/tokens {res.waves}/{res.ticks}/{res.tokens}")
    for rid, toks in res.produced.items():
        check(len(toks) == new and all(0 <= t < cfg.vocab_size for t in toks),
              f"serve: request {rid} got {toks}")
    for w, wave in enumerate(res.logits):
        for lg in wave:
            check(lg.shape[-1] == cfg.vocab_size and bool(torch.isfinite(lg).all()),
                  f"serve: wave {w} logits not finite or of the wrong shape")
    expect = res.waves * (1 + new) * cfg.num_layers
    check(counts["flash_attention"] == expect,
          f"serve: flash_attention launched {counts['flash_attention']} times, "
          f"expected {expect} = waves x (1 + max_new) x layers")
    others = {k: v for k, v in counts.items() if k != "flash_attention"}
    check(not any(others.values()), f"serve: other kernels launched {others}")
    ticks_ms = sorted(1e3 * t for t in res.tick_s)
    log(f"serving {cfg.name}: {n_req} requests x {new} tokens, prompts of "
        f"{SERVE['prompt_len']}, {SERVE['slots']} slots: {res.waves} waves, "
        f"{res.ticks} ticks, {res.tokens} tokens in {res.seconds:.4f} s "
        f"({res.tokens / res.seconds:.2f} tokens/s)")
    log(f"serving {cfg.name}: prefill s per wave {[round(t, 4) for t in res.prefill_s]}; "
        f"decode ms per tick median {statistics.median(ticks_ms):.3f} "
        f"(min {ticks_ms[0]:.3f}, max {ticks_ms[-1]:.3f}); peak device memory "
        f"{peak / 1e9:.3f} GB (torch.cuda.max_memory_allocated)")
    log(f"serving {cfg.name}: launches {json.dumps(counts)} (flash_attention "
        f"expected {expect} = {res.waves} waves x (1 + {new}) x {cfg.num_layers} layers)")
    log(f"serving {cfg.name}: greedy tokens of request 0: {res.produced[0]}")

    # Decode after a prefill of P - 1 tokens against the teacher-forced
    # forward over all P: cache writes and the kernel's q_offset.  bf16
    # rounds at other places on the two routes (products of other shapes),
    # so the bound is 4 bf16 units at the largest logit.
    P = SERVE["prompt_len"]
    rng = np.random.default_rng(SERVE["seed"] + 1)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (SERVE["slots"], P))).cuda()
    with torch.inference_mode():
        full, _ = model.forward(params, {"tokens": tokens})
        want = full[:, -1].float()
        del full
        cache = model.init_cache(SERVE["slots"], P)
        _, cache = model.forward(params, {"tokens": tokens[:, : P - 1]}, cache=cache, pos=0)
        got, _ = model.decode_step(params, cache, {"tokens": tokens[:, P - 1 :]}, P - 1)
    diff = (got.float() - want).abs()
    tol = 4 * bf16_units(torch, want)
    check(bool((diff <= tol).all()),
          f"teacher forcing: decode differs from forward by {float(diff.max())} > {tol}")
    log(f"teacher forcing ({SERVE['slots']} x {P} tokens): decode vs forward max abs "
        f"{float(diff.max()):.4g}, mean {float(diff.mean()):.4g}, bound {tol:.4g} "
        f"(4 bf16 units at |logit| max {float(want.abs().max()):.4g}); argmax equal "
        f"in {int((got.argmax(-1) == want.argmax(-1)).sum())} of {SERVE['slots']} rows")

    # Card against host: a reduced gemma3 in f32, the same parameters.
    small = get_arch("gemma3-1b").reduced(vocab_size=512, compute_dtype="float32")
    host = build_model(small, "cpu")
    p_cpu = host.init(torch.Generator().manual_seed(0))
    p_gpu = build_model(small).cast(p_cpu)
    kw = dict(slots=4, requests=8, prompt_len=40, max_new=8, seed=0)
    on_card = serve(small, p_gpu, **kw)
    on_host = serve(small, p_cpu, device="cpu", **kw)
    check(on_card.produced == on_host.produced,
          "card and host serve different greedy tokens (reduced gemma3, f32)")
    worst = max(
        float((a.cpu() - b).abs().max())
        for wa, wb in zip(on_card.logits, on_host.logits) for a, b in zip(wa, wb)
    )
    check(worst <= 2e-4, f"card vs host logits differ by {worst} > 2e-4")
    log(f"card vs host (reduced gemma3, f32, {kw['requests']} requests x "
        f"{kw['max_new']} tokens, prompts of {kw['prompt_len']} past the window of "
        f"{small.window_size}): identical greedy tokens, logits max abs diff {worst:.3g} "
        f"(bound 2e-4)")

    # One decode tick profiled, on a cache filled by a prefill of P tokens.
    with torch.inference_mode():
        cache = model.init_cache(SERVE["slots"], P + 1)
        logits, cache = model.forward(params, {"tokens": tokens}, cache=cache, pos=0)
        step = logits[:, -1].argmax(-1, keepdim=True)
        del logits

        def tick():
            lg, _ = model.decode_step(params, cache, {"tokens": step}, P)
            lg.argmax(-1).cpu()

        tick()
        wall, kernels = profile_device(torch, tick)
    busy = sum(t for t, _ in kernels.values())
    by = {"flash_attention": 0.0, "matmul (cuBLAS)": 0.0, "other": 0.0}
    for name, (us, _) in kernels.items():
        if "flash_attention_kernel" in name:  # _mma, the runs and _combine
            by["flash_attention"] += us
        elif any(w in name.lower() for w in ("gemm", "gemv", "cutlass", "sm90_xmma", "nvjet")):
            by["matmul (cuBLAS)"] += us
        else:
            by["other"] += us
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:5]
    log(f"profiled decode tick: wall {1e3 * wall:.3f} ms, device busy "
        f"{busy / 1e3:.3f} ms ({100 * busy / 1e6 / wall:.1f} %), "
        f"{sum(c for _, c in kernels.values())} device kernels; by kind (ms): "
        + json.dumps({k: round(v / 1e3, 4) for k, v in by.items()}))
    log("profiled decode tick top: " + "; ".join(
        f"{k[:70]} {t / 1e3:.4f} ms x{c}" for k, (t, c) in top))
    return counts


# ---------------------------------------------------------------------------
# Phase 7: serving xlstm-1.3b at full width through the mLSTM kernel
# ---------------------------------------------------------------------------


def phase_serving_xlstm(torch):
    """`serve` on xlstm-1.3b at full width, with launch counts; the sLSTM
    loop's share of a prefill; teacher forcing; card against host on a
    reduced f32 xLSTM; one profiled decode tick."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import serve
    from repro_torch.models import xlstm as X
    from repro_torch.models.model import build_model, param_bytes, param_count

    cfg = get_arch("xlstm-1.3b")
    n_mlstm = cfg.layer_kinds.count("mlstm")
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(SERVE["seed"]))
    torch.cuda.synchronize()
    log(f"serving {cfg.name}: {param_count(params)} parameters, "
        f"{param_bytes(params) / 1e9:.3f} GB held (bf16 matrices, f32 norms and "
        f"sLSTM r), init {time.perf_counter() - t0:.2f} s; layers "
        f"{n_mlstm} mLSTM + {cfg.layer_kinds.count('slstm')} sLSTM")
    # One warm-up wave (cuBLAS handles, allocator), outside the counted run.
    serve(cfg, params, **{**SERVE, "requests": 1, "max_new": 1})

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    res = serve(cfg, params, **SERVE)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()

    n_req, new = SERVE["requests"], SERVE["max_new"]
    waves = -(-n_req // SERVE["slots"])
    check((res.waves, res.ticks, res.tokens) == (waves, waves * new, n_req * new),
          f"xlstm serve: waves/ticks/tokens {res.waves}/{res.ticks}/{res.tokens}")
    for rid, toks in res.produced.items():
        check(len(toks) == new and all(0 <= t < cfg.vocab_size for t in toks),
              f"xlstm serve: request {rid} got {toks}")
    for w, wave in enumerate(res.logits):
        for lg in wave:
            check(lg.shape[-1] == cfg.vocab_size and bool(torch.isfinite(lg).all()),
                  f"xlstm serve: wave {w} logits not finite or of the wrong shape")
    expect = res.waves * (1 + new) * n_mlstm
    check(counts["mlstm_chunk"] == expect,
          f"xlstm serve: mlstm_chunk launched {counts['mlstm_chunk']} times, "
          f"expected {expect} = waves x (1 + max_new) x mLSTM layers")
    others = {k: v for k, v in counts.items() if k != "mlstm_chunk"}
    check(not any(others.values()), f"xlstm serve: other kernels launched {others}")
    ticks_ms = sorted(1e3 * t for t in res.tick_s)
    log(f"serving {cfg.name}: {n_req} requests x {new} tokens, prompts of "
        f"{SERVE['prompt_len']}, {SERVE['slots']} slots: {res.waves} waves, "
        f"{res.ticks} ticks, {res.tokens} tokens in {res.seconds:.4f} s "
        f"({res.tokens / res.seconds:.2f} tokens/s)")
    log(f"serving {cfg.name}: prefill s per wave {[round(t, 4) for t in res.prefill_s]}; "
        f"decode ms per tick median {statistics.median(ticks_ms):.3f} "
        f"(min {ticks_ms[0]:.3f}, max {ticks_ms[-1]:.3f}); peak device memory "
        f"{peak / 1e9:.3f} GB (torch.cuda.max_memory_allocated)")
    log(f"serving {cfg.name}: launches {json.dumps(counts)} (mlstm_chunk expected "
        f"{expect} = {res.waves} waves x (1 + {new}) x {n_mlstm} mLSTM layers)")
    log(f"serving {cfg.name}: greedy tokens of request 0: {res.produced[0]}")

    # One prefill wave again, each sLSTM layer timed between synchronizes:
    # the host-bound loop's share of the wave.  Its logits are the
    # teacher-forced forward over all P tokens.
    P = SERVE["prompt_len"]
    rng = np.random.default_rng(SERVE["seed"] + 1)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (SERVE["slots"], P))).cuda()
    slstm_s = []
    slstm_apply = X.slstm_apply

    def timed_slstm(*args, **kwargs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = slstm_apply(*args, **kwargs)
        torch.cuda.synchronize()
        slstm_s.append(time.perf_counter() - t)
        return out

    X.slstm_apply = timed_slstm
    try:
        with torch.inference_mode():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cache = model.init_cache(SERVE["slots"], P + 1)
            logits, cache = model.forward(params, {"tokens": tokens}, cache=cache, pos=0)
            want = logits[:, -1].float()
            want.argmax(-1).cpu()
            wall = time.perf_counter() - t0
            del logits
    finally:
        X.slstm_apply = slstm_apply
    states = [c for c, kind in zip(cache, cfg.layer_kinds) if kind == "mlstm"]
    s_max = max(float(S.abs().max()) for S, _ in states)
    n_max = max(float(n.abs().max()) for _, n in states)
    check(all(bool(torch.isfinite(S).all() and torch.isfinite(n).all()) for S, n in states),
          "xlstm prefill: a carried mLSTM state is not finite")
    log(f"prefill wave ({SERVE['slots']} x {P} tokens, synchronized per sLSTM layer): "
        f"{wall:.4f} s, of which the {len(slstm_s)} sLSTM layers {sum(slstm_s):.4f} s "
        f"({100 * sum(slstm_s) / wall:.1f} %, {P} steps each); largest |S| of the "
        f"carried mLSTM states {s_max:.4g}, largest |n| {n_max:.4g}")

    # Decode after a prefill of P - 1 tokens against the teacher-forced
    # forward: the carried state through the kernel at S = C = 1.  Gated in
    # f32 on the same weights, within 1e-3 of the largest logit, and in
    # bf16 on the served weights of the first unit (8 layers: 7 mLSTM, 1
    # sLSTM), within 4 bf16 units of the largest logit as for gemma3.  Over
    # all 48 layers one bf16 rounding grows about 2**8 with random weights:
    # two equally valid forwards, chunks of 256 and of 128, differ by more
    # than the decode does, so that gap is logged beside that spread.
    def decode_after_prefill(m, p):
        short = m.init_cache(SERVE["slots"], P)
        _, short = m.forward(p, {"tokens": tokens[:, : P - 1]}, cache=short, pos=0)
        got, _ = m.decode_step(p, short, {"tokens": tokens[:, P - 1 :]}, P - 1)
        return got.float()

    unit = len(cfg.layer_unit)
    with torch.inference_mode():
        model8 = build_model(dataclasses.replace(cfg, num_layers=unit))
        params8 = {**params, "layers": params["layers"][:unit]}
        want8 = model8.forward(params8, {"tokens": tokens})[0][:, -1].float()
        got8 = decode_after_prefill(model8, params8)
        del params8
        got = decode_after_prefill(model, params)
        halves = build_model(dataclasses.replace(cfg, mlstm_chunk=128))
        other = halves.forward(params, {"tokens": tokens})[0][:, -1].float()
        model32 = build_model(dataclasses.replace(cfg, compute_dtype="float32"))
        p32 = model32.cast(params)
        logits32 = model32.forward(p32, {"tokens": tokens})[0]
        want32 = logits32[:, -1].clone()
        del logits32
        got32 = decode_after_prefill(model32, p32)
        del p32
    diff32 = float((got32 - want32).abs().max())
    tol32 = 1e-3 * float(want32.abs().max())
    check(diff32 <= tol32,
          f"xlstm teacher forcing (f32): decode differs from forward by {diff32} > {tol32}")
    diff8 = float((got8 - want8).abs().max())
    tol8 = 4 * bf16_units(torch, want8)
    check(diff8 <= tol8,
          f"xlstm teacher forcing (bf16, first {unit} layers): decode differs from "
          f"forward by {diff8} > {tol8}")
    diff = (got - want).abs()
    log(f"xlstm teacher forcing ({SERVE['slots']} x {P} tokens), bf16 served weights of "
        f"the first {unit} layers: decode vs forward max abs {diff8:.4g}, bound {tol8:.4g} "
        f"(4 bf16 units at |logit| max {float(want8.abs().max()):.4g}); argmax equal in "
        f"{int((got8.argmax(-1) == want8.argmax(-1)).sum())} of {SERVE['slots']} rows")
    log(f"xlstm teacher forcing ({SERVE['slots']} x {P} tokens), f32 weights of the served "
        f"model: decode vs forward max abs {diff32:.4g}, bound {tol32:.4g} (1e-3 of |logit| "
        f"max {float(want32.abs().max()):.4g}); argmax equal in "
        f"{int((got32.argmax(-1) == want32.argmax(-1)).sum())} of {SERVE['slots']} rows")
    log(f"xlstm teacher forcing, bf16 (served): decode vs forward max abs "
        f"{float(diff.max()):.4g}, mean {float(diff.mean()):.4g} at |logit| max "
        f"{float(want.abs().max()):.4g} (4 bf16 units: {4 * bf16_units(torch, want):.4g}); "
        f"forward with chunks of 128 vs 256 max abs {float((other - want).abs().max()):.4g}; "
        f"argmax equal in {int((got.argmax(-1) == want.argmax(-1)).sum())} of "
        f"{SERVE['slots']} rows")

    # Card against host: a reduced xLSTM in f32, the same parameters.
    small = get_arch("xlstm-1.3b").reduced(vocab_size=512, compute_dtype="float32",
                                           mlstm_chunk=8)
    host = build_model(small, "cpu")
    p_cpu = host.init(torch.Generator().manual_seed(0))
    p_gpu = build_model(small).cast(p_cpu)
    kw = dict(slots=4, requests=8, prompt_len=36, max_new=8, seed=0)
    on_card = serve(small, p_gpu, **kw)
    on_host = serve(small, p_cpu, device="cpu", **kw)
    check(on_card.produced == on_host.produced,
          "card and host serve different greedy tokens (reduced xLSTM, f32)")
    worst = max(
        float((a.cpu() - b).abs().max())
        for wa, wb in zip(on_card.logits, on_host.logits) for a, b in zip(wa, wb)
    )
    check(worst <= 2e-4, f"xlstm card vs host logits differ by {worst} > 2e-4")
    log(f"card vs host (reduced xLSTM, f32, mlstm_chunk {small.mlstm_chunk}, "
        f"{kw['requests']} requests x {kw['max_new']} tokens, prompts of "
        f"{kw['prompt_len']}): identical greedy tokens, logits max abs diff "
        f"{worst:.3g} (bound 2e-4)")

    # One decode tick profiled, on the state of the prefill of P tokens.
    with torch.inference_mode():
        step = want.argmax(-1, keepdim=True)

        def tick():
            lg, _ = model.decode_step(params, list(cache), {"tokens": step}, P)
            lg.argmax(-1).cpu()

        tick()
        wall, kernels = profile_device(torch, tick)
    busy = sum(t for t, _ in kernels.values())
    by = {"mlstm_chunk stream": 0.0, "mlstm_chunk mma": 0.0, "mlstm_chunk simt": 0.0,
          "matmul (cuBLAS)": 0.0, "other": 0.0}
    for name, (us, _) in kernels.items():
        if "mlstm_chunk_kernel" in name:
            route = ("stream" if "_stream" in name else
                     "mma" if "_mma" in name or "_scan" in name else "simt")
            by[f"mlstm_chunk {route}"] += us
        elif any(w in name.lower() for w in ("gemm", "gemv", "cutlass", "sm90_xmma", "nvjet")):
            by["matmul (cuBLAS)"] += us
        else:
            by["other"] += us
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:5]
    log(f"xlstm profiled decode tick: wall {1e3 * wall:.3f} ms, device busy "
        f"{busy / 1e3:.3f} ms ({100 * busy / 1e6 / wall:.1f} %), "
        f"{sum(c for _, c in kernels.values())} device kernels; by kind (ms): "
        + json.dumps({k: round(v / 1e3, 4) for k, v in by.items()}))
    log("xlstm profiled decode tick top: " + "; ".join(
        f"{k[:70]} {t / 1e3:.4f} ms x{c}" for k, (t, c) in top))
    return counts


# ---------------------------------------------------------------------------
# Phase 8: training gemma3-1b at full width with int8 gradient compression
# ---------------------------------------------------------------------------

TRAIN_ARGV = ["--arch", "gemma3-1b", "--full-config", "--compress-grads", "--batch", "4",
              "--seq", "1024", "--steps", "3", "--log-every", "1", "--plan-collectives"]
# One quantization step of the row's scale, plus the f32 roundings of
# x / scale, of + noise, of q * scale and of the residual: at |x / scale|
# up to 127 each is at most 2**-18 of the scale (PERF.md, section 6).
EF_BOUND = 1 + 2**-16


def row_scales(torch, g32):
    """The quantizer's per-row scales of a flat f32 leaf in rows of 512."""
    from repro_torch.kernels.quant import CHUNK, flat_rows

    n = g32.numel()
    rows = flat_rows(n)
    xp = torch.nn.functional.pad(g32.reshape(-1), (0, rows * CHUNK - n)).view(rows, CHUNK)
    amax = xp.abs().amax(dim=1)
    return torch.clamp(amax / torch.full_like(amax, 127.0), min=1e-30), rows


def check_plan(torch, params, cplan):
    """The trainer's collective plan: it covers every bucket of the
    parameter tree, schedules every flow once, ships the better of ours and
    FIFO, and equals `plan(..., device="cpu")` on the same buckets."""
    from repro_torch.collectives.planner import buckets_from_params, plan

    buckets = buckets_from_params(params, bucket_bytes=16 << 20)
    names = {b.name for b in buckets}
    check(cplan is not None and set(cplan.order) == names and len(cplan.order) == len(names),
          "train --plan-collectives: the plan does not cover every bucket")
    n_flows = sum(len(v) for v in cplan.plane_of_flow.values())
    check(n_flows == int((cplan.instance.demands > 0).sum()),
          f"train --plan-collectives: {n_flows} flows scheduled, "
          f"{int((cplan.instance.demands > 0).sum())} in the instance")
    check(cplan.chosen_weighted <= cplan.total_weighted_fifo,
          "train --plan-collectives: the chosen plan is worse than FIFO")
    t0 = time.perf_counter()
    host = plan(buckets, num_pods=2, device="cpu")
    host_s = time.perf_counter() - t0
    same = (host.order == cplan.order and host.plane_of_flow == cplan.plane_of_flow
            and all(getattr(host, f) == getattr(cplan, f) for f in (
                "cct_ours", "cct_fifo", "total_weighted_ours", "total_weighted_fifo", "chosen")))
    check(same, "train --plan-collectives: the card's plan differs from plan(device='cpu')")
    log(f"planner: {len(buckets)} gradient buckets of 16 MB over 2 pods x 4 planes, "
        f"{n_flows} flows each scheduled once; weighted CCT ours "
        f"{cplan.total_weighted_ours:.6f} vs FIFO {cplan.total_weighted_fifo:.6f}, chosen "
        f"{cplan.chosen}; CCT ours {cplan.cct_ours:.6f} ms vs FIFO {cplan.cct_fifo:.6f} ms; "
        f"the same plan from plan(device='cpu') ({host_s:.4f} s on the host)")


def phase_training(torch):
    """``repro_torch.launch.train.main`` on gemma3-1b at full width with
    ``--compress-grads --plan-collectives``: the collective plan
    (`check_plan`; the planner's calendar launches `pair_resolve` once per
    round); launch counts, gradients on every leaf, the error feedback
    within one quantization step; timings, the exchange's share and peak
    memory; one more step profiled; then card against host on a reduced
    f32 gemma3 with the same host-drawn noise."""
    from repro_torch import tree
    from repro_torch.pipeline import batch_circuit
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import SyntheticTokens, make_batch_iterator
    from repro_torch.launch import train as T
    from repro_torch.launch.steps import make_compressed_step
    from repro_torch.models.model import build_model
    from repro_torch.optim.adamw import AdamW, cosine_schedule

    cfg = get_arch("gemma3-1b")
    seen = {"leaves": set(), "worst_ef": 0.0, "steps": 0, "peaks": []}

    def inspect(step, grads, errors, new_errors):
        # The step's peak so far; the checks' own temporaries are left out.
        seen["peaks"].append(torch.cuda.max_memory_allocated())
        leaves = tree.leaves(grads)
        seen["leaves"].add(len(leaves))
        seen["steps"] += 1
        for i, (g, e, e_new) in enumerate(zip(leaves, tree.leaves(errors),
                                               tree.leaves(new_errors))):
            check(bool(torch.isfinite(g).all()), f"train step {step}: leaf {i} gradient not finite")
            check(bool(g.any()), f"train step {step}: leaf {i} ({tuple(g.shape)}) gradient is zero")
            scale, rows = row_scales(torch, g.float() + e)
            ratio = torch.nn.functional.pad(e_new.reshape(-1).abs(),
                                            (0, rows * 512 - e_new.numel())).view(rows, 512)
            ratio = float((ratio / scale[:, None]).max())
            seen["worst_ef"] = max(seen["worst_ef"], ratio)
            check(ratio <= EF_BOUND, f"train step {step}: leaf {i} error feedback "
                  f"{ratio} quantization steps > {EF_BOUND}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    res = T.main(TRAIN_ARGV, inspect=inspect)
    wall = time.perf_counter() - t0
    counts = read_counts()
    peak = max(seen["peaks"] + [torch.cuda.max_memory_allocated()])

    steps = len(res.losses)
    leaves = len(tree.leaves(res.params))
    check(seen["leaves"] == {leaves} and seen["steps"] == steps,
          f"train: inspected {seen} for {leaves} leaves and {steps} steps")
    check(all(np.isfinite(res.losses)), f"train: losses {res.losses}")
    want = dict(quantize=steps * leaves, dequantize=2 * steps * leaves,
                flash_attention=steps * cfg.num_layers)
    # The planner: one ensemble build (one port count) and its calendar.
    planner = dict(port_stats=1, pair_resolve=batch_circuit.ROUNDS["kernel"])
    check(planner["pair_resolve"] > 0, "train: the planner ran no calendar round")
    for name, n in {**want, **planner}.items():
        check(counts[name] == n, f"train: {name} launched {counts[name]} times, expected {n}")
    others = {k: v for k, v in counts.items() if k not in want and k not in planner}
    check(not any(others.values()), f"train: other kernels launched {others}")
    check_plan(torch, res.params, res.plan)
    batch, seq = 4, 1024
    log(f"training {cfg.name} (full width, {leaves} leaves, f32 masters), batch {batch} x "
        f"{seq} tokens, {steps} compressed steps in {wall:.3f} s (init and data included)")
    for i, (loss, dt, ex) in enumerate(zip(res.losses, res.step_s, res.exchange_s)):
        log(f"train step {i}: loss {loss:.6f} gnorm {res.grad_norms[i]:.4f} "
            f"{1e3 * dt:.3f} ms ({batch * seq / dt:.1f} tokens/s), compressed exchange "
            f"{1e3 * ex:.3f} ms ({100 * ex / dt:.1f} % of the step)")
    log(f"training {cfg.name}: launches {json.dumps(counts)} (quantize = {steps} steps x "
        f"{leaves} leaves, dequantize twice that, flash_attention = {steps} x "
        f"{cfg.num_layers} layers; the planner's port_stats 1 and pair_resolve = its "
        f"{planner['pair_resolve']} calendar rounds); peak device memory {peak / 1e9:.3f} GB "
        f"(torch.cuda.max_memory_allocated, the checks' temporaries left out); every "
        f"leaf's gradient finite and nonzero; "
        f"error feedback at most {seen['worst_ef']:.7f} quantization steps (bound {EF_BOUND})")

    # One more step from the trained state through the trainer's own
    # compressed step, profiled.
    model = build_model(cfg)
    compressed_step = make_compressed_step(
        model, AdamW(schedule=cosine_schedule(3e-3, steps // 10 + 1, steps)))
    params, opt_state, errors = res.params, res.opt_state, res.error_feedback
    del res
    data = SyntheticTokens(cfg.vocab_size, seq, batch, seed=1).next_batch()

    def one_step():
        nonlocal params, opt_state, errors
        gen = torch.Generator(device="cuda").manual_seed(T.noise_seed(steps))
        params, opt_state, errors, _ = compressed_step(params, opt_state, errors, data, gen)

    wall, kernels = profile_device(torch, one_step)
    busy = sum(t for t, _ in kernels.values())
    by = {"flash_attention": 0.0, "quantize": 0.0, "dequantize": 0.0,
          "matmul (cuBLAS)": 0.0, "other": 0.0}
    for name, (us, _) in kernels.items():
        if "flash_attention_kernel" in name:  # _mma, the runs and _combine
            by["flash_attention"] += us
        elif "dequantize_kernel" in name:
            by["dequantize"] += us
        elif "quantize_kernel" in name:
            by["quantize"] += us
        elif any(w in name.lower() for w in ("gemm", "gemv", "cutlass", "sm90_xmma", "nvjet")):
            by["matmul (cuBLAS)"] += us
        else:
            by["other"] += us
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:6]
    log(f"profiled train step: wall {1e3 * wall:.3f} ms, device busy {busy / 1e3:.3f} ms "
        f"({100 * busy / 1e6 / wall:.1f} %), {sum(c for _, c in kernels.values())} device "
        f"kernels; by kind (ms): " + json.dumps({k: round(v / 1e3, 4) for k, v in by.items()}))
    log("profiled train step top: " + "; ".join(
        f"{k[:70]} {t / 1e3:.4f} ms x{c}" for k, (t, c) in top))
    del params, opt_state, errors, model
    torch.cuda.empty_cache()

    # Card against host: a reduced gemma3 in f32 (TF32 off), 3 steps of
    # the trainer's compressed step from the same weights and batches, with
    # the same noise drawn on the host from (7, step).  Step 0's gradients
    # come from identical weights: 1e-4 of each leaf's largest host value
    # (the CPU tests' bound against the reference).  Later steps start from
    # weights that differ by the f32 roundings of the earlier updates: 1e-3
    # of the leaf's largest value (PERF.md, section 6, holds the readings).
    # Losses within 1e-4.
    small = dataclasses.replace(T.config_for("gemma3-1b"), compute_dtype="float32")
    p_cpu = build_model(small, "cpu").init(torch.Generator().manual_seed(0), masters=True)
    runs = {}
    for dev in ("cuda", "cpu"):
        m = build_model(small, dev)
        p = m.cast(p_cpu, masters=True) if dev == "cuda" else p_cpu
        opt = AdamW(schedule=cosine_schedule(3e-3, 1, 3))
        step_fn, opt_state, errors = make_compressed_step(m, opt), opt.init(p), None
        data = make_batch_iterator(SyntheticTokens(small.vocab_size, 40, 2))
        run = runs[dev] = {"loss": [], "grads": []}
        try:
            for step in range(3):
                gen = torch.Generator().manual_seed(T.noise_seed(step))
                p, opt_state, errors, stats = step_fn(
                    p, opt_state, errors, next(data), gen,
                    lambda g, e, e_new, run=run: run["grads"].append(
                        [t.cpu() for t in tree.leaves(g)]))
                run["loss"].append(float(stats["loss"]))
        finally:
            data.close()
    for step, (gc, gh) in enumerate(zip(runs["cuda"]["grads"], runs["cpu"]["grads"])):
        rel = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                  for a, b in zip(gc, gh))
        bound = 1e-4 if step == 0 else 1e-3
        check(rel <= bound, f"card vs host step {step}: gradients differ by {rel} of a leaf's "
              f"largest value > {bound}")
        log(f"card vs host (reduced gemma3, f32) step {step}: gradients within {rel:.3g} of "
            f"each leaf's largest value (bound {bound}); losses {runs['cuda']['loss'][step]:.7f} "
            f"and {runs['cpu']['loss'][step]:.7f}")
    dl = max(abs(a - b) for a, b in zip(runs["cuda"]["loss"], runs["cpu"]["loss"]))
    check(dl <= 1e-4, f"card vs host losses differ by {dl} > 1e-4")
    return counts


# ---------------------------------------------------------------------------
# Phase 9: the paper's schemes and EPS through the pipeline
# ---------------------------------------------------------------------------

# The reference's Fig. 3 claims (its tests/test_baselines.py), gated on
# the means over the ensemble of each scheme's weighted CCT over ours'.
FIG3_GATES = dict(
    bvn_s=lambda r: r > 1.0,
    sunflow_s=lambda r: r > 1.0,
    load_only=lambda r: r > 0.95,
    wspt_order=lambda r: r < 1.3,
)
FIG3_TEXT = dict(bvn_s="> ours (1.0)", sunflow_s="> 1.0", load_only="> 0.95",
                 wspt_order="< 1.3")
LIST_SCHEMES = ("ours", "wspt_order", "load_only")


def timed_stages(torch, pipe):
    """Wrap ``pipe``'s stage calls in host-clock timers, each call between
    two synchronizes; returns the dict they add their seconds to: order
    (`order_batch`), allocation (the device scan), circuit (the batched
    calendar, or the sum of the host's per-instance schedules)."""
    times = dict(order=0.0, allocation=0.0, circuit=0.0)
    circuit = ("schedule_batch_arrays" if hasattr(pipe.circuit_stage, "schedule_batch_arrays")
               else "schedule")
    for stage, attr, key in ((pipe.order_stage, "order_batch", "order"),
                             (pipe.allocate_stage, "allocate_batch_arrays", "allocation"),
                             (pipe.circuit_stage, circuit, "circuit")):
        def timed(*args, _fn=getattr(stage, attr), _key=key, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _fn(*args, **kwargs)
            torch.cuda.synchronize()
            times[_key] += time.perf_counter() - t0
            return out

        setattr(stage, attr, timed)
    return times


def phase_schemes(torch, label, instances, sols, ours_results):
    """Every `PAPER_SCHEMES` entry through ``get_pipeline(s).run_batch(...,
    validate=True)`` on the card with the ensemble's LP solutions, counted
    alone: kept schedules validate, each weighted CCT is at least its LP
    objective / 1.005, the card's run is bit-identical to the host's,
    `pair_resolve` launches once per calendar round for the list circuits
    and neither calendar kernel launches for the host circuits; then a
    fig3-style table of the means over the ensemble (weighted CCT, p95 and
    p99 over ours') and each scheme's stage seconds in the card's run
    (`timed_stages`), and Fig. 3's claims gated on the means."""
    from repro_torch.core.scheduler import tail_cct
    from repro_torch.pipeline import PAPER_SCHEMES, batch_circuit, get_pipeline

    expect_ps = len({inst.num_ports for inst in instances})
    results, table = {}, {}
    for scheme in PAPER_SCHEMES:
        pipe = get_pipeline(scheme)
        stage_s = timed_stages(torch, pipe)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = results[scheme] = pipe.run_batch(instances, lp_solutions=sols, validate=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        stage_s = dict(stage_s)
        counts = read_counts()
        rounds = batch_circuit.ROUNDS["kernel"]
        for b, (inst, sol, r) in enumerate(zip(instances, sols, res)):
            check(r.total_weighted_cct >= sol.objective / 1.005,
                  f"{label} {scheme} instance {b}: weighted CCT {r.total_weighted_cct} "
                  f"below LP objective {sol.objective} / 1.005")
            check(np.isfinite(r.ccts).all() and r.ccts.shape == (inst.num_coflows,),
                  f"{label} {scheme} instance {b}: bad CCT vector")
            check((r.lp is None) == (scheme == "wspt_order"),
                  f"{label} {scheme} instance {b}: LP recorded wrongly")
        check(counts["port_stats"] == expect_ps,
              f"{label} {scheme}: port_stats launched {counts['port_stats']} times, "
              f"expected {expect_ps}")
        check(counts["lp_terms_batch"] == counts["lp_terms"] == 0,
              f"{label} {scheme}: LP kernels launched with the LP solutions given")
        check(counts["event_resolve"] == batch_circuit.ROUNDS["jax"] == 0,
              f"{label} {scheme}: event_resolve launched {counts['event_resolve']} times")
        if scheme in LIST_SCHEMES:
            check(counts["pair_resolve"] == rounds > 0,
                  f"{label} {scheme}: pair_resolve launched {counts['pair_resolve']} "
                  f"times, expected {rounds} (one per calendar round)")
        else:
            check(counts["pair_resolve"] == rounds == 0,
                  f"{label} {scheme}: pair_resolve launched {counts['pair_resolve']} "
                  f"times on a host circuit stage, expected 0")
        if scheme == "ours":
            for b, (r, want) in enumerate(zip(res, ours_results)):
                check_same_schedule(f"{label} ours vs phase 3 instance {b}", r, want)
        t0 = time.perf_counter()
        cpu = pipe.run_batch(instances, sols, validate=True, device="cpu")
        host_wall = time.perf_counter() - t0
        for b, (g, c) in enumerate(zip(res, cpu)):
            check_same_schedule(f"{label} {scheme} GPU vs CPU instance {b}", g, c)
        table[scheme] = dict(run_batch_s=wall, host_run_batch_s=host_wall,
                             pair_resolve=counts["pair_resolve"], stage_s=stage_s)
        log(f"{label} {scheme}: {len(instances)} instances, kept schedules valid, "
            f"weighted CCT >= LP / 1.005, GPU and CPU bit-identical; run_batch "
            f"{wall:.4f} s on the card ({host_wall:.4f} s on the host), its stage "
            f"seconds {json.dumps({k: round(v, 4) for k, v in stage_s.items()})}; "
            f"launches {json.dumps(counts)}")

    ours = results["ours"]
    for scheme in PAPER_SCHEMES:
        row = table[scheme]
        for key, fn in (("wcct", lambda r: r.total_weighted_cct),
                        ("p95", lambda r: tail_cct(r.ccts, 0.95)),
                        ("p99", lambda r: tail_cct(r.ccts, 0.99))):
            row[key] = float(np.mean([fn(r) / fn(o) for r, o in zip(results[scheme], ours)]))
        if scheme in FIG3_GATES:
            check(FIG3_GATES[scheme](row["wcct"]),
                  f"{label}: Fig. 3 claim {scheme} {FIG3_TEXT[scheme]} fails: mean "
                  f"normalized weighted CCT {row['wcct']}")
        log(f"{label} fig3 {scheme}: mean over {len(instances)} of weighted CCT / ours "
            f"{row['wcct']:.4f}, p95 / ours {row['p95']:.4f}, p99 / ours "
            f"{row['p99']:.4f}" + (f" (gate {FIG3_TEXT[scheme]})" if scheme in FIG3_GATES else ""))
    log(f"{label} fig3 table: " + json.dumps(table))
    return table, results


def phase_eps(torch, seeds, positive, positive_sol):
    """`eps` on paper-default instances with delta = 0 and the exact LP
    (HiGHS), through `run_eps` on the card and on the host: ratio within
    4H (+1), at least 1, CCTs bit-identical, no calendar kernel launched;
    `get_pipeline("eps")` refuses ``positive`` (delta > 0)."""
    from repro_torch.core import lp
    from repro_torch.core.eps import run_eps
    from repro_torch.pipeline import get_pipeline
    from repro_torch.traffic.instances import paper_default_instance

    t0 = time.perf_counter()
    reset_counts()
    ratios = []
    for seed in seeds:
        inst = dataclasses.replace(paper_default_instance(seed=seed), delta=0.0)
        sol = lp.solve_exact(inst)
        r = run_eps(inst, sol)
        c = run_eps(inst, sol, device="cpu")
        check(r.approx_ratio <= r.bound,
              f"eps seed {seed}: ratio {r.approx_ratio} > bound {r.bound}")
        check(r.approx_ratio >= 1.0 - 1e-9,
              f"eps seed {seed}: ratio {r.approx_ratio} below the LP lower bound")
        check(np.array_equal(r.ccts, c.ccts) and np.array_equal(r.order, c.order),
              f"eps seed {seed}: GPU and CPU runs differ")
        ratios.append(r.approx_ratio)
        log(f"eps seed {seed} (delta 0, exact LP): weighted CCT / LP {r.approx_ratio:.4f}, "
            f"bound {r.bound:.0f}; Theorem 2's per-coflow max(T - a - 4H T~) "
            f"{r.theorem2_percoflow_violation:.4g}; "
            f"GPU and CPU bit-identical")
    counts = read_counts()
    check(counts["pair_resolve"] == counts["event_resolve"] == 0,
          f"eps: calendar kernels launched {counts}")
    try:
        get_pipeline("eps").run(positive, positive_sol)
    except ValueError as e:
        check("delta == 0" in str(e), f"eps refused delta > 0 for another reason: {e}")
    else:
        raise AssertionError("eps ran an instance with delta > 0")
    log(f"eps: {len(ratios)} instances within 4H (+1), max ratio {max(ratios):.4f}; "
        f"delta > 0 refused; {time.perf_counter() - t0:.2f} s")


# ---------------------------------------------------------------------------
# Phase 10: ours_ls, the calendar's other executors
# ---------------------------------------------------------------------------


def lp_orders(torch, pipe, ens, sols):
    """(B, Mp) LP orders of ``pipe``'s order stage on the card's ``ens``."""
    comp = np.zeros(tuple(ens.weights.shape))
    for b, s in enumerate(sols):
        comp[b, : s.completion.shape[0]] = s.completion
    return pipe.order_stage.order_batch(ens, torch.from_numpy(comp).cuda())


def refine_stage_timers(torch, pipe):
    """Wrap ``pipe``'s array stages (allocation, the lean CCTs) in
    synchronized host-clock timers; returns the list each call appends
    ``(stage, members, seconds, output)`` to."""
    calls = []
    for stage, attr in ((pipe.allocate_stage, "allocate_batch_arrays"),
                        (pipe.circuit_stage, "cct_batch_arrays")):
        def timed(ens, arg, _fn=getattr(stage, attr), _name=attr):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _fn(ens, arg)
            torch.cuda.synchronize()
            calls.append((_name, ens.num_instances, time.perf_counter() - t0, out))
            return out

        setattr(stage, attr, timed)
    return calls


def refine_rounds(calls, instances, k, ours_obj, outcome):
    """Per-round figures of a batched search from its recorded CCT passes:
    candidate evaluations, instances improved, the mean refined / ours
    ratio after the round and the round's stage seconds.  The incumbents
    it replays must end at the outcome's objectives."""
    from repro_torch.core.localsearch import select_candidate

    rows, active = [], list(range(len(instances)))
    cur = np.array([np.nan] * len(instances))
    ccts = [c for c in calls if c[0] == "cct_batch_arrays"]
    allocs = [c for c in calls if c[0] == "allocate_batch_arrays" and c[1] == len(instances) * k]
    for (_, _, cal_s, cct), (_, _, alloc_s, _) in zip(ccts, allocs):
        improved = []
        for b in active:
            M, w = instances[b].num_coflows, instances[b].weights
            objs = np.array([float(np.dot(w, cct[b * k + c, :M])) for c in range(k)])
            win = select_candidate(objs)
            cur[b] = objs[win]
            if win:
                improved.append(b)
        rows.append(dict(evaluations=k * len(active), improved=len(improved),
                         mean_ratio=float(np.mean(cur / ours_obj)),
                         allocation_s=alloc_s, calendar_s=cal_s))
        active = improved
    check(np.array_equal(cur, outcome.objective),
          "refinement rounds replayed from the recorded CCTs end elsewhere than "
          "the outcome's objectives")
    return rows


def check_ours_ls(label, instances, sols, results, ours_results):
    """``ours_ls`` results: finite CCTs, never worse than ``ours``, within
    (8K+1) x the LP objective."""
    for b, (inst, sol, r, o) in enumerate(zip(instances, sols, results, ours_results)):
        check(np.isfinite(r.ccts).all() and r.ccts.shape == (inst.num_coflows,),
              f"{label} instance {b}: bad CCT vector")
        check(r.total_weighted_cct <= o.total_weighted_cct,
              f"{label} instance {b}: weighted CCT {r.total_weighted_cct} worse than "
              f"ours' {o.total_weighted_cct}")
        check(r.total_weighted_cct <= (8 * inst.num_cores + 1) * sol.objective,
              f"{label} instance {b}: weighted CCT beyond (8K+1) x LP")


def phase_refine(torch, instances, sols, ours_results, trace, trace_sols, trace_ours):
    """``ours_ls`` through ``get_pipeline("ours_ls").run_batch(...,
    require_batch=True)`` on the card, under the pair and then the flow
    calendar, each counted alone: the batched search ran, kept schedules
    validate, each weighted CCT is at most ours' (phase 3) and (8K+1) x
    its LP objective, both engines give the same bits, and the round
    kernel launched once per calendar round; the rounds logged (evaluations,
    instances improved, mean refined / ours ratio, stage seconds) and one
    profiled round's device busy time; card equal to host on the trace
    instances, and to `refine_sequential` through the host's per-instance
    stages (the ``"loop"`` backend) on four paper instances."""
    from repro_torch.core.scheduler import total_weighted_cct
    from repro_torch.pipeline import batch_circuit, build_ensemble_batch, get_pipeline
    from repro_torch.pipeline.refine import refine_batch_arrays
    from repro_torch.pipeline.spec import RefineSpec

    spec = RefineSpec()
    k = spec.candidates
    ours_obj = np.array([r.total_weighted_cct for r in ours_results])
    results, launches = {}, {}
    for engine, kernel in (("kernel", "pair_resolve"), ("jax", "event_resolve")):
        pipe = get_pipeline("ours_ls", circuit_engine=engine)
        calls = refine_stage_timers(torch, pipe) if engine == "kernel" else []
        cache = {}
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = results[engine] = pipe.run_batch(instances, sols, validate=True,
                                               require_batch=True, stage_cache=cache)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launches[engine] = read_counts()
        rounds = batch_circuit.ROUNDS[engine]
        (outcome,) = [v for key, v in cache.items() if isinstance(key, tuple) and key[0] == "refine"]
        check(outcome.batched, f"ours_ls {engine}: the search left the batched path")
        check_ours_ls(f"ours_ls {engine}", instances, sols, res, ours_results)
        check(counts[kernel] == rounds > 0,
              f"ours_ls {engine}: {kernel} launched {counts[kernel]} times, expected "
              f"{rounds} (one per calendar round)")
        other = "event_resolve" if kernel == "pair_resolve" else "pair_resolve"
        check(counts[other] == 0, f"ours_ls {engine}: {other} launched {counts[other]} times")
        check(counts["port_stats"] == len({i.num_ports for i in instances}),
              f"ours_ls {engine}: port_stats launched {counts['port_stats']} times "
              f"(expand_members must not rebuild)")
        check(counts["lp_terms_batch"] == counts["lp_terms"] == 0,
              f"ours_ls {engine}: LP kernels launched with the LP solutions given")
        ratios = np.array([r.total_weighted_cct for r in res]) / ours_obj
        log(f"ours_ls paper default {engine} engine: {len(instances)} instances x {k} "
            f"candidates = {len(instances) * k} expanded members, {outcome.rounds} rounds, "
            f"{outcome.evaluations} evaluations, {int(outcome.improved.sum())} improved; "
            f"weighted CCT / ours mean {ratios.mean():.4f} min {ratios.min():.4f}; "
            f"validated, <= ours and <= (8K+1) x LP; run_batch {wall:.4f} s; "
            f"launches {json.dumps(counts)} ({kernel} = {rounds} calendar rounds)")
        if calls:
            for i, row in enumerate(refine_rounds(calls, instances, k, ours_obj, outcome)):
                log(f"ours_ls refinement round {i}: {row['evaluations']} candidate "
                    f"evaluations, {row['improved']} instances improved, mean refined / "
                    f"ours {row['mean_ratio']:.6f}; allocation {row['allocation_s']:.4f} s, "
                    f"calendar (lean CCTs) {row['calendar_s']:.4f} s")
    for b, (a, c) in enumerate(zip(results["kernel"], results["jax"])):
        check_same_schedule(f"ours_ls kernel vs jax engine instance {b}", a, c)
    log("ours_ls: the pair and the flow engine give the same bits (orders, cores, "
        "establish/complete, CCTs)")

    # One refinement round profiled: device busy against its wall.
    ens = build_ensemble_batch(instances)
    pipe = get_pipeline("ours_ls")
    orders = lp_orders(torch, pipe, ens, sols)
    t0 = time.perf_counter()
    wall, kernels = profile_device(torch, lambda: refine_batch_arrays(
        ens, orders, RefineSpec(rounds=1), alloc_fn=pipe.allocate_stage.allocate_batch_arrays,
        cct_fn=pipe.circuit_stage.cct_batch_arrays), cpu=False)
    profile_s = time.perf_counter() - t0
    if kernels:
        busy = sum(t for t, _ in kernels.values())
        pr_us, pr_n = (sum(v[i] for key, v in kernels.items() if "pair_resolve" in key)
                       for i in (0, 1))
        log(f"ours_ls one profiled round ({len(instances) * k} members): wall {wall:.4f} s, "
            f"device busy {busy / 1e6:.4f} s ({100 * busy / 1e6 / wall:.1f} %), "
            f"{sum(c for _, c in kernels.values())} device kernels, pair_resolve "
            f"{pr_us / 1e3:.3f} ms x{pr_n}; {profile_s:.2f} s with the profiler's summary")
    else:
        log("ours_ls profiled round: device busy share not measured (the profiler saw "
            "no device activity)")

    # Card against host: the 8 trace-release instances.
    pipe = get_pipeline("ours_ls")
    reset_counts()
    t0 = time.perf_counter()
    card = pipe.run_batch(trace, trace_sols, require_batch=True)
    card_s = time.perf_counter() - t0
    trace_counts = read_counts()
    check(trace_counts["pair_resolve"] == batch_circuit.ROUNDS["kernel"] > 0,
          f"ours_ls trace: pair_resolve launched {trace_counts['pair_resolve']} times")
    check_ours_ls("ours_ls trace", trace, trace_sols, card, trace_ours)
    t0 = time.perf_counter()
    host = pipe.run_batch(trace, trace_sols, device="cpu")
    host_s = time.perf_counter() - t0
    for b, (g, c) in enumerate(zip(card, host)):
        check_same_schedule(f"ours_ls trace GPU vs CPU instance {b}", g, c)
    log(f"ours_ls trace releases: {len(trace)} instances, card and host bit-identical "
        f"(run_batch {card_s:.4f} s on the card, {host_s:.4f} s on the host)")

    # The per-instance oracle: refine_sequential through the host's stages.
    t0 = time.perf_counter()
    loop = get_pipeline("ours_ls", circuit_backend="loop").run_batch(
        instances[:4], sols[:4], device="cpu")
    loop_s = time.perf_counter() - t0
    for b, (g, c) in enumerate(zip(results["kernel"], loop)):
        check_same_schedule(f"ours_ls card vs refine_sequential (host loop) instance {b}", g, c)
        check(total_weighted_cct(instances[b], c.ccts) == g.total_weighted_cct,
              f"ours_ls instance {b}: objectives differ")
    log(f"ours_ls: the card's first 4 instances equal refine_sequential through the host's "
        f"per-instance stages ({loop_s:.4f} s)")
    launches["trace"] = trace_counts
    return launches


def phase_engines(torch, instances, sols, ours_results):
    """The executors besides the card's calendars, against phase 3's
    greedy bits: ``engine="wide"`` (host NumPy) on phase 3's allocation,
    launching no calendar kernel; ``"auto"`` resolving to ``"kernel"`` on
    the card, and with ``REPRO_CIRCUIT_ENGINE=jax`` running the flow
    calendar; ``ours`` under ``circuit_backend="loop"``."""
    import os

    from repro_torch.pipeline import batch_circuit, build_ensemble_batch, get_pipeline

    ens = build_ensemble_batch(instances)
    pipe = get_pipeline("ours")
    alloc = pipe.allocate_stage.allocate_batch_arrays(ens, lp_orders(torch, pipe, ens, sols))
    reset_counts()
    t0 = time.perf_counter()
    wide = batch_circuit.schedule_batch_arrays(ens, alloc, discipline="greedy", engine="wide")
    wide_s = time.perf_counter() - t0
    counts = read_counts()
    check(counts["pair_resolve"] == counts["event_resolve"] == 0,
          f"wide engine launched calendar kernels: {counts}")
    for b, ((scheds, ccts), want) in enumerate(zip(wide, ours_results)):
        for c, (x, y) in enumerate(zip(scheds, want.core_schedules)):
            check(np.array_equal(x.establish, y.establish) and np.array_equal(x.complete, y.complete),
                  f"wide engine instance {b} core {c}: times differ from phase 3's")
        check(np.array_equal(ccts, want.ccts), f"wide engine instance {b}: CCTs differ")
    log(f"engine wide (host NumPy) on phase 3's allocation: {len(instances)} instances "
        f"bit-identical to the card's kernel engine, no calendar kernel launched, "
        f"{wide_s:.4f} s")

    check(batch_circuit.resolve_engine("auto", "cuda") == "kernel",
          "auto does not resolve to kernel on the card")
    old = os.environ.get("REPRO_CIRCUIT_ENGINE")
    os.environ["REPRO_CIRCUIT_ENGINE"] = "jax"
    try:
        reset_counts()
        t0 = time.perf_counter()
        auto = get_pipeline("ours", circuit_engine="auto").run_batch(instances, sols)
        auto_s = time.perf_counter() - t0
        counts = read_counts()
    finally:
        if old is None:
            del os.environ["REPRO_CIRCUIT_ENGINE"]
        else:
            os.environ["REPRO_CIRCUIT_ENGINE"] = old
    check(counts["event_resolve"] == batch_circuit.ROUNDS["jax"] > 0
          and counts["pair_resolve"] == 0,
          f"auto with REPRO_CIRCUIT_ENGINE=jax did not run the flow calendar: {counts}")
    for b, (g, want) in enumerate(zip(auto, ours_results)):
        check_same_schedule(f"auto (REPRO_CIRCUIT_ENGINE=jax) vs phase 3 instance {b}", g, want)
    log(f"engine auto: resolves to kernel on the card; with REPRO_CIRCUIT_ENGINE=jax it ran "
        f"the flow calendar ({counts['event_resolve']} event_resolve launches) with phase 3's "
        f"bits, run_batch {auto_s:.4f} s")

    reset_counts()
    t0 = time.perf_counter()
    loop = get_pipeline("ours", circuit_backend="loop").run_batch(instances, sols)
    loop_s = time.perf_counter() - t0
    counts = read_counts()
    check(counts["pair_resolve"] == counts["event_resolve"] == 0,
          f"loop backend launched calendar kernels: {counts}")
    for b, (g, want) in enumerate(zip(loop, ours_results)):
        check_same_schedule(f"circuit_backend=loop vs phase 3 instance {b}", g, want)
    log(f"circuit_backend loop: ours with phase 3's bits, no calendar kernel launched, "
        f"run_batch {loop_s:.4f} s")


# ---------------------------------------------------------------------------
# Phase 11: the streaming service
# ---------------------------------------------------------------------------

# The reference's service cells (`benchmarks/trace_scale.py`, SCENARIOS
# "fb_quick" and "fb_full", key "service"): the instance, the pool, the
# arrival batches and the LP iterations.
SERVICE_QUICK = dict(num_coflows=48, num_ports=24, rates=(10.0, 20.0), release="trace", seed=0)
SERVICE_QUICK_RUN = dict(pool_size=16, n_batches=6, lp_iters=600)
SERVICE_LONG = dict(num_coflows=192, num_ports=48, rates=(10.0, 20.0, 30.0, 40.0),
                    release="trace", seed=0)
SERVICE_LONG_RUN = dict(pool_size=32, n_batches=24, lp_iters=900)
# The long cell's first coflows in release order, with its pool, ports,
# cores and iterations, and 8 coflows a batch: whole, the cell takes more
# than the smoke's share (PERF.md, section 4; item 4's benchmark runs it).
SERVICE_LONG_PREFIX = 64
# (b) and (c) run the CI cell's first coflows in release order, 8 a batch,
# with its pool, ports, cores and iterations: more than the pool, so
# drain epochs run too (each stream of the whole cell costs 14-40 s of
# host issue; PERF.md, section 5).
SERVICE_QUICK_PREFIX = 24
# Steps of the warm-start-free resident-against-rebuild check (b): its
# claim is bit equality, which any count tests.
SERVICE_COLD_ITERS = 20


def release_prefix(inst, n):
    """``inst``'s first ``n`` coflows in release order."""
    from repro_torch.core.coflow import CoflowInstance

    keep = np.argsort(inst.releases, kind="stable")[:n]
    return CoflowInstance(inst.demands[keep], inst.weights[keep], inst.releases[keep],
                          inst.rates, inst.delta)


def stream_bound(inst) -> float:
    """The paper's factor: 8K, plus 1 when any release is positive."""
    return 8.0 * inst.num_cores + (1.0 if (inst.releases > 0).any() else 0.0)


def check_same_stream(ctx, a, b):
    """Two `StreamResult`s bit-identical: admissions, finishes and each
    epoch's time, actives, order, projected CCTs and LP objective."""
    check(a.num_resolves == b.num_resolves,
          f"{ctx}: {a.num_resolves} against {b.num_resolves} epochs")
    check(np.array_equal(a.admission, b.admission), f"{ctx}: admissions differ")
    check(np.array_equal(a.finish, b.finish), f"{ctx}: finish times differ")
    for e, f in zip(a.epochs, b.epochs):
        same = (e.time == f.time and np.array_equal(e.actives, f.actives)
                and np.array_equal(e.order, f.order) and np.array_equal(e.ccts, f.ccts)
                and e.lp_objective == f.lp_objective and e.num_busy == f.num_busy)
        check(same, f"{ctx}: epoch {e.index} differs")


def hold_lp_terms_batch(torch, label, arrays):
    """`lp_terms_batch` on the packed LP ``arrays`` (Y0 perturbed into the
    box, as phase 2 does) against its twin within rtol(M); logs its plan
    and returns the max abs err."""
    from repro_torch.core import lp
    from repro_torch.kernels import lp_terms as lt
    from repro_torch.kernels.common import sm_count

    g = torch.Generator().manual_seed(7)
    Y = arrays["Y0"] + 0.3 * torch.rand(arrays["Y0"].shape, generator=g).to(arrays["Y0"].device)
    X = lp._precedence_X(torch.clamp(Y, 0.0, 1.0), arrays["coflow_mask"]).contiguous()
    args = (X, arrays["p_rho"], arrays["p_tau"], arrays["inv_R"], arrays["delta_over_K"])
    B, M, P = args[1].shape
    got = lt.lp_terms_batch(*args)
    torch.cuda.synchronize()
    err = check_lp_terms(f"lp_terms_batch {label} (B={B}, M={M}, P={P})", got,
                         lt.lp_terms_batch_plain(*args), M, lt.rtol(M))
    log(f"lp_terms_batch {label} (B={B}, M={M}, P={P}): plan "
        f"{json.dumps(lp_plan(lt.plan(B, M, P, sm_count(X.device))))}")
    return err


def check_stream_kernels(torch, label, inst, S):
    """A stream's `lp_terms_batch` and `port_stats` held against their
    twins at its own shapes: the LP of a full pool, (1, S, 2N), as the
    resident epoch gathers it (`pack_lp_arrays` of the first S coflows
    padded to S coflows and 2N ports, Y perturbed into the box as phase 2
    does), within rtol(S); and `update_slots`' stack of their (S, N, N)
    demands, bit for bit under the plan and every tiling."""
    from repro_torch.core import lp

    first = release_prefix(inst, S)
    arrays = lp.pack_lp_arrays([first], pad_coflows=S, pad_ports=2 * inst.num_ports,
                               device=torch.device("cuda"))
    err = hold_lp_terms_batch(torch, f"{label} stream", arrays)
    hold_port_stats(torch, f"{label} update_slots stack",
                    torch.from_numpy(np.ascontiguousarray(first.demands)).to("cuda"))
    return err


class EpochProfile:
    """Profiles one resident epoch of a stream (`DeviceWindow`,
    ``cpu=False``), from its first slot write (`update_slots` or the
    release refresh `set_slot_releases`) to its calendar's end.  While the
    stream runs it wraps those three names of `streaming.service`; the
    wrappers only count epochs and open and close the window (which
    synchronizes), so every other epoch runs as users run it."""

    def __init__(self, torch, epoch: int):
        from repro_torch.streaming import service

        self.torch, self.service, self.epoch = torch, service, epoch
        self.seen = 0
        self.window = None
        self.profile = None
        self.saved = (service.update_slots, service.set_slot_releases,
                      service.schedule_batch_arrays)

    def _open(self):
        if self.seen == self.epoch and self.window is None:
            self.window = DeviceWindow(self.torch, cpu=False)
            self.window.start()

    def __enter__(self):
        update, releases, calendar = self.saved

        def update_slots(*a, **k):
            self._open()
            return update(*a, **k)

        def set_slot_releases(*a, **k):
            self._open()
            return releases(*a, **k)

        def schedule(*a, **k):
            out = calendar(*a, **k)
            if self.window is not None and self.profile is None:
                self.profile = self.window.stop()
            self.seen += 1
            return out

        service = self.service
        service.update_slots, service.set_slot_releases = update_slots, set_slot_releases
        service.schedule_batch_arrays = schedule
        return self

    def __exit__(self, *exc):
        (self.service.update_slots, self.service.set_slot_releases,
         self.service.schedule_batch_arrays) = self.saved


def stage_means(epochs):
    """Mean host seconds a stage over ``epochs`` (`EpochRecord.stage_s`)."""
    keys = epochs[0].stage_s
    return {k: float(np.mean([e.stage_s[k] for e in epochs])) for k in keys}


def phase_streaming(torch):
    """The streaming service on the card (see the module docstring, 11)."""
    from repro_torch.core import lp
    from repro_torch.experiments import stream
    from repro_torch.pipeline import batch_circuit, get_pipeline
    from repro_torch.pipeline import ensemble_batch as eb
    from repro_torch.traffic import paper_default_instance, sample_instance

    launches = []

    def counted(fn):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        counts = read_counts()
        launches.append(counts)
        return out, counts, time.perf_counter() - t0

    quick = sample_instance(**SERVICE_QUICK)
    long = release_prefix(sample_instance(**SERVICE_LONG), SERVICE_LONG_PREFIX)
    # The kernels at the streams' shapes, outside the counted runs.
    check_stream_kernels(torch, "fb_quick", quick, SERVICE_QUICK_RUN["pool_size"])
    check_stream_kernels(torch, "fb_full", long, SERVICE_LONG_RUN["pool_size"])

    # (a) The CI service cell: resident, warm, validated on every epoch.
    lb = lp.solve_exact(quick).objective
    builds, grows = eb.BUILD_COUNT, eb.SLOT_GROW_COUNT
    res, counts, wall = counted(lambda: stream(
        quick, **SERVICE_QUICK_RUN, epoch_mode="resident", warm_start=True, validate=True))
    check(res.epoch_mode == "resident" and res.num_resolves > 0, "service: no resident epochs")
    check(bool((res.finish > res.arrival).all()), "service: a coflow did not finish after it arrived")
    limit = stream_bound(quick) * lb
    check(res.realized_weighted_cct <= limit * (1 + 1e-9),
          f"service: weighted CCT {res.realized_weighted_cct} > (8K+1) x exact LP {limit}")
    check(eb.BUILD_COUNT == builds + 1, f"service: {eb.BUILD_COUNT - builds} builds, expected 1")
    expect_lp = sum(e.lp_iters_used + 2 for e in res.epochs)
    updates = sum(1 for e in res.epochs if e.slots_written)
    rounds = batch_circuit.ROUNDS["kernel"]
    check(counts["port_stats"] == updates + 1,
          f"service: port_stats launched {counts['port_stats']} times, expected "
          f"{updates} update_slots calls + 1 build")
    check(counts["lp_terms_batch"] == expect_lp,
          f"service: lp_terms_batch launched {counts['lp_terms_batch']} times, expected "
          f"{expect_lp} (each epoch's steps + 2)")
    check(counts["pair_resolve"] == rounds > 0,
          f"service: pair_resolve launched {counts['pair_resolve']} times, expected {rounds}")
    check(counts["event_resolve"] == counts["lp_terms"] == 0,
          f"service: unexpected launches {counts}")
    split = stage_means(res.epochs)
    log(f"service fb_quick (48 coflows, 24 ports, K=2, pool 16, 6 batches, 600 iterations, "
        f"resident, warm): {res.num_resolves} epochs, {res.warm_resolves} warm re-solves, "
        f"{res.iteration_savings} iterations saved; every coflow finished, every epoch "
        f"validated; weighted CCT {res.realized_weighted_cct:.6g} = "
        f"{res.realized_weighted_cct / lb:.4f} x exact LP {lb:.6g} (bound "
        f"{stream_bound(quick):g}); {eb.BUILD_COUNT - builds} build, "
        f"{eb.SLOT_GROW_COUNT - grows} arena growths; wall {wall:.2f} s (LP "
        f"{res.lp_time_s:.2f} s); per-epoch mean host s "
        + ", ".join(f"{k} {v:.4f}" for k, v in split.items())
        + f"; launches {json.dumps(counts)} (port_stats = {updates} update_slots + 1 "
        f"build, lp_terms_batch = {expect_lp}, pair_resolve = {rounds} rounds)")

    # (b) Warm starts off: resident equals rebuild, bit for bit.
    short = release_prefix(quick, SERVICE_QUICK_PREFIX)
    short_run = dict(SERVICE_QUICK_RUN, n_batches=SERVICE_QUICK_PREFIX // 8)
    cold = dict(short_run, lp_iters=SERVICE_COLD_ITERS, warm_start=False, validate=False)
    runs = {}
    for mode in ("rebuild", "resident"):
        runs[mode], counts, wall = counted(lambda: stream(short, **cold, epoch_mode=mode))
        log(f"service fb_quick first {SERVICE_QUICK_PREFIX} coflows, {mode}, warm starts off "
            f"({SERVICE_COLD_ITERS} iterations): {runs[mode].num_resolves} epochs, wall "
            f"{wall:.2f} s, launches {json.dumps(counts)}")
    check_same_stream("service resident vs rebuild (warm starts off)", runs["resident"],
                      runs["rebuild"])
    log("service fb_quick: resident and rebuild modes bit-identical with warm starts off "
        "(every epoch's order, projected CCTs and LP objective; admissions, finishes)")

    # (c) The exact LP, rebuild mode: card against host, both card
    # engines, preemption on and off.  The host runs each stream once, under
    # its own engine (`engine="auto"`: the host NumPy one); every engine
    # gives the same bits (the CPU tests hold all three to each other).
    short_limit = stream_bound(short) * lp.solve_exact(short).objective
    for preempt in (True, False):
        kw = dict(short_run, lp_method="exact", preempt=preempt)
        t0 = time.perf_counter()
        host = stream(short, **kw, device="cpu")
        host_s = time.perf_counter() - t0
        for engine, kernel in (("kernel", "pair_resolve"), ("jax", "event_resolve")):
            card, counts, card_s = counted(lambda: stream(short, **kw, engine=engine))
            check(counts[kernel] == batch_circuit.ROUNDS[engine] > 0,
                  f"service exact {engine}: {kernel} launched {counts[kernel]} times")
            check_same_stream(f"service exact preempt={preempt} {engine}: card vs host", card, host)
            busy = max(e.num_busy for e in card.epochs)
            if not preempt:
                check(busy > 0, f"service exact {engine}: no epoch carried committed circuits")
            check(card.realized_weighted_cct <= short_limit * (1 + 1e-9),
                  f"service exact {engine} preempt={preempt}: over the bound")
            log(f"service fb_quick first {SERVICE_QUICK_PREFIX} coflows, exact LP, rebuild, "
                f"preempt={preempt}, engine {engine}: {card.num_resolves} epochs, most "
                f"committed circuits in an epoch {busy}, bit-identical to the host's stream; "
                f"{kernel} {counts[kernel]} launches; {card_s:.2f} s on the card, "
                f"{host_s:.2f} s on the host (its own engine)")

    # (d) Replay: one batch, no preemption, the exact LP = the offline run.
    t0 = time.perf_counter()
    paper = paper_default_instance(0)
    sol = lp.solve_exact(paper)
    off = get_pipeline("ours").run_batch([paper], [sol])[0]
    rep = stream(paper, lp_method="exact", n_batches=1, preempt=False)
    e0 = rep.epochs[0]
    check(rep.num_resolves == 1 and np.array_equal(e0.order, off.order),
          "replay: orders differ from run_batch")
    for f in dataclasses.fields(off.allocation):
        check(np.array_equal(getattr(off.allocation, f.name), getattr(e0.allocation, f.name)),
              f"replay: allocation.{f.name} differs from run_batch")
    check(np.array_equal(rep.finish, off.ccts), "replay: CCTs differ from run_batch")
    check(rep.realized_weighted_cct == off.total_weighted_cct,
          "replay: weighted CCT differs from run_batch")
    log(f"service replay of paper_default_instance(0) (one batch, no preemption, exact LP): "
        f"bit-identical to get_pipeline('ours').run_batch (order, allocation, CCTs, weighted "
        f"CCT {rep.realized_weighted_cct:.6g}); {time.perf_counter() - t0:.2f} s")

    # (e) The long-horizon service cell, cut to a prefix, logged.
    run = dict(SERVICE_LONG_RUN, n_batches=SERVICE_LONG_PREFIX // 8)
    t0 = time.perf_counter()
    sub = lp.solve_subgradient(long, iters=run["lp_iters"])
    sub_s = time.perf_counter() - t0
    profiled = 3
    with EpochProfile(torch, profiled) as prof:
        res, counts, wall = counted(lambda: stream(
            long, **run, epoch_mode="resident", warm_start=True, validate=False))
    check(bool((res.finish > res.arrival).all()), "long service: a coflow did not finish")
    flows = int(np.count_nonzero(long.demands))
    margin = stream_bound(long) * sub.objective / res.realized_weighted_cct
    # The profiled epoch synchronizes in its window: left out of the walls.
    plain = [e for e in res.epochs if e.index != profiled]
    warm_lp = np.array([e.lp_wall_s for e in plain if e.warm]) * 1e3
    warm_wall = np.array([e.wall_s for e in plain if e.warm]) * 1e3
    log(f"service fb_full long horizon ({long.num_coflows} coflows, {flows} flows, 48 ports, "
        f"K=4, pool 32, {run['n_batches']} batches, 900 iterations, warm 300, resident, cut "
        f"to its first {SERVICE_LONG_PREFIX} coflows in release order): {res.num_resolves} "
        f"epochs ({res.warm_resolves} warm), weighted CCT {res.realized_weighted_cct:.6g}, "
        f"margin ((8K+1) x subgradient objective {sub.objective:.6g}) / weighted CCT = "
        f"{margin:.4f} (logged, not gated; the subgradient solve {sub_s:.2f} s); wall "
        f"{wall:.2f} s, LP {res.lp_time_s:.2f} s")
    if warm_lp.size:
        p50, p95, p99 = np.percentile(warm_lp, [50, 95, 99])
        log(f"service fb_full warm re-solve ms p50 {p50:.2f} p95 {p95:.2f} p99 {p99:.2f}; "
            f"warm-epoch wall ms p50 {np.percentile(warm_wall, 50):.2f} (epoch {profiled}, "
            f"profiled, left out)")
    split = stage_means(plain)
    log(f"service fb_full per-epoch mean host s (epoch {profiled} left out): "
        + ", ".join(f"{k} {v:.4f}" for k, v in split.items())
        + f", epoch wall {np.mean([e.wall_s for e in plain]):.4f}; launches "
        f"{json.dumps(counts)}; {eb.SLOT_GROW_COUNT} arena growths in this process")
    if prof.profile is not None:
        pwall, kernels = prof.profile
        busy = sum(t for t, _ in kernels.values())
        top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:12]
        log(f"service fb_full profiled warm epoch {profiled}: wall {pwall:.4f} s, device busy "
            f"{busy / 1e6:.4f} s ({100 * busy / 1e6 / pwall:.1f} %), "
            f"{sum(c for _, c in kernels.values())} device kernels; launches (device us) by "
            f"kernel: " + "; ".join(f"{k[:60]} {c} ({us:.1f})" for k, (us, c) in top))
    else:
        log("service fb_full profiled epoch: not measured (the stream had too few epochs)")
    total = {k: sum(c[k] for c in launches) for k in launches[0]}
    return total


# ---------------------------------------------------------------------------
# Phase 12: the experiment fabric
# ---------------------------------------------------------------------------

# The imbalanced core rates of the reference's Fig. 4-6 scripts
# (`benchmarks/fig4_cdf.py`, RATES[K]["imbalanced"]).
FIG_RATES = {3: (10.0, 20.0, 30.0), 5: (5.0, 5.0, 10.0, 15.0, 25.0)}
# Fig. 5's grid (M = 100, delta = 8, seed 0) cut to three port counts and
# two core counts, at the reference's quick iteration count.
FIG5_PORTS = (8, 16, 32)
FIG5_KS = (3, 5)
FIG5_ITERS = 800
# Fig. 6 (delta = 8, seed 0): both release kinds at two core counts.
FIG6_KS = (3, 5)
# (a)'s perturbed sweep: this instance of the 32 takes seed 99.
FIG3_PERTURBED = 5
# The cells of the reference's runner test (`tests/test_runner.py`).
RUNNER_SPECS = [{"seed": 50 + i, "num_coflows": 8 + 2 * (i % 3), "num_ports": 4}
                for i in range(7)]
RUNNER_KW = dict(schemes=("ours", "wspt_order"), lp_method="exact")
DIST_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def runner_make(spec):
    from repro_torch.traffic.instances import random_instance

    return random_instance(num_coflows=spec["num_coflows"], num_ports=spec["num_ports"],
                           num_cores=2, seed=spec["seed"])


def expected_port_stats(instances):
    """`port_stats` launches of a sweep over ``instances`` with the batch
    LP: one per distinct port count per LP bucket, and in the one ensemble
    build the schemes share."""
    from repro_torch.experiments import build_buckets

    return sum(len({instances[i].num_ports for i in bk.indices})
               for bk in build_buckets(instances)) + len({i.num_ports for i in instances})


def check_sweep_launches(label, counts, lp_steps, port_stats):
    """A card sweep's launches: `lp_terms_batch` ``lp_steps``, `port_stats`
    ``port_stats``, `pair_resolve` once per pair-calendar round (``"auto"``
    resolves to the pair calendar on a card), no flow-calendar round, no
    per-instance LP kernel."""
    from repro_torch.pipeline import batch_circuit

    rounds = batch_circuit.ROUNDS["kernel"]
    check(counts["lp_terms_batch"] == lp_steps,
          f"{label}: lp_terms_batch launched {counts['lp_terms_batch']} times, "
          f"expected {lp_steps}")
    check(counts["port_stats"] == port_stats,
          f"{label}: port_stats launched {counts['port_stats']} times, expected {port_stats}")
    check(counts["pair_resolve"] == rounds > 0,
          f"{label}: pair_resolve launched {counts['pair_resolve']} times, expected "
          f"{rounds} (one per calendar round)")
    check(counts["event_resolve"] == batch_circuit.ROUNDS["jax"] == 0,
          f"{label}: event_resolve launched {counts['event_resolve']} times")
    check(counts["lp_terms"] == 0, f"{label}: lp_terms launched {counts['lp_terms']} times")


def check_cells(label, res, instances):
    """Every cell of a fresh sweep: finite CCTs of the instance's length,
    weighted CCT at least the LP objective / 1.005, and ours within (8K+1)
    x the LP objective.  (The sweep validated every kept schedule.)"""
    for rec, inst in zip(res.records, instances):
        obj = rec.lp.objective
        for s, r in rec.results.items():
            check(np.isfinite(r.ccts).all() and r.ccts.shape == (inst.num_coflows,),
                  f"{label} {s} instance {rec.index}: bad CCT vector")
            check(r.total_weighted_cct >= obj / 1.005,
                  f"{label} {s} instance {rec.index}: weighted CCT {r.total_weighted_cct} "
                  f"below LP objective {obj} / 1.005")
        limit = (8 * inst.num_cores + 1) * obj
        check(rec.results["ours"].total_weighted_cct <= limit,
              f"{label} instance {rec.index}: ours {rec.results['ours'].total_weighted_cct} "
              f"> (8K+1) x LP {limit}")


def check_sweep_kernels(torch, label, instances):
    """A batch-LP sweep's kernels against their twins at the shapes it
    gives them: each LP bucket's `lp_terms_batch`, packed as
    `solve_ensemble_lp` packs it, within rtol(M); `port_stats` on each
    stack of one port count's demands (each bucket's LP, and the ensemble
    build over all ``instances``), bit for bit under the plan and every
    tiling.  Run after the sweep's counts are read."""
    from repro_torch.core import lp
    from repro_torch.experiments import build_buckets

    err = 0.0
    groups = []
    for bk in build_buckets(instances):
        members = [instances[i] for i in bk.indices]
        arrays = lp.pack_lp_arrays(members, pad_coflows=bk.num_coflows,
                                   pad_ports=bk.num_flat_ports, device=torch.device("cuda"))
        err = max(err, hold_lp_terms_batch(torch, f"{label} bucket", arrays))
        groups.append(bk.indices)
    groups.append(range(len(instances)))
    stacks = {}
    for idx in groups:
        for n in sorted({instances[i].num_ports for i in idx}):
            stacks.setdefault(tuple(i for i in idx if instances[i].num_ports == n), None)
    for idx in stacks:
        d = torch.from_numpy(np.concatenate([instances[i].demands for i in idx])).to("cuda")
        hold_port_stats(torch, f"{label} stack of instances {list(idx)}", d)
    return err


def check_host_cells(torch, label, records, instances, schemes):
    """Each scheme's cells of ``records`` bit for bit against its
    `run_batch` on the host on the same LP solutions (one stage cache, as
    the sweep shares one; the calendar on the host's NumPy pair engine,
    ``"wide"``, which phase 10 holds to the card's bits and which takes
    half the host time of the kernels' plain twins); returns the host's
    seconds."""
    from repro_torch.pipeline import get_pipeline

    t0 = time.perf_counter()
    sols = [rec.lp for rec in records]
    cache = {}
    for s in schemes:
        host = get_pipeline(s, circuit_engine="wide").run_batch(
            instances, lp_solutions=sols, validate=True, device="cpu", stage_cache=cache)
        for rec, h in zip(records, host):
            check_same_schedule(f"{label} {s} instance {rec.index} card vs host",
                                rec.results[s], h)
    return time.perf_counter() - t0


def timed_sweep(torch, instances, **kw):
    """`sweep` with every count at 0 before it; (result, wall s, counts)."""
    from repro_torch.experiments import sweep

    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = sweep(instances, **kw)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0, read_counts()


def fabric_fig3(torch, paper, sols, scheme_results, root):
    """(a) Fig. 3: a fresh cached sweep of the 32 paper instances over the
    paper's schemes and ours_ls, its replay, and a perturbed sweep."""
    from repro_torch.experiments import build_buckets, group_mean
    from repro_torch.pipeline import PAPER_SCHEMES, batch_circuit, get_pipeline
    from repro_torch.traffic.instances import paper_default_instance

    schemes = PAPER_SCHEMES + ("ours_ls",)
    metas = [{"seed": s} for s in SEEDS]
    kw = dict(schemes=schemes, lp_method="batch", lp_iters=LP_ITERS, metas=metas)
    n_cells = len(paper) * len(schemes)
    res, wall, counts = timed_sweep(torch, paper, cache=root, **kw)
    check(res.cache_stats == dict(cells=n_cells, hits=0, misses=n_cells, computed=n_cells),
          f"fabric fig3: fresh cache stats {res.cache_stats}")
    check_sweep_launches("fabric fig3", counts, len(build_buckets(paper)) * (LP_ITERS + 2),
                         expected_port_stats(paper))
    check_cells("fabric fig3", res, paper)
    for rec in res.records:
        check(rec.results["ours_ls"].total_weighted_cct
              <= rec.results["ours"].total_weighted_cct,
              f"fabric fig3 instance {rec.index}: ours_ls above ours")
    same_lp = all(rec.lp.objective == s.objective
                  and rec.lp.completion.tobytes() == s.completion.tobytes()
                  for rec, s in zip(res.records, sols))
    if same_lp:
        for s in PAPER_SCHEMES:
            for rec, want in zip(res.records, scheme_results[s]):
                check_same_schedule(f"fabric fig3 {s} vs phase 9 instance {rec.index}",
                                    rec.results[s], want)
        log("fabric fig3: the sweep's LP solutions equal phase 3's bit for bit; every "
            "cell of the paper's schemes equals phase 9's")
    else:
        gap = max(abs(rec.lp.objective - s.objective) / s.objective
                  for rec, s in zip(res.records, sols))
        own = [rec.lp for rec in res.records]
        for s in schemes:
            want = get_pipeline(s).run_batch(paper, lp_solutions=own, validate=True)
            for rec, w in zip(res.records, want):
                check_same_schedule(f"fabric fig3 {s} vs run_batch instance {rec.index}",
                                    rec.results[s], w)
        log(f"fabric fig3: the sweep's LP solutions differ from phase 3's (largest "
            f"relative objective gap {gap:.3e}); every cell equals run_batch on the "
            f"sweep's own solutions")
    means = group_mean(res.rows(), ["scheme"], ["norm_weighted_cct", "norm_p95", "norm_p99"])
    for row in means:
        s = row["scheme"]
        if s in FIG3_GATES:
            check(FIG3_GATES[s](row["norm_weighted_cct"]),
                  f"fabric fig3: Fig. 3 claim {s} {FIG3_TEXT[s]} fails: "
                  f"{row['norm_weighted_cct']}")
    # Each scheme's share after the ordering (allocation, refinement and
    # calendar, summed over its results' `wall_time_s`; an allocation the
    # stage cache served counts for the scheme that computed it).
    split = {s: sum(rec.results[s].wall_time_s for rec in res.records) for s in schemes}
    log(f"fabric fig3: fresh sweep of {len(paper)} instances x {len(schemes)} schemes: wall "
        f"{wall:.4f} s, LP {res.lp_time_s:.4f} s, by scheme "
        f"{json.dumps({k: round(v, 4) for k, v in split.items()})}, the rest (keys, build, "
        f"ordering, validation, cache writes) {wall - res.lp_time_s - sum(split.values()):.4f} s; "
        f"{json.dumps(res.cache_stats)}; calendar rounds {batch_circuit.ROUNDS['kernel']}; "
        f"launches {json.dumps(counts)}")
    log("fabric fig3 means (scheme, weighted CCT / ours, p95 / ours, p99 / ours): "
        + "; ".join(f"{r['scheme']} {r['norm_weighted_cct']:.4f} {r['norm_p95']:.4f} "
                    f"{r['norm_p99']:.4f}" for r in means))

    # The replay: every cell a hit, no kernel, the same bytes.
    replay, replay_wall, replay_counts = timed_sweep(torch, paper, cache=root, **kw)
    check(replay.cache_stats == dict(cells=n_cells, hits=n_cells, misses=0, computed=0),
          f"fabric fig3 replay: cache stats {replay.cache_stats}")
    check(not any(replay_counts.values()) and not any(batch_circuit.ROUNDS.values()),
          f"fabric fig3 replay launched kernels: {replay_counts} {batch_circuit.ROUNDS}")
    paths = [r.save(f"fabric_fig3_{tag}") for r, tag in ((res, "fresh"), (replay, "replay"))]
    for a, b in zip(*paths):
        check(Path(a).read_bytes() == Path(b).read_bytes(),
              f"fabric fig3 replay: {b} differs from {a}")
    check(json.dumps(replay.rows()) == json.dumps(res.rows()),
          "fabric fig3 replay: rows differ")
    log(f"fabric fig3 replay: {n_cells} hits, 0 computed, no kernel launched, rows "
        f"byte-identical (JSON and CSV); wall {replay_wall:.4f} s")

    # One instance replaced: its cells alone are computed.
    pert = list(paper)
    pert[FIG3_PERTURBED] = paper_default_instance(seed=99)
    pmetas = list(metas)
    pmetas[FIG3_PERTURBED] = {"seed": 99}
    pres, pwall, pcounts = timed_sweep(torch, pert, cache=root, **{**kw, "metas": pmetas})
    check(pres.cache_stats == dict(cells=n_cells, hits=n_cells - len(schemes),
                                   misses=len(schemes), computed=len(schemes)),
          f"fabric fig3 perturbed: cache stats {pres.cache_stats}")
    check_sweep_launches("fabric fig3 perturbed", pcounts, LP_ITERS + 2,
                         expected_port_stats([pert[FIG3_PERTURBED]]))
    check_cells("fabric fig3 perturbed", pres, pert)
    keep = [r for r in res.rows() if r["instance"] != FIG3_PERTURBED]
    check(json.dumps([r for r in pres.rows() if r["instance"] != FIG3_PERTURBED])
          == json.dumps(keep), "fabric fig3 perturbed: the other instances' rows changed")
    log(f"fabric fig3 perturbed (instance {FIG3_PERTURBED} seed 99): "
        f"{json.dumps(pres.cache_stats)}; wall {pwall:.4f} s, LP {pres.lp_time_s:.4f} s; "
        f"launches {json.dumps(pcounts)}")
    host_s = check_host_cells(torch, "fabric fig3 perturbed", [pres.records[FIG3_PERTURBED]],
                              [pert[FIG3_PERTURBED]], schemes)
    check_sweep_kernels(torch, "fabric fig3 perturbed", [pert[FIG3_PERTURBED]])
    log(f"fabric fig3 perturbed: its {len(schemes)} cells equal run_batch on the host "
        f"({host_s:.4f} s on the host)")
    return [counts, pcounts], dict(fresh_s=wall, lp_s=res.lp_time_s, replay_s=replay_wall,
                                   perturbed_s=pwall, perturbed_lp_s=pres.lp_time_s,
                                   perturbed_host_s=host_s)


def fabric_fig6(torch):
    """(b) Fig. 6: ours with the exact LP and certificates."""
    from repro_torch.pipeline import ensemble_batch
    from repro_torch.traffic.instances import sample_instance

    insts, metas = [], []
    for K in FIG6_KS:
        for release in ("zero", "trace"):
            insts.append(sample_instance(rates=FIG_RATES[K], delta=8.0, seed=0, release=release))
            metas.append({"K": K, "delta": 8.0, "release": release})
    builds = ensemble_batch.BUILD_COUNT
    res, wall, counts = timed_sweep(torch, insts, schemes=("ours",), lp_method="exact",
                                    certify=True, metas=metas)
    check(ensemble_batch.BUILD_COUNT - builds == 1,
          f"fabric fig6: {ensemble_batch.BUILD_COUNT - builds} ensembles built, expected 1 "
          f"(greedy and reserving share it)")
    check_sweep_launches("fabric fig6", counts, 0, len({i.num_ports for i in insts}))
    check_cells("fabric fig6", res, insts)
    for row in res.rows():
        check(row["approx_ratio"] <= row["bound"],
              f"fabric fig6 {row}: ratio above its bound")
        check(row["certified_reserving"] is True, f"fabric fig6 {row}: not certified")
    check_host_cells(torch, "fabric fig6", res.records, insts, ("ours",))
    log(f"fabric fig6: {len(insts)} instances, exact LP, certified; wall {wall:.4f} s "
        f"(LP {res.lp_time_s:.4f} s); one ensemble build; cells equal run_batch on the "
        f"host; launches {json.dumps(counts)}; (K, release, ratio, reserving ratio, bound): "
        + "; ".join(f"{r['K']} {r['release']} {r['approx_ratio']:.4f} "
                    f"{r['approx_ratio_reserving']:.4f} {r['bound']:.0f}" for r in res.rows()))
    return [counts], dict(fig6_s=wall, fig6_lp_s=res.lp_time_s)


def fabric_fig5(torch):
    """(c) Fig. 5: a mixed (K, N) grid as one ensemble."""
    from repro_torch.experiments import build_buckets
    from repro_torch.pipeline import PAPER_SCHEMES, ensemble_batch
    from repro_torch.traffic.instances import sample_instance

    insts, metas = [], []
    for K in FIG5_KS:
        for N in FIG5_PORTS:
            insts.append(sample_instance(num_ports=N, rates=FIG_RATES[K], seed=0))
            metas.append({"K": K, "N": N})
    buckets = build_buckets(insts)
    check(len(buckets) == len(FIG5_PORTS),
          f"fabric fig5: {len(buckets)} LP buckets, expected {len(FIG5_PORTS)}")
    builds = ensemble_batch.BUILD_COUNT
    res, wall, counts = timed_sweep(torch, insts, schemes=PAPER_SCHEMES, lp_method="batch",
                                    lp_iters=FIG5_ITERS, metas=metas)
    check(ensemble_batch.BUILD_COUNT - builds == 1,
          "fabric fig5: the schemes did not run mixed N and K in one run_batch")
    check_sweep_launches("fabric fig5", counts, len(buckets) * (FIG5_ITERS + 2),
                         expected_port_stats(insts))
    check_cells("fabric fig5", res, insts)
    host_s = check_host_cells(torch, "fabric fig5", res.records, insts, PAPER_SCHEMES)
    check_sweep_kernels(torch, "fabric fig5", insts)
    table = []
    for rec in res.records:
        nw = rec.normalized()
        table.append((rec.meta["K"], rec.meta["N"], nw["wspt_order"], nw["load_only"],
                      nw["sunflow_s"], nw["bvn_s"]))
    log(f"fabric fig5: {len(insts)} instances in {len(buckets)} LP buckets, one ensemble; "
        f"wall {wall:.4f} s (LP {res.lp_time_s:.4f} s); launches {json.dumps(counts)}; "
        f"cells equal run_batch on the host ({host_s:.4f} s on the host); "
        "(K, N, WSPT, LOAD, SUN, BvN): "
        + "; ".join(f"{k} {n} {a:.4f} {b:.4f} {c:.4f} {d:.4f}" for k, n, a, b, c, d in table))
    return [counts], dict(fig5_s=wall, fig5_lp_s=res.lp_time_s, fig5_host_s=host_s)


def fabric_runner(torch, work):
    """(d) The runner: two shards sharing a cache, merged; a re-run; one
    process through `run_distributed`."""
    import os

    from repro_torch.experiments import (
        merge_shards, results_dir, run_distributed, run_shard, sweep,
    )

    t0 = time.perf_counter()
    reset_counts()
    specs = RUNNER_SPECS
    single = sweep([runner_make(s) for s in specs],
                   metas=[dict(s, cell=i) for i, s in enumerate(specs)], **RUNNER_KW)
    want = json.dumps(json.loads(json.dumps(single.rows(), default=float)))
    cache = os.path.join(work, "runner_cache")
    for shard in range(2):
        run_shard(specs, runner_make, name="fabric_runner", shard=shard, num_shards=2,
                  cache=cache, **RUNNER_KW)
    jpath, _ = merge_shards("fabric_runner", 2)
    check(json.dumps(json.loads(Path(jpath).read_text())) == want,
          "fabric runner: merged shards differ from one sweep")
    again = run_shard(specs, runner_make, shard=1, num_shards=2, cache=cache, **RUNNER_KW)
    check(again.cache_stats["computed"] == 0,
          f"fabric runner: shard 1 re-run computed {again.cache_stats}")
    run_distributed(specs, runner_make, name="fabric_distributed", **RUNNER_KW)
    dpath = Path(results_dir()) / "fabric_distributed.json"
    check(json.dumps(json.loads(dpath.read_text())) == want,
          "fabric runner: run_distributed in one process differs from one sweep")
    torch.cuda.synchronize()
    counts = read_counts()
    wall = time.perf_counter() - t0
    log(f"fabric runner: {len(specs)} cells x 2 schemes; shards 0 and 1 of 2 merged equal "
        f"one sweep, byte for byte; shard 1 re-run computed 0; run_distributed (one "
        f"process) equals one sweep; {wall:.4f} s; launches {json.dumps(counts)}")
    return [counts], dict(runner_s=wall)


def phase_fabric(torch, paper, sols, scheme_results):
    """The experiment fabric on the card (see the module docstring, 12).
    Results and caches go to a temporary directory, removed after."""
    import os
    import shutil
    import tempfile

    work = tempfile.mkdtemp(prefix="chip_smoke_fabric_")
    keys = ("REPRO_RESULTS", "REPRO_CACHE") + DIST_ENV
    saved = {k: os.environ.get(k) for k in keys}
    os.environ["REPRO_RESULTS"] = os.path.join(work, "results")
    os.environ["REPRO_CACHE"] = os.path.join(work, "cache")
    for k in DIST_ENV:
        os.environ.pop(k, None)
    launches, times = [], {}
    try:
        for part in (
            lambda: fabric_fig3(torch, paper, sols, scheme_results,
                                os.path.join(work, "fig3_cache")),
            lambda: fabric_fig6(torch),
            lambda: fabric_fig5(torch),
            lambda: fabric_runner(torch, work),
        ):
            c, t = part()
            launches.extend(c)
            times.update(t)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(work, ignore_errors=True)
    log("fabric seconds: " + json.dumps({k: round(v, 4) for k, v in times.items()}))
    return {k: sum(c[k] for c in launches) for k in launches[0]}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.lp import pack_lp_arrays
    from repro_torch.kernels import common
    from repro_torch.traffic.instances import paper_default_instance, sample_instance

    marks = [time.perf_counter()]

    def lap(what):
        """Log the seconds since the previous mark (the smoke's own clock)."""
        marks.append(time.perf_counter())
        log(f"smoke clock: {what} {marks[-1] - marks[-2]:.2f} s "
            f"({marks[-1] - marks[0]:.2f} s so far)")

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
    wide = [sample_instance(num_ports=150, num_coflows=64, seed=s) for s in range(4)]
    # The whole Facebook-like trace on 150 ports (the reference's fb_full).
    fb_full = sample_instance(num_coflows=526, num_ports=150, rates=(10.0,),
                              release="trace", seed=0)

    # Phase 2: kernels against their plain twins.
    from repro_torch.experiments.ensemble import bucket_shape
    Mp, Pp = bucket_shape(paper[0])
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 is compared below
    torch.backends.cudnn.allow_tf32 = False
    rows = phase_kernels(
        torch,
        # `port_stats`'s inputs as `lp.instance_port_stats` stacks them: the
        # main path's ensemble, `pack_lp_arrays(wide)`, the whole trace.
        {"main path": [inst.demands for inst in paper],
         "wide": [inst.demands for inst in wide],
         "fb_full": [fb_full.demands]},
        pack_lp_arrays(paper, pad_coflows=Mp, pad_ports=Pp),
        pack_lp_arrays(mixed, pad_coflows=40, pad_ports=24),
        pack_lp_arrays(wide),
        [("paper", paper[0]),
         ("small", sample_instance(num_ports=3, num_coflows=37, seed=37)),
         ("fb_full", fb_full)],
    )
    rows.append(phase_flash_kernel(torch))
    rows.append(phase_mlstm_kernel(torch))
    rows.extend(phase_quant_kernel(torch))
    lap("phases 1-2 (build, kernels)")

    # Phases 3 and 4: the main path, then GPU/CPU parity, on both ensembles;
    # each time under the pair engine, then the flow engine counted apart.
    sols, counts, paper_results, pair_rounds = phase_end_to_end(torch, "paper default", paper)
    flow_counts, _ = phase_flow_engine(torch, "paper default", paper, sols,
                                       paper_results, pair_rounds)
    stage_times(torch, "paper default", paper)
    phase_parity("paper default", paper, sols)
    trace_sols, _, trace_results, trace_rounds = phase_end_to_end(
        torch, "trace releases", trace)
    phase_flow_engine(torch, "trace releases", trace, trace_sols, trace_results,
                      trace_rounds)
    phase_parity("trace releases", trace, trace_sols)
    lap("phases 3-4 (ensembles, parity)")

    # Phase 5: per-instance ours, each run solving its own LP; then the flow
    # engine on two of them.
    paper_1 = ("paper seed 0", paper[0])
    trace_1 = ("trace seed 1", sample_instance(seed=1, release="trace"))
    fig5 = ("fig5 N=32", sample_instance(num_ports=32, seed=0))
    single_counts, runs = phase_per_instance(
        torch,
        [paper_1, trace_1],
        [paper_1, trace_1, fig5,
         ("fb_quick K=2", sample_instance(num_coflows=48, num_ports=24,
                                          rates=(10.0, 20.0), release="trace",
                                          seed=0))],
    )
    flow_runs = phase_per_instance_flow(torch, runs, [paper_1[0], fig5[0]])
    lap("phase 5 (per instance)")

    # Phase 2, the flow-space round: `event_resolve` on the calendar states
    # of the main path's bucket (the 32 paper-default schedules of phase 3),
    # of the fig5 instance (phase 5) and of the whole trace's one member.
    rows.insert(1, phase_event_kernel(torch, {
        "main path bucket": (
            schedule_tables(zip(paper, paper_results["greedy"])),
            max(inst.num_ports for inst in paper), 10**9),
        "fig5 N=32": (schedule_tables([flow_runs[fig5[0]]]), fig5[1].num_ports, 64),
        "fb_full": ([whole_trace_table(fb_full)], fb_full.num_ports, 3),
    }))

    # Phase 2, the calendars on the whole trace: `pair_resolve` on real
    # pair-calendar rounds at 152 ports, and each engine's resolve share.
    phase_trace_calendars(torch, fb_full)
    lap("phase 2 (calendar rounds)")

    # Phase 6: serving gemma3-1b at full width.
    serve_counts = phase_serving(torch)
    lap("phase 6 (serving gemma3-1b)")

    # Phase 7: serving xlstm-1.3b at full width.
    xlstm_counts = phase_serving_xlstm(torch)
    lap("phase 7 (serving xlstm-1.3b)")

    # Phase 8: training gemma3-1b at full width with compressed gradients.
    train_counts = phase_training(torch)
    lap("phase 8 (training, planner)")

    # Phase 9: the paper's schemes on both ensembles with phase 3's LP
    # solutions, then EPS on four delta = 0 instances.
    _, scheme_results = phase_schemes(torch, "schemes paper default", paper, sols,
                                      paper_results["greedy"])
    phase_schemes(torch, "schemes trace releases", trace, trace_sols,
                  trace_results["greedy"])
    phase_eps(torch, range(4), paper[0], sols[0])
    lap("phase 9 (paper schemes, eps)")

    # Phase 10: ours_ls on both ensembles with phase 3's LP solutions, then
    # the calendar's other executors against phase 3's bits.
    refine_counts = phase_refine(torch, paper, sols, paper_results["greedy"], trace,
                                 trace_sols, trace_results["greedy"])
    phase_engines(torch, paper, sols, paper_results["greedy"])
    lap("phase 10 (ours_ls, engines)")

    # Phase 11: the streaming service.
    stream_counts = phase_streaming(torch)
    lap("phase 11 (streaming)")

    # Phase 12: the experiment fabric (Fig. 3, 6 and 5 sweeps, the runner).
    fabric_counts = phase_fabric(torch, paper, sols, scheme_results)
    lap("phase 12 (experiment fabric)")

    # Phase 13: the kernels line (each kernel's launches on its main paths:
    # the calendar kernels' and port_stats' grow by the planner's run in
    # phase 8, by ours_ls's runs in phase 10, by the streams of phase 11 and
    # by the sweeps of phase 12, lp_terms_batch's by the streams' and the
    # sweeps' LPs), then the result.
    for name in ("pair_resolve", "port_stats"):
        counts[name] += (train_counts[name] + sum(c[name] for c in refine_counts.values())
                         + stream_counts[name] + fabric_counts[name])
    counts["lp_terms_batch"] += stream_counts["lp_terms_batch"] + fabric_counts["lp_terms_batch"]
    flow_counts["event_resolve"] += (sum(c["event_resolve"] for c in refine_counts.values())
                                     + stream_counts["event_resolve"]
                                     + fabric_counts["event_resolve"])
    counts["lp_terms"] = single_counts["lp_terms"] + fabric_counts["lp_terms"]
    counts["event_resolve"] = flow_counts["event_resolve"]
    counts["flash_attention"] = serve_counts["flash_attention"]
    counts["mlstm_chunk"] = xlstm_counts["mlstm_chunk"]
    counts["quantize"] = train_counts["quantize"]
    counts["dequantize"] = train_counts["dequantize"]
    for r in rows:
        r["launches"] = counts[r["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{**{k: r[k] for k in keys}, **r.get("extra", {})}
                                  for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
