#!/usr/bin/env python3
"""Device time of the calendar round kernels under every plan, on one
NVIDIA GPU.

    python3 scripts/resolve_tiles.py

Launches `pair_resolve` at (G, N, N) = (96, 12, 12) (the main path),
(8, 48, 48) and (8, 152, 152) (the whole trace's 150 ports plus the
calendar's quantum), on random claims from a seed, and `event_resolve`
(greedy) at (96, 336, 12) (the main path's bucket) and (8, 1520, 32)
(fig5's width) on random states, and at (8, 266272, 152) on round 0 of
the whole trace's one member (the flow calendar's own state; also with
nothing pending and with nothing released), under every
plan the wrappers take (`tilings`, through their ``plan``; for
`event_resolve` each also with 1 and 4 flows a lane a step and, on the
cluster route, 256 or 512 threads a block), plus the
shapes on either side of each route switch (`pair_resolve.BLOCK_PORTS`,
`event_resolve.BLOCK_FLOWS`).  Each result is held against the plain
twin bit for bit; each line prints the profiler's device microseconds per
launch (30 launches) beside the byte bound at 3.35 TB/s and marks the
plan `plan` picks.  Exits non-zero if a result disagrees or there is no
card.
"""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

LAUNCHES = 30
HBM_BYTES_PER_S = 3.35e12

# (G, N): the three timed shapes, then either side of the route switch.
PAIR_SHAPES = [(96, 12), (8, 48), (8, 152), (8, 32), (8, 36)]
# (G, F, N, label): the three timed shapes, then either side of the switch.
# The whole trace's round 0 also with nothing pending and with nothing
# waiting (every release moved past t): what the scan costs alone.
EVENT_SHAPES = [(96, 336, 12, "main path"), (8, 1520, 32, "fig5"),
                (8, 266_272, 152, "whole trace"),
                (8, 266_272, 152, "whole trace, nothing pends"),
                (8, 266_272, 152, "whole trace, none waits"), (8, 4096, 32, "switch"),
                (8, 8192, 32, "switch"), (8, 16384, 32, "switch")]


def device_us(torch, fn, name):
    """Device microseconds per call of ``fn`` over the kernels whose names
    contain ``name`` (every kernel where ``name`` is None); up to three
    profiled windows, since a short one now and then records nothing."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(LAUNCHES):
                fn()
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and (name is None or name in e.key))
        if total:
            return total / LAUNCHES
    return float("nan")


def event_plans(er, G, F, N):
    """Every `tilings` plan of `event_resolve` at (G, F, N), each also with
    1 and 4 flows a lane a step (4 where F % 4 == 0) and (cluster route)
    256 or 512 threads a block."""
    plans = []
    for p in er.tilings(G, F, N):
        threads = (None,) if p.route == "block" else (None, 256, 512)
        for vector in (4, 1) if F % 4 == 0 else (1,):
            for t in threads:
                q = er.tiling(G, F, N, p.cluster, t, vector)
                if q not in plans:
                    plans.append(q)
    return plans


def trace_state(torch):
    """Round 0 of the flow calendar on the whole trace's one member
    (526 coflows, 150 ports, 266,260 flows; padded to G = 8)."""
    from chip_smoke import whole_trace_table
    from repro_torch.pipeline import batch_circuit as bc
    from repro_torch.traffic.instances import sample_instance

    inst = sample_instance(num_coflows=526, num_ports=150, rates=(10.0,),
                           release="trace", seed=0)
    pad = bc._pad_members([whole_trace_table(inst)], inst.num_ports)
    return bc._FlowCalendar(pad, False, torch.device("cuda")).flow_args()


def event_bytes(args):
    """What a state needs: pending byte in and start byte out per slot,
    the f64 release of a pending flow, two int32 ports of a waiting one,
    24 bytes per port and member, 9 per member (as `chip_smoke.py`)."""
    rel, pending, t = args[2], args[5], args[6]
    G, F = pending.shape
    N = args[3].shape[1]
    waiting = int((pending & (rel <= t[:, None])).sum())
    return 2 * G * F + 8 * int(pending.sum()) + 8 * waiting + 24 * G * N + 9 * G


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("resolve_tiles: no CUDA device available", file=sys.stderr)
        return 1
    from chip_smoke import random_claims, random_event_state
    from repro_torch.kernels import common
    from repro_torch.kernels import event_resolve as er
    from repro_torch.kernels import pair_resolve as pr

    dev = torch.device("cuda")
    sms = common.sm_count(dev)
    common.library()
    print(torch.cuda.get_device_name(0), f"{sms} SMs", flush=True)
    one = torch.zeros(1, device=dev)
    print(f"floor: one fill kernel of 1 value {device_us(torch, lambda: one.fill_(1.0), None):.2f} "
          f"us device", flush=True)
    ok = True
    gen = torch.Generator().manual_seed(0)
    for G, N in PAIR_SHAPES:
        claim, idle = random_claims(torch, G, N, gen, dev)
        want = pr.pair_resolve_plain(claim, idle)
        chosen = pr.plan(G, N, sms)
        bound = G * N * N * 6 / HBM_BYTES_PER_S * 1e6
        print(f"pair_resolve ({G}, {N}, {N}): bound {bound:.3f} us (bytes)", flush=True)
        for p in pr.tilings(G, N):
            good = torch.equal(pr.pair_resolve(claim, idle, plan=p), want)
            ok &= good
            us = device_us(torch, lambda: pr.pair_resolve(claim, idle, plan=p), "pair_resolve")
            width = (f"{p.per_block} members a block" if p.route == "block"
                     else f"{p.cluster} blocks of {p.rows} rows a member")
            print(f"  {p.route:7s} {width}: grid {p.grid} x {p.threads} threads, smem "
                  f"{p.smem}: {us:.2f} us{'' if good else ' MISMATCH'}"
                  f"{' <- plan' if p == chosen else ''}", flush=True)
    trace = trace_state(torch)
    variants = {
        "whole trace": trace,
        "whole trace, nothing pends": trace[:5] + (torch.zeros_like(trace[5]),) + trace[6:],
        "whole trace, none waits": (trace[:2] + (trace[2] + torch.inf,) + trace[3:]),
    }
    for G, F, N, label in EVENT_SHAPES:
        args = variants.get(label) or random_event_state(torch, gen, G, F, N, dev)
        want = er.event_resolve_plain(*args, "greedy")
        chosen = er.plan(G, F, N, sms)
        bound = event_bytes(args) / HBM_BYTES_PER_S * 1e6
        print(f"event_resolve {label} ({G}, {F}, {N}): {int(args[5].sum())} pending, bound "
              f"{bound:.3f} us (bytes)", flush=True)
        for p in event_plans(er, G, F, N):
            got = er.event_resolve(*args, "greedy", plan=p)
            good = all(torch.equal(a, b) for a, b in zip(got, want))
            ok &= good
            us = device_us(torch, lambda: er.event_resolve(*args, "greedy", plan=p),
                           "event_resolve")
            print(f"  {p.route:7s} {p.cluster:2d} blocks a member of {p.span} flows, "
                  f"{p.vector} flows a lane a step: grid {p.grid} x "
                  f"{p.threads} threads, smem {p.smem}: {us:.2f} us"
                  f"{'' if good else ' MISMATCH'}{' <- plan' if p == chosen else ''}",
                  flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
