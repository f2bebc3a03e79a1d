#!/usr/bin/env python3
"""Device time of the `port_stats` kernel under every plan, on one NVIDIA
GPU.

    python3 scripts/port_stats_tiles.py

Launches `port_stats` on random demands from a seed (half the entries
zero) at (M, N, N) = (3200, 10, 10) (the main path's ensemble), (100, 10,
10) (one paper instance), (192, 48, 48), (256, 150, 150) (`wide`),
(526, 150, 150) (the whole `fb_full` trace) and (64, 240, 240), and at
(256, N, N) on either side of the route switch (`port_stats.SMALL_PORTS`),
under every plan the wrapper takes (`tilings`, through its ``plan``).
Each result is held against the plain twin bit for bit (the plan's also
against host NumPy); each line prints the profiler's device microseconds
per launch (30 launches) beside the byte bound at 3.35 TB/s (f64 demands
in, f64 rho and int32 tau out) and marks the plan `plan` picks.  Exits
non-zero if a result disagrees or there is no card.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT.parent / "src"))
sys.path.insert(0, str(ROOT))

HBM_BYTES_PER_S = 3.35e12

# (M, N): the timed shapes and one paper instance; `main` adds either side
# of the route switch.
SHAPES = [(3200, 10), (100, 10), (192, 48), (256, 150), (526, 150), (64, 240)]


def demands(torch, M, N, seed):
    """(M, N, N) f64 on the card: uniform in [0, 100), half of them zero."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    d = torch.rand((M, N, N), generator=g, device="cuda", dtype=torch.float64) * 100.0
    return torch.where(torch.rand((M, N, N), generator=g, device="cuda") < 0.5, d, 0.0)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("port_stats_tiles: no CUDA device available", file=sys.stderr)
        return 1
    from resolve_tiles import device_us
    from repro_torch.kernels import common
    from repro_torch.kernels import port_stats as ps

    dev = torch.device("cuda")
    sms = common.sm_count(dev)
    common.library()
    print(torch.cuda.get_device_name(0), f"{sms} SMs", flush=True)
    one = torch.zeros(1, device=dev)
    print(f"floor: one fill kernel of 1 value {device_us(torch, lambda: one.fill_(1.0), None):.2f} "
          f"us device", flush=True)
    ok = True
    for M, N in SHAPES + [(256, ps.SMALL_PORTS), (256, ps.SMALL_PORTS + 1)]:
        d = demands(torch, M, N, seed=M + N)
        want = ps.port_stats_plain(d)
        chosen = ps.plan(M, N, sms)
        dh = d.cpu().numpy()
        host = np.concatenate([dh.sum(axis=2), dh.sum(axis=1)], axis=-1)
        good = np.array_equal(ps.port_stats(d)[0].cpu().numpy(), host)
        ok &= good
        bound = (M * N * N * 8 + M * 2 * N * 12) / HBM_BYTES_PER_S * 1e6
        print(f"port_stats ({M}, {N}, {N}): bound {bound:.3f} us (bytes); plan vs host "
              f"NumPy {'exact' if good else 'MISMATCH'}", flush=True)
        for p in ps.tilings(M, N) + ([chosen] if chosen not in ps.tilings(M, N) else []):
            got = ps.port_stats(d, plan=p)
            good = all(torch.equal(a, b) for a, b in zip(got, want))
            ok &= good
            us = device_us(torch, lambda: ps.port_stats(d, plan=p), "port_stats")
            shape = (f"{p.per_block} matrices a block" if p.route == "small"
                     else f"{p.rows} rows a slab, {p.stages} slabs")
            print(f"  {p.route:6s} {shape}: grid {p.grid} x {p.threads} threads, smem "
                  f"{p.smem}: {us:.2f} us{'' if good else ' MISMATCH'}"
                  f"{' <- plan' if p == chosen else ''}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
