#!/usr/bin/env python3
"""Device time of the LP-terms kernels under every tile choice, on one
NVIDIA GPU.

    python3 scripts/lp_terms_tiles.py

For each of four shapes (one paper instance, M = 100, P = 20, through
`lp_terms`; the paper bucket B = 32, M = 104, P = 24, and a 300-port
bucket B = 4, M = 64, through `lp_terms_batch`; the whole trace, M = 526,
P = 300, through `lp_terms`), launches the kernel under every (rows a
block, rows a thread, chunk groups) that `kernels.lp_terms.tiles` allows,
through the wrappers' ``tiling``, checks each result against the plain
twin within `rtol(M)` and bit for bit against the plan's own, and
prints the profiler's device microseconds per launch (30 launches)
beside the one `plan` picks, and the device time of the library call
(two batched products and a row max).  Exits non-zero if a
result disagrees or there is no card.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

SHAPES = [(1, 100, 20, "single"), (32, 104, 24, "batch"), (4, 64, 300, "batch"),
          (1, 526, 300, "single")]
LAUNCHES = 30


def inputs(torch, B, M, P):
    rng = np.random.default_rng(M + P)
    Y = np.triu(rng.random((B, M, M)), 1)
    X = Y + np.tril(1 - np.swapaxes(Y, 1, 2), -1) + np.eye(M)
    arrays = (X, rng.uniform(0, 50, (B, M, P)), rng.integers(0, 10, (B, M, P)),
              rng.uniform(0.01, 0.1, B), rng.uniform(0.0, 3.0, B))
    return [torch.from_numpy(np.asarray(a, dtype=np.float32)).cuda() for a in arrays]


def run(lt, kind, args, p):
    """One call of ``kind`` under tiling ``p``, through the public wrapper;
    (B, M) outputs.  ``args`` ends with the scales as Python floats for
    `lp_terms`."""
    X, rho, tau, inv_R, dok, scales = args
    if kind == "batch":
        return lt.lp_terms_batch(X, rho, tau, inv_R, dok, tiling=p)
    return tuple(t[None] for t in lt.lp_terms(X[0], rho[0], tau[0], *scales, tiling=p))


def device_us(torch, fn, name):
    """Device microseconds per call of ``fn`` over the kernels whose names
    contain ``name`` (every kernel where ``name`` is None)."""
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("lp_terms_tiles: no CUDA device available", file=sys.stderr)
        return 1
    from repro_torch.kernels import common
    from repro_torch.kernels import lp_terms as lt

    torch.backends.cuda.matmul.allow_tf32 = False
    sms = common.sm_count(torch.device("cuda"))
    print(torch.cuda.get_device_name(0), f"{sms} SMs", flush=True)
    ok = True
    one = torch.zeros(1, device="cuda")
    print(f"floor: one fill kernel of 1 value {device_us(torch, lambda: one.fill_(1.0), None):.2f} "
          f"us device", flush=True)
    for B, M, P, kind in SHAPES:
        X, rho, tau, inv_R, dok = inputs(torch, B, M, P)
        args = (X, rho, tau, inv_R, dok, (float(inv_R[0]), float(dok[0])))
        want = lt.lp_terms_batch_plain(X, rho, tau, inv_R, dok)
        chosen = lt.plan(B, M, P, sms)
        ref = run(lt, kind, args, chosen)
        Xt = X.transpose(1, 2)
        lib = device_us(torch, lambda: (torch.bmm(Xt, rho).amax(dim=2) * inv_R[:, None],
                                        torch.bmm(Xt, tau).amax(dim=2) * dok[:, None]), None)
        print(f"{kind} (B={B}, M={M}, P={P}): library (bmm x2 + amax) {lib:.2f} us device",
              flush=True)
        combos = sorted({(rows, tm, min(kg, -(-M // lt.CHUNK)))
                         for rows in (32, 16, 8) for tm in (2, 1) for kg in (4, 2, 1)},
                        reverse=True)
        for rows, tm, kg in combos:
            p = lt.tiles(B, M, P, rows, tm, kg)
            if p.threads > 512:
                continue
            got = run(lt, kind, args, p)
            torch.cuda.synchronize()
            good = all(bool((a - b).abs().le(lt.rtol(M) * b.abs()).all()) and torch.equal(a, c)
                       for a, b, c in zip(got, want, ref))
            ok &= good
            us = device_us(torch, lambda: run(lt, kind, args, p), "lp_terms")
            print(f"  rows {rows:2d} x {tm} a thread, {p.groups} groups: grid {p.grid}, "
                  f"{p.threads} threads, split {p.split}, smem {p.smem}: {us:.2f} us"
                  f"{'' if good else ' MISMATCH'}{' <- plan' if p == chosen else ''}",
                  flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
