#!/usr/bin/env python3
"""Host cost of two pieces of the mesh sharding on one NVIDIA GPU.

    python3 scripts/mesh_costs.py

1. The batched LP pads its members to a multiple of
   `repro_torch.core.lp.PRODUCT_MEMBERS` on a card, so that a member's
   bits do not depend on the member count.  A streaming epoch solves one
   member: the script times `solve_subgradient_batch_arrays` at B = 1 for
   the streaming cells' pool shapes (16 coflows x 48 flat ports, 600
   steps; 32 x 96, 900 steps) padded and unpadded, in turns.
2. `repro_torch.kernels.common.launch` makes the operands' card current
   around each C entry.  The script times 2000 `pair_resolve` calls at the
   main path's (96, 12, 12) with that `launch` and with one that calls
   the entry directly, in turns.

Seconds are host seconds around work ending in a synchronize, each case
run in turns with the other; the card's name and power limit lead the
output.
"""

from __future__ import annotations

import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def timed(torch, fn, runs):
    out = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("mesh_costs: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import lp
    from repro_torch.kernels import common
    from repro_torch.kernels import pair_resolve as pr
    from repro_torch.traffic.instances import sample_instance

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    print(smi.stdout.strip().splitlines()[0], flush=True)
    common.library()

    fixed_runs = lp._fixed_runs
    for M, N, iters in ((16, 24, 600), (32, 48, 900)):
        arrays = lp.pack_lp_arrays([sample_instance(num_coflows=M, num_ports=N, seed=0)])
        seconds = {"padded": [], "unpadded": []}
        for case in ("padded", "unpadded") * 2:
            lp._fixed_runs = fixed_runs if case == "padded" else (lambda t: False)
            seconds[case] += timed(
                torch, lambda: lp.solve_subgradient_batch_arrays(arrays, iters=iters), 3)
        lp._fixed_runs = fixed_runs
        print(f"LP B=1 M={M} P={2 * N} {iters} steps: " + "; ".join(
            f"{k} median {statistics.median(v):.4f} s ({', '.join(f'{x:.4f}' for x in v)})"
            for k, v in seconds.items()), flush=True)

    def direct(name, *args, device):
        err = getattr(common.library(), name)(*args)
        if err:
            raise RuntimeError(f"CUDA kernel {name} failed to launch ({err})")

    G, N = 96, 12
    claim = torch.randint(0, 50, (G, N, N), device="cuda", dtype=torch.int32)
    idle = torch.rand((G, N, N), device="cuda") < 0.5
    calls = 2000
    us = {"launch": [], "direct": []}
    for case in ("launch", "direct") * 2:
        pr.launch = common.launch if case == "launch" else direct
        us[case] += [1e6 * s / calls for s in timed(
            torch, lambda: [pr.pair_resolve(claim, idle) for _ in range(calls)], 3)]
    pr.launch = common.launch
    print(f"pair_resolve {G} x {N} x {N}, {calls} calls: " + "; ".join(
        f"{k} median {statistics.median(v):.2f} us a call ({', '.join(f'{x:.2f}' for x in v)})"
        for k, v in us.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
