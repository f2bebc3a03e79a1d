#!/usr/bin/env python3
"""Device memory peaks of each part of a training step, with and without
the per-unit recompute, on one NVIDIA GPU.

    python3 scripts/train_peaks.py --arch xlstm-1.3b --seq 512
    python3 scripts/train_peaks.py --arch gemma3-1b --seq 1024

Trains the architecture at its published widths through
`repro_torch.launch.train.train` with compressed gradients (the smoke's
phases 8 and 13), twice: as the port runs it (each unit of
``layer_unit`` under `torch.utils.checkpoint`) and with the units run
whole (the loss chunks keep their checkpoint).  Each call of the step's
parts -- the loss and its gradients, the compressed exchange, the AdamW
update -- is bracketed by a synchronize: the bytes allocated before it and
`torch.cuda.max_memory_allocated` over it are printed, with each step's
host seconds, the card's name and power limit.  The brackets'
synchronizes add to the step times; compare the variants within one run.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="xlstm-1.3b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("train_peaks: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_arch
    from repro_torch.launch import steps as S
    from repro_torch.launch import train as T
    from repro_torch.models import model as M
    from repro_torch.optim import adamw as A

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    calls: list[tuple[str, float, float]] = []

    def bracket(owner, name, label):
        real = getattr(owner, name)

        def fn(*a, **kw):
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            out = real(*a, **kw)
            torch.cuda.synchronize()
            calls.append((label, before / 1e9, torch.cuda.max_memory_allocated() / 1e9))
            return out

        setattr(owner, name, fn)

    bracket(S, "loss_and_grad", "loss and gradients")
    bracket(S, "compressed_allreduce", "exchange")
    bracket(A.AdamW, "update", "update")
    cfg = get_arch(args.arch)
    remat = M.checkpoint

    def units_whole(fn, *a, **kw):
        return fn(*a) if fn.__name__ == "_layers" else remat(fn, *a, **kw)

    out = {"card": card, "arch": cfg.name, "batch": args.batch, "seq": args.seq}
    for variant, fn in (("unit recompute", remat), ("no unit recompute", units_whole)):
        M.checkpoint = fn
        calls.clear()
        t0 = time.perf_counter()
        res = T.train(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                      compress_grads=True, log_every=args.steps)
        wall = time.perf_counter() - t0
        peaks = {}
        for label, _, peak in calls:
            peaks[label] = max(peaks.get(label, 0.0), peak)
        print(f"{variant}: {cfg.name} {args.batch} x {args.seq} tokens, steps (s) "
              f"{[round(x, 4) for x in res.step_s]}, wall {wall:.2f} s; peak GB by part "
              f"{json.dumps({k: round(v, 3) for k, v in peaks.items()})} on {card}", flush=True)
        for label, before, peak in calls:
            print(f"  {label}: {before:.3f} GB allocated before, peak {peak:.3f} GB", flush=True)
        out[variant] = {"step_s": res.step_s, "peak_gb": peaks}
        del res
        torch.cuda.empty_cache()
    M.checkpoint = remat
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
