"""The trainer (port of `repro.launch.train`).

Wires together the model, the train step (microbatched), the synthetic
data pipeline and, under ``--compress-grads``, the int8 gradient exchange
with error feedback (`repro_torch.runtime.compression`, on the `quantize`
and `dequantize` kernels).  Parameters are f32 masters on the device,
cast to the compute dtype at each use, as the reference holds them.

As the reference does, a compressed step (`make_compressed_step`) takes
the whole batch with no microbatching (``--microbatches`` is not read
then), exchanges the gradients through `compressed_allreduce`, then
applies AdamW.  The
stochastic-rounding noise is the port's own stream: step ``s`` draws each
leaf's noise in leaf order from a generator seeded from (7, s), where the
reference folds ``s`` and the leaf index into ``PRNGKey(7)``.

``--plan-collectives`` plans the gradient exchange before the first
step, as the reference does: `repro_torch.collectives.planner` buckets the
model's own parameter tree (16 MB buckets) and runs Algorithm 1 over two
pods on the trainer's device; the plan is printed and kept on the result
(`TrainResult.plan`).  The port's tree is per layer, so its buckets differ
from those of the reference's stacked tree.  Not ported yet:
``--checkpoint-dir`` and ``--inject-failure`` (with the straggler tracker;
ROADMAP.md Queue 1 item 10); they raise.  Without ``--full-config`` the
config is reduced as the reference reduces it (vocabulary at most 4096).

Usage:
  python -m repro_torch.launch.train --arch gemma3-1b --full-config --compress-grads
  python -m repro_torch.launch.train --arch gemma3-1b --steps 3 --device cpu
  python -m repro_torch.launch.train --arch gemma3-1b --steps 3 --plan-collectives --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import time
from typing import Any, Callable

import torch

from repro_torch.collectives.planner import buckets_from_params, plan
from repro_torch.configs import get_arch
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import SyntheticTokens, make_batch_iterator
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_compressed_step, make_train_step
from repro_torch.models.model import build_model, param_count
from repro_torch.optim.adamw import AdamW, cosine_schedule

__all__ = ["TrainResult", "train", "main", "noise_seed"]


def noise_seed(step: int) -> int:
    """Seed of step ``step``'s stochastic-rounding noise: (7, step)."""
    return (7 << 32) | step


@dataclasses.dataclass
class TrainResult:
    """What `train` returns: the final parameters and optimizer state; per
    step the loss, the gradient norm and host-clock seconds (each step
    ends with its loss read on the host), and under compression the
    seconds of the exchange (`compressed_allreduce`, synchronized before
    and after) and the final error feedback.  `main` with
    ``--plan-collectives`` adds the `CollectivePlan`."""

    params: Any
    opt_state: dict
    losses: list[float]
    grad_norms: list[float]
    step_s: list[float]
    exchange_s: list[float]
    error_feedback: Any
    plan: Any = None


def train(
    cfg: ModelConfig,
    *,
    steps: int,
    batch: int,
    seq: int,
    lr: float = 3e-3,
    microbatches: int = 1,
    compress_grads: bool = False,
    log_every: int = 10,
    device: str | torch.device = "cuda",
    params: Any = None,
    inspect: Callable | None = None,
) -> TrainResult:
    """Train ``cfg`` for ``steps`` steps of ``batch`` x ``seq`` tokens on
    ``device``.

    ``params`` are the initial f32 masters (updated in place), else drawn
    from a generator seeded 0 on the device.  ``inspect(step, grads,
    errors, new_errors)``, if given, sees each compressed step's raw
    gradients and the error feedback before and after the exchange,
    outside the step's timing.
    """
    model = build_model(cfg, resolve_device(device))
    dev = model.device
    if params is None:
        params = model.init(torch.Generator(device=dev).manual_seed(0), masters=True)
    opt = AdamW(schedule=cosine_schedule(lr, steps // 10 + 1, steps))
    if compress_grads:
        step_fn = make_compressed_step(model, opt)
    else:
        step_fn = make_train_step(model, opt, num_microbatches=microbatches)
    opt_state = opt.init(params)
    data = make_batch_iterator(SyntheticTokens(cfg.vocab_size, seq, batch))
    error_fb = None
    out = TrainResult(params, opt_state, [], [], [], [], None)
    try:
        for step in range(steps):
            t0 = time.perf_counter()
            batch_np = next(data)
            if compress_grads:
                gen = torch.Generator(device=dev).manual_seed(noise_seed(step))
                hook = None if inspect is None else functools.partial(inspect, step)
                params, opt_state, error_fb, stats = step_fn(
                    params, opt_state, error_fb, batch_np, gen, hook)
                out.exchange_s.append(stats["exchange_s"])
            else:
                params, opt_state, stats = step_fn(params, opt_state, batch_np)
            loss_v = float(stats["loss"])  # ends the step on the host
            dt = time.perf_counter() - t0 - stats.get("inspect_s", 0.0)
            gnorm = float(stats["grad_norm"])
            out.losses.append(loss_v)
            out.grad_norms.append(gnorm)
            out.step_s.append(dt)
            if step % log_every == 0 or step == steps - 1:
                print(f"step {step:5d} loss {loss_v:7.4f} gnorm {gnorm:8.3f} "
                      f"{dt * 1e3:7.1f} ms", flush=True)
    finally:
        data.close()
    out.params, out.opt_state, out.error_feedback = params, opt_state, error_fb
    return out


def config_for(
    arch: str, full_config: bool = False, d_model: int = 0, layers: int = 0
) -> ModelConfig:
    """``arch``'s config, reduced as the reference's trainer reduces it
    unless ``full_config``."""
    cfg = get_arch(arch)
    if full_config:
        return cfg
    overrides: dict = {}
    if d_model:
        overrides.update(d_model=d_model, head_dim=max(d_model // 4, 8))
    if layers:
        overrides["num_layers"] = layers
    return cfg.reduced(vocab_size=min(cfg.vocab_size, 4096), **overrides)


def main(argv=None, *, inspect: Callable | None = None) -> TrainResult:
    """The reference's CLI and defaults, plus ``--device`` (the card by
    default).  ``inspect`` is passed to `train`."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--full-config", action="store_true")
    ap.add_argument("--d-model", type=int, default=0, help="override width")
    ap.add_argument("--layers", type=int, default=0, help="override depth")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=25)
    ap.add_argument("--inject-failure", type=int, default=0)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--plan-collectives", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.checkpoint_dir or args.inject_failure:
        raise NotImplementedError(
            "--checkpoint-dir / --inject-failure: checkpointing and failure "
            "recovery are not ported yet (ROADMAP.md, Queue 1 item 10)"
        )
    cfg = config_for(args.arch, args.full_config, args.d_model, args.layers)
    model = build_model(cfg, args.device)
    params = model.init(torch.Generator(device=model.device).manual_seed(0), masters=True)
    print(f"training {cfg.name} ({param_count(params) / 1e6:.1f}M params) on 1 "
          f"device ({model.device}), {args.steps} steps")
    cplan = None
    if args.plan_collectives:
        buckets = buckets_from_params(params, bucket_bytes=16 << 20)
        cplan = plan(buckets, num_pods=2, device=model.device)
        print(
            f"[planner] {len(buckets)} gradient buckets -> "
            f"CCT ours {cplan.cct_ours:.1f} ms vs FIFO {cplan.cct_fifo:.1f} ms "
            f"(speedup {cplan.speedup:.2f}x); issue order: "
            + ", ".join(cplan.order[:6])
            + ("..." if len(cplan.order) > 6 else "")
        )
    res = train(
        cfg, steps=args.steps, batch=args.batch, seq=args.seq, lr=args.lr,
        microbatches=args.microbatches, compress_grads=args.compress_grads,
        log_every=args.log_every, device=model.device, params=params, inspect=inspect,
    )
    res.plan = cplan
    print("done.")
    return res


if __name__ == "__main__":
    main()
