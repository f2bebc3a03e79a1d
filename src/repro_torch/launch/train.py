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
from those of the reference's stacked tree.

``--checkpoint-dir`` saves the f32 masters and AdamW's state every
``--checkpoint-every`` steps (`repro_torch.checkpoint.checkpointer`, the
reference's layout, written on a thread), and ``--inject-failure f``
fails once at step f (`repro_torch.runtime.fault_tolerance`): with a
directory the run restores the newest save and goes on, without one it
exits.  Each step's time feeds the straggler tracker, and a straggler's log
line says so.  Without ``--full-config`` the config is reduced as the
reference reduces it (vocabulary at most 4096).

Usage:
  python -m repro_torch.launch.train --arch gemma3-1b --full-config --compress-grads
  python -m repro_torch.launch.train --arch gemma3-1b --steps 3 --device cpu
  python -m repro_torch.launch.train --arch gemma3-1b --steps 3 --plan-collectives --device cpu
  python -m repro_torch.launch.train --arch xlstm-1.3b --steps 6 --checkpoint-every 2 \
      --inject-failure 3 --checkpoint-dir /tmp/ckpt --device cpu
  python -m repro_torch.launch.train --arch musicgen-medium --steps 3 --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import time
from typing import Any, Callable

import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.collectives.planner import buckets_from_params, plan
from repro_torch.configs import get_arch
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import SyntheticTokens, make_batch_iterator
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_compressed_step, make_train_step
from repro_torch.models.model import build_model, param_count
from repro_torch.optim.adamw import AdamW, cosine_schedule
from repro_torch.runtime.fault_tolerance import (
    FailureInjector, NodeFailure, StragglerMitigator, run_with_restarts,
)

__all__ = ["TrainResult", "train", "main", "noise_seed"]


def noise_seed(step: int) -> int:
    """Seed of step ``step``'s stochastic-rounding noise: (7, step)."""
    return (7 << 32) | step


@dataclasses.dataclass
class TrainResult:
    """What `train` returns: the final parameters and optimizer state; per
    step run the step's index (``steps``: a restart runs indices again),
    loss, gradient norm and host-clock seconds (each step ends with its
    loss read on the host), and under compression the seconds of the
    exchange (`compressed_allreduce`, synchronized before and after) and
    the final error feedback.  With a checkpoint directory: restarts, the
    host seconds of each save's snapshot (``save_s``), of each write on
    the writer thread (``write_s``) and of each restore (``restore_s``).
    ``stragglers`` are the steps the straggler tracker flagged.  `main`
    with ``--plan-collectives`` adds the `CollectivePlan`."""

    params: Any
    opt_state: dict
    losses: list[float]
    grad_norms: list[float]
    step_s: list[float]
    exchange_s: list[float]
    error_feedback: Any
    plan: Any = None
    steps: list[int] = dataclasses.field(default_factory=list)
    restarts: int = 0
    stragglers: list[int] = dataclasses.field(default_factory=list)
    save_s: list[float] = dataclasses.field(default_factory=list)
    write_s: list[float] = dataclasses.field(default_factory=list)
    restore_s: list[float] = dataclasses.field(default_factory=list)


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
    checkpoint_dir: str | None = None,
    checkpoint_every: int = 25,
    inject_failure: int = 0,
) -> TrainResult:
    """Train ``cfg`` for ``steps`` steps of ``batch`` x ``seq`` tokens on
    ``device``, as the reference's ``main`` trains.

    ``params`` are the initial f32 masters (updated in place; the trainer
    keeps no reference to them beyond the state it trains, so a restored
    state frees them where the caller keeps none), else drawn from a
    generator seeded 0 on the device; a restart with no checkpoint
    to restore draws them so again, as the reference's ``make_state``
    does.  ``inspect(step, grads, errors, new_errors)``, if given, sees
    each compressed step's raw gradients and the error feedback before and
    after the exchange, outside the step's timing.

    With ``checkpoint_dir``, ``{"params", "opt"}`` is saved after every
    step ``s > 0`` with ``s % checkpoint_every == 0`` and a failure
    restores the newest save (`run_with_restarts`).  ``inject_failure=f >
    0`` fails once at the top of step ``f``; without a checkpoint
    directory that ends the run (`SystemExit`).  As in the reference, the
    batch iterator is not rewound (after a restore of step s, step s + 1
    reads the batch the failed step would have read), the error feedback
    carries over, and step s draws its noise from (7, s) each time it runs.
    """
    model = build_model(cfg, resolve_device(device))
    dev = model.device
    opt = AdamW(schedule=cosine_schedule(lr, steps // 10 + 1, steps))
    if compress_grads:
        step_fn = make_compressed_step(model, opt)
    else:
        step_fn = make_train_step(model, opt, num_microbatches=microbatches)
    data = make_batch_iterator(SyntheticTokens(
        cfg.vocab_size, seq, batch, num_codebooks=cfg.num_codebooks,
        encoder_shape=(cfg.encoder_len, cfg.encoder_dim) if cfg.encoder_dim else None,
    ))
    ckpt = Checkpointer(checkpoint_dir) if checkpoint_dir else None
    injector = FailureInjector(
        fail_at_steps=(inject_failure,) if inject_failure else (),
        max_failures=1,  # one-shot: the "node" is replaced after restart
    )
    straggler = StragglerMitigator()
    out = TrainResult(None, None, [], [], [], [], None)
    error_fb = None
    # The first state takes the initial masters and nothing else here keeps
    # them: after a restart the restored state replaces them on the card.
    initial, params = params, None

    def make_state():
        nonlocal initial
        p, initial = initial, None
        if p is None:
            p = model.init(torch.Generator(device=dev).manual_seed(0), masters=True)
        return {"params": p, "opt": opt.init(p)}

    def train_loop(state, start_step):
        nonlocal error_fb
        params, opt_state = state["params"], state["opt"]
        for step in range(start_step, steps):
            injector.check(step)
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
            slow = straggler.observe(step, dt)
            out.steps.append(step)
            out.losses.append(loss_v)
            out.grad_norms.append(gnorm)
            out.step_s.append(dt)
            if step % log_every == 0 or step == steps - 1:
                print(f"step {step:5d} loss {loss_v:7.4f} gnorm {gnorm:8.3f} "
                      f"{dt * 1e3:7.1f} ms{'  [straggler]' if slow else ''}", flush=True)
            if ckpt and step and step % checkpoint_every == 0:
                ckpt.save(step, {"params": params, "opt": opt_state})
        return {"params": params, "opt": opt_state}

    try:
        if ckpt:
            state, out.restarts = run_with_restarts(make_state, train_loop, ckpt, steps)
            if out.restarts:
                print(f"recovered from {out.restarts} failure(s) via checkpoint restore")
        else:
            try:
                state = train_loop(make_state(), 0)
            except NodeFailure as e:
                raise SystemExit(
                    f"{e} — rerun with --checkpoint-dir for automatic recovery"
                ) from None
    finally:
        data.close()
        if ckpt:
            ckpt.wait()
    if ckpt:
        out.save_s, out.write_s, out.restore_s = ckpt.save_s, ckpt.write_s, ckpt.restore_s
    out.stragglers = straggler.stragglers
    out.params, out.opt_state, out.error_feedback = state["params"], state["opt"], error_fb
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

    cfg = config_for(args.arch, args.full_config, args.d_model, args.layers)
    model = build_model(cfg, args.device)
    # Handed on, not kept: `train` holds the only reference (see its doc).
    initial = [model.init(torch.Generator(device=model.device).manual_seed(0), masters=True)]
    print(f"training {cfg.name} ({param_count(initial[0]) / 1e6:.1f}M params) on 1 "
          f"device ({model.device}), {args.steps} steps")
    cplan = None
    if args.plan_collectives:
        buckets = buckets_from_params(initial[0], bucket_bytes=16 << 20)
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
        log_every=args.log_every, device=model.device, params=initial.pop(), inspect=inspect,
        checkpoint_dir=args.checkpoint_dir, checkpoint_every=args.checkpoint_every,
        inject_failure=args.inject_failure,
    )
    res.plan = cplan
    print("done.")
    return res


if __name__ == "__main__":
    main()
