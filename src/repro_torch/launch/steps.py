"""The step functions (port of `repro.launch.steps`, and of the reference
trainer's ``--compress-grads`` step), run by the trainer, the server's
callers and the dry-run (`repro_torch.launch.dryrun`).

  train_step(params, opt_state, batch) -> (params, opt_state, metrics)
  compressed_step(params, opt_state, errors, batch, noise, inspect=None)
      -> (params, opt_state, errors, metrics)
  prefill_step(params, batch)           -> (last_logits, cache)
  serve_step(params, cache, batch, pos) -> (logits, cache)   [one new token]
"""

from __future__ import annotations

import time
from typing import Any, Callable

import torch

from repro_torch import tree
from repro_torch.kernels.common import is_dtensor
from repro_torch.models.model import Model
from repro_torch.optim.adamw import AdamW, constant_schedule
from repro_torch.runtime.compression import Noise, compressed_allreduce, init_error_feedback

__all__ = [
    "make_train_step", "make_compressed_step", "make_prefill_step", "make_serve_step",
    "loss_and_grad", "zero_accumulators", "accumulate_microbatch", "default_optimizer",
]


def default_optimizer() -> AdamW:
    return AdamW(schedule=constant_schedule(3e-4))


def loss_and_grad(model: Model, params: Any, batch: dict) -> tuple[torch.Tensor, Any]:
    """(loss, gradient tree shaped like ``params``): ``jax.value_and_grad``
    of `Model.loss`.  The parameters require grad only for this call."""
    leaves = tree.leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        with torch.enable_grad():
            loss = model.loss(params, batch)
            grads = torch.autograd.grad(loss, leaves)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    return loss.detach(), tree.unflatten(params, list(grads))


def make_train_step(model: Model, optimizer: AdamW | None = None, num_microbatches: int = 1):
    """Train step with optional gradient accumulation: the batch's rows
    split into ``num_microbatches`` consecutive parts, ``l / n`` and
    ``g / n`` accumulated in f32 from zeros, as the reference's scan does."""
    opt = optimizer or default_optimizer()
    n = num_microbatches

    def train_step(params, opt_state, batch):
        if n == 1:
            loss, grads = loss_and_grad(model, params, batch)
        else:
            rows = len(batch["tokens"]) // n
            loss, grads = zero_accumulators(model, params)
            for i in range(n):
                micro = {k: v[i * rows : (i + 1) * rows] for k, v in batch.items()}
                loss = accumulate_microbatch(model, params, micro, loss, grads, n)
        params, opt_state, stats = opt.update(params, grads, opt_state)
        return params, opt_state, {"loss": loss, **stats}

    return train_step


def zero_accumulators(model: Model, params: Any) -> tuple[torch.Tensor, Any]:
    """The f32 zero loss and gradient tree the microbatches add into."""
    loss = torch.zeros((), dtype=torch.float32, device=model.device)
    grads = tree.map_leaves(
        lambda p: torch.zeros_like(p, dtype=torch.float32) if is_dtensor(p)
        else torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
    return loss, grads


def accumulate_microbatch(model: Model, params: Any, micro: dict, loss: torch.Tensor,
                          grads: Any, n: int) -> torch.Tensor:
    """One microbatch of ``n``: ``g / n`` added into ``grads`` in place;
    returns ``loss + l / n``."""
    l, g = loss_and_grad(model, params, micro)
    for acc, gi in zip(tree.leaves(grads), tree.leaves(g)):
        acc.add_(gi / n)
    return loss + l / n


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_compressed_step(model: Model, optimizer: AdamW | None = None):
    """The reference trainer's ``--compress-grads`` step: the whole batch
    (no microbatching), the int8 exchange with error feedback
    (`compressed_allreduce`), then the update.

    ``errors`` is the error feedback (None before the first step);
    ``noise`` is the step's rounding noise, a generator or per-leaf
    tensors.  ``inspect(grads, errors, new_errors)``, if given, sees the
    raw gradients and the error feedback before and after the exchange.
    The metrics add to the loss and the optimizer's stats ``exchange_s``,
    the host-clock seconds of the exchange (the device synchronized before
    and after), and ``inspect_s``, those of ``inspect``."""
    opt = optimizer or default_optimizer()

    def compressed_step(params, opt_state, errors, batch, noise: Noise,
                        inspect: Callable | None = None):
        loss, grads = loss_and_grad(model, params, batch)
        if errors is None:
            errors = init_error_feedback(params)
        _sync(model.device)
        t0 = time.perf_counter()
        restored, new_errors = compressed_allreduce(grads, errors, noise)
        _sync(model.device)
        t1 = time.perf_counter()
        if inspect is not None:
            inspect(grads, errors, new_errors)
        inspect_s = time.perf_counter() - t1
        del grads
        params, opt_state, stats = opt.update(params, restored, opt_state)
        return params, opt_state, new_errors, {
            "loss": loss, **stats, "exchange_s": t1 - t0, "inspect_s": inspect_s}

    return compressed_step


def make_prefill_step(model: Model):
    def prefill_step(params, batch):
        return model.prefill(params, batch)

    return prefill_step


def make_serve_step(model: Model):
    def serve_step(params, cache, batch, pos):
        return model.decode_step(params, cache, batch, pos)

    return serve_step
