"""AdamW and its schedules (port of `repro.optim.adamw`).

The math is the reference's, elementwise in f32: a global-norm clip of
the gradients, bias correction from the integer step count, and weight
decay on matrices only (``ndim >= 2``).  Each product and sum rounds where
the reference's does (no fused multiply-add).

Where the reference's jitted step donates its buffers, the port updates
in place: `AdamW.update` writes the new parameters, moments (and f32
masters) into the tensors it is given and returns them, which keeps one
copy of each on the card.  Parameters are nested dicts and lists of
tensors (`repro_torch.tree`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from repro_torch import tree

__all__ = ["AdamW", "cosine_schedule", "constant_schedule"]

_F32 = torch.float32


def _f32(x: float) -> torch.Tensor:
    return torch.tensor(x, dtype=_F32)


def constant_schedule(lr: float) -> Callable[[int], float]:
    """``lr`` rounded to f32, at every step."""
    value = float(_f32(lr))
    return lambda step: value


def cosine_schedule(
    peak_lr: float, warmup_steps: int, total_steps: int, floor: float = 0.1
) -> Callable[[int], float]:
    """Linear warm-up to ``peak_lr``, then a cosine down to ``floor`` x
    ``peak_lr`` at ``total_steps``; computed in f32 as the reference does."""

    def fn(step: int) -> float:
        s = _f32(step)
        warm = s / max(warmup_steps, 1)
        t = (s - warmup_steps) / max(total_steps - warmup_steps, 1)
        cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * torch.clamp(t, 0, 1)))
        return float(peak_lr * (warm if step < warmup_steps else cos))

    return fn


@dataclasses.dataclass(frozen=True)
class AdamW:
    schedule: Callable[[int], float]
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    # Keep an f32 master copy in the optimizer state and hand the model
    # parameters in their own dtype (the reference's mixed-precision knob).
    master_weights: bool = False

    def init(self, params: Any) -> dict:
        zeros = lambda p: torch.zeros(p.shape, dtype=_F32, device=p.device)
        state = {
            "m": tree.map_leaves(zeros, params),
            "v": tree.map_leaves(zeros, params),
            "count": 0,
        }
        if self.master_weights:
            state["master"] = tree.map_leaves(lambda p: p.to(_F32, copy=True), params)
        return state

    @torch.no_grad()
    def update(self, params: Any, grads: Any, state: dict) -> tuple[Any, dict, dict]:
        """One step; returns (params, state, {"grad_norm", "lr"}), the
        tensors of ``params`` and ``state`` updated in place."""
        count = state["count"] + 1
        flat_g = tree.leaves(grads)
        # Global-norm clip: per-leaf sums of squares, added in leaf order.
        gnorm = None
        for g in flat_g:
            s = g.to(_F32).square().sum()
            gnorm = s if gnorm is None else gnorm + s
        gnorm = torch.sqrt(gnorm)
        scale = torch.clamp(self.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
        lr = self.schedule(count)
        b1, b2 = self.b1, self.b2
        c1 = float(1 - _f32(b1) ** count)
        c2 = float(1 - _f32(b2) ** count)
        flat_p = tree.leaves(params)
        flat_master = (
            tree.leaves(state["master"]) if self.master_weights else [None] * len(flat_p)
        )
        for p, g, m, v, master in zip(
            flat_p, flat_g, tree.leaves(state["m"]), tree.leaves(state["v"]), flat_master
        ):
            g = g.to(_F32) * scale
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_(((1 - b2) * g) * g)
            step = (m / c1) / (torch.sqrt(v / c2) + self.eps)
            ref = master if master is not None else p.to(_F32)
            if p.dim() >= 2:  # decay matrices only (norms and embeddings vary)
                step = step + self.weight_decay * ref
            new = ref - lr * step
            if master is not None:
                master.copy_(new)
            p.copy_(new)
        return params, {**state, "count": count}, {"grad_norm": gnorm, "lr": lr}
