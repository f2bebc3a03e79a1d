"""Global coflow ordering policies (Algorithm 1 stage 1 + baselines).

Port of `repro.core.ordering`: the LP-guided order, and the baselines'
WSPT and FIFO orders in host NumPy (the per-instance oracles of the
batched `WsptOrder` / `FifoOrder` stages).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import lp as lp_mod
from repro_torch.core.coflow import CoflowInstance
from repro_torch.device import resolve_device

__all__ = ["lp_guided_order", "wspt_order", "fifo_order"]


def lp_guided_order(
    instance: CoflowInstance,
    method: str = "exact",
    device: str | torch.device = "cuda",
    **kwargs,
) -> tuple[np.ndarray, lp_mod.LPSolution]:
    """LP-guided order: solve the ordering LP, sort by non-decreasing T~_m.

    ``method="exact"`` solves with HiGHS on the host; ``"subgradient"``
    runs `solve_subgradient` on ``device`` (``kwargs`` go to it).
    """
    device = resolve_device(device)
    if method == "exact":
        sol = lp_mod.solve_exact(instance)
    elif method == "subgradient":
        sol = lp_mod.solve_subgradient(instance, device=device, **kwargs)
    else:
        raise ValueError(f"unknown LP method {method!r}")
    return sol.order(), sol


def wspt_order(instance: CoflowInstance) -> np.ndarray:
    """WSPT-ORDER baseline [31]: non-increasing w_m / T_LB(D_m).

    T_LB(D_m) = delta + rho_m / R is the allocation-independent single-coflow
    lower bound (paper Sec. V-B).
    """
    score = instance.weights / np.maximum(instance.global_lower_bound(), 1e-300)
    return np.argsort(-score, kind="stable")


def fifo_order(instance: CoflowInstance) -> np.ndarray:
    """Release-time FIFO (ties by index) -- ablation reference."""
    return np.argsort(instance.releases, kind="stable")
