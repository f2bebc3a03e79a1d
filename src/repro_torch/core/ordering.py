"""LP-guided global coflow order (Algorithm 1 stage 1).

Port of `repro.core.ordering.lp_guided_order`.  The baselines' orders
(WSPT, FIFO) come with the other registry schemes.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import lp as lp_mod
from repro_torch.core.coflow import CoflowInstance
from repro_torch.device import resolve_device

__all__ = ["lp_guided_order"]


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
