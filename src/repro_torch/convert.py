"""Carry objects of the JAX package over into the port.

This system has data where a model has weights: the tests hand both
packages the same instances and LP solutions through `from_reference`.
It reads the reference's objects by their fields only (NumPy arrays and
floats) and imports nothing of the JAX package.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core.allocation import Allocation
from repro_torch.core.coflow import CoflowInstance
from repro_torch.core.lp import LP_ARRAY_NAMES, LPSolution
from repro_torch.device import resolve_device

__all__ = ["from_reference"]


def from_reference(obj: Any, device: str | torch.device) -> Any:
    """The port's counterpart of a JAX-package object.

    * ``CoflowInstance`` -> `repro_torch.core.coflow.CoflowInstance`;
    * ``LPSolution`` -> `repro_torch.core.lp.LPSolution`;
    * ``Allocation`` -> `repro_torch.core.allocation.Allocation`;
    * the ``pack_lp_arrays`` dict -> the same dict of tensors on ``device``.

    The NumPy-valued results live on the host; ``device`` places tensors.
    """
    device = resolve_device(device)
    kind = type(obj).__name__
    if kind == "CoflowInstance":
        return CoflowInstance(
            demands=np.array(obj.demands), weights=np.array(obj.weights),
            releases=np.array(obj.releases), rates=np.array(obj.rates),
            delta=float(obj.delta),
        )
    if kind == "LPSolution":
        return LPSolution(
            completion=np.array(obj.completion, dtype=np.float64),
            precedence=np.array(obj.precedence, dtype=np.float64),
            objective=float(obj.objective), method=str(obj.method),
            iterations=int(obj.iterations),
        )
    if kind == "Allocation":
        return Allocation(
            **{
                f: np.array(getattr(obj, f))
                for f in (
                    "coflow", "src", "dst", "size", "core", "rho_ports",
                    "tau_ports", "prefix_lb",
                )
            }
        )
    if isinstance(obj, dict) and set(obj) == set(LP_ARRAY_NAMES):
        return {
            k: torch.from_numpy(np.array(obj[k])).to(device)
            for k in LP_ARRAY_NAMES
        }
    raise TypeError(f"from_reference: no counterpart for {kind}")
