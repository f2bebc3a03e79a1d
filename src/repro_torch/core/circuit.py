"""Result type of intra-core circuit scheduling (Algorithm 1 Lines 16-30).

The port runs the circuit calendar batched on the device
(`repro_torch.pipeline.batch_circuit`); this module holds only the
per-core result type and its sentinel, as in `repro.core.circuit`.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["CoreSchedule", "NOT_SCHEDULED"]

NOT_SCHEDULED = -1.0


@dataclasses.dataclass
class CoreSchedule:
    """Circuit schedule for one core: parallel arrays over that core's flows."""

    coflow: np.ndarray  # (F_k,) original coflow ids
    src: np.ndarray
    dst: np.ndarray
    size: np.ndarray
    establish: np.ndarray  # (F_k,) circuit establishment times t^k_m(i,j)
    complete: np.ndarray  # (F_k,) establish + delta + size / r^k
    rate: float
    delta: float
