"""The end-to-end result type and objective of Algorithm 1.

`repro_torch.pipeline.Pipeline.run_batch` produces one `ScheduleResult`
per instance, field for field `repro.core.scheduler.ScheduleResult`.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.allocation import Allocation
from repro_torch.core.circuit import CoreSchedule
from repro_torch.core.coflow import CoflowInstance
from repro_torch.core.lp import LPSolution

__all__ = ["ScheduleResult", "total_weighted_cct"]


@dataclasses.dataclass
class ScheduleResult:
    scheme: str
    order: np.ndarray  # (M,) coflow ids, highest priority first
    allocation: Allocation
    core_schedules: list[CoreSchedule] | None
    ccts: np.ndarray  # (M,) realized completion times (original ids)
    total_weighted_cct: float
    lp: LPSolution | None
    wall_time_s: float


def total_weighted_cct(instance: CoflowInstance, ccts: np.ndarray) -> float:
    return float(np.dot(instance.weights, ccts))
