"""The end-to-end result type, the objective and tail helpers, and the
per-instance flow-priority and per-core scheduling primitives.

Port of `repro.core.scheduler`, less its scheme runners: the schemes run
through `repro_torch.pipeline` (`get_pipeline(scheme).run_batch`), which
produces one `ScheduleResult` per instance.  `_flow_priorities` and
`_schedule_all_cores` are the host NumPy primitives the per-instance
circuit stages (`ListCircuit.schedule`, `SequentialCircuit`,
`FluidCircuit`) and the batched calendar's member tables build on.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.allocation import Allocation
from repro_torch.core.circuit import CoreSchedule, schedule_core, schedule_core_sequential
from repro_torch.core.coflow import CoflowInstance
from repro_torch.core.lp import LPSolution

__all__ = ["ScheduleResult", "total_weighted_cct", "tail_cct"]


@dataclasses.dataclass
class ScheduleResult:
    scheme: str
    order: np.ndarray  # (M,) coflow ids, highest priority first
    allocation: Allocation
    core_schedules: list[CoreSchedule] | None  # None for BvN / EPS (no circuits kept)
    ccts: np.ndarray  # (M,) realized completion times (original ids)
    total_weighted_cct: float
    lp: LPSolution | None
    wall_time_s: float

    def normalized_to(self, other: "ScheduleResult") -> float:
        return self.total_weighted_cct / other.total_weighted_cct


def total_weighted_cct(instance: CoflowInstance, ccts: np.ndarray) -> float:
    return float(np.dot(instance.weights, ccts))


def tail_cct(ccts: np.ndarray, q: float) -> float:
    """p-quantile CCT (paper reports p95/p99)."""
    return float(np.quantile(ccts, q))


def _flow_priorities(alloc: Allocation, order: np.ndarray, M: int) -> np.ndarray:
    """Priority per flow: coflow global rank, intra-coflow allocation order."""
    pos = np.empty(M, dtype=np.int64)
    pos[order] = np.arange(M)
    # Allocation emits flows in (order, largest-first) sequence, so the flow's
    # index within the table is already the intra-coflow tie-break.
    F = alloc.num_flows()
    return pos[alloc.coflow].astype(np.float64) * (F + 1) + np.arange(F)


def _schedule_all_cores(
    instance: CoflowInstance,
    alloc: Allocation,
    order: np.ndarray,
    sequential: bool = False,
    discipline: str = "reserving",
) -> list[CoreSchedule]:
    M, N, K = instance.num_coflows, instance.num_ports, instance.num_cores
    prio = _flow_priorities(alloc, order, M)
    pos = np.empty(M, dtype=np.int64)
    pos[order] = np.arange(M)
    out = []
    for k in range(K):
        sel = alloc.core == k
        if sequential:
            cs = schedule_core_sequential(
                coflow=alloc.coflow[sel],
                src=alloc.src[sel],
                dst=alloc.dst[sel],
                size=alloc.size[sel],
                priority=prio[sel],
                coflow_rank=pos,
                releases=instance.releases,
                num_ports=N,
                rate=float(instance.rates[k]),
                delta=instance.delta,
            )
        else:
            cs = schedule_core(
                coflow=alloc.coflow[sel],
                src=alloc.src[sel],
                dst=alloc.dst[sel],
                size=alloc.size[sel],
                priority=prio[sel],
                releases=instance.releases,
                num_ports=N,
                rate=float(instance.rates[k]),
                delta=instance.delta,
                discipline=discipline,
            )
        out.append(cs)
    return out
