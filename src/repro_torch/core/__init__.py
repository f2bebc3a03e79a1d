"""Core library: multi-coflow scheduling in K-core OCS networks (port of
`repro.core`, less the deprecated `run` shim).

The problem model, the ordering LP and the orders (LP-guided, WSPT), the
inter-core allocation and the per-core circuit schedulers as host NumPy
oracles, the baselines' BvN and EPS calendars, result types and the
per-instance certificates of the (8K+1)-approximation analysis.  Schemes
run through `repro_torch.pipeline`.
"""

from repro_torch.core.allocation import Allocation, allocate
from repro_torch.core.circuit import NOT_SCHEDULED, CoreSchedule, schedule_core
from repro_torch.core.coflow import CoflowInstance, flow_table, flows_of, port_stats
from repro_torch.core.lp import LPSolution, LPSolutionBatch, solve_exact, solve_subgradient
from repro_torch.core.ordering import lp_guided_order, wspt_order
from repro_torch.core.scheduler import ScheduleResult, tail_cct, total_weighted_cct
from repro_torch.core.theory import CertificateReport, certify
from repro_torch.core.validate import ccts_from_schedules, validate_schedule

__all__ = [
    "Allocation",
    "allocate",
    "NOT_SCHEDULED",
    "CoreSchedule",
    "schedule_core",
    "CoflowInstance",
    "flow_table",
    "flows_of",
    "port_stats",
    "LPSolution",
    "LPSolutionBatch",
    "solve_exact",
    "solve_subgradient",
    "lp_guided_order",
    "wspt_order",
    "CertificateReport",
    "certify",
    "ScheduleResult",
    "total_weighted_cct",
    "tail_cct",
    "ccts_from_schedules",
    "validate_schedule",
]
