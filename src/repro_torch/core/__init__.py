"""Problem model, ordering LP, LP-guided order, certificates and result
types (port of `repro.core`, the parts the ``ours`` pipeline needs)."""

from repro_torch.core.allocation import Allocation
from repro_torch.core.circuit import NOT_SCHEDULED, CoreSchedule
from repro_torch.core.coflow import CoflowInstance, flow_table, flows_of, port_stats
from repro_torch.core.lp import LPSolution, LPSolutionBatch, solve_exact, solve_subgradient
from repro_torch.core.ordering import lp_guided_order
from repro_torch.core.scheduler import ScheduleResult, total_weighted_cct
from repro_torch.core.theory import CertificateReport, certify
from repro_torch.core.validate import ccts_from_schedules, validate_schedule

__all__ = [
    "Allocation",
    "NOT_SCHEDULED",
    "CoreSchedule",
    "CoflowInstance",
    "flow_table",
    "flows_of",
    "port_stats",
    "LPSolution",
    "LPSolutionBatch",
    "solve_exact",
    "solve_subgradient",
    "lp_guided_order",
    "CertificateReport",
    "certify",
    "ScheduleResult",
    "total_weighted_cct",
    "ccts_from_schedules",
    "validate_schedule",
]
