"""Feasibility validation for produced schedules (NumPy copy of
`repro.core.validate`).

Checks (per paper Sec. III-D):
  * port exclusivity: on each core, intervals [establish, complete) of flows
    sharing an ingress or egress port never overlap;
  * non-preemption + timing: complete == establish + delta + size / r^k;
  * release times: establish >= a_m;
  * demand conservation: sum_k D^k_m == D_m entrywise.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.circuit import CoreSchedule
from repro_torch.core.coflow import CoflowInstance

__all__ = ["validate_schedule", "ccts_from_schedules"]


def _check_port_exclusive(starts, ends, ports, kind: str, core: int):
    for p in np.unique(ports):
        sel = ports == p
        s = starts[sel]
        e = ends[sel]
        o = np.argsort(s, kind="stable")
        s, e = s[o], e[o]
        gap = s[1:] - e[:-1]
        if gap.size and gap.min() < -1e-9:
            bad = int(np.argmin(gap))
            raise AssertionError(
                f"core {core}: {kind} port {p} overlap: flow ends {e[bad]} "
                f"but next establishes {s[bad + 1]}"
            )


def validate_schedule(
    instance: CoflowInstance,
    core_schedules: list[CoreSchedule],
    atol: float = 1e-6,
) -> None:
    """Raise AssertionError on any feasibility violation."""
    total = np.zeros_like(instance.demands)
    for k, cs in enumerate(core_schedules):
        if len(cs.coflow) == 0:
            continue
        if (cs.establish < 0).any():
            raise AssertionError(f"core {k}: unscheduled flows present")
        expect = cs.establish + cs.delta + cs.size / cs.rate
        if not np.allclose(cs.complete, expect, atol=atol):
            raise AssertionError(f"core {k}: completion-time formula violated")
        if (cs.establish + atol < instance.releases[cs.coflow]).any():
            raise AssertionError(f"core {k}: release time violated")
        _check_port_exclusive(cs.establish, cs.complete, cs.src, "ingress", k)
        _check_port_exclusive(cs.establish, cs.complete, cs.dst, "egress", k)
        np.add.at(total, (cs.coflow, cs.src, cs.dst), cs.size)
    if not np.allclose(total, instance.demands, atol=atol):
        raise AssertionError("demand conservation violated: sum_k D^k != D")


def ccts_from_schedules(
    num_coflows: int, core_schedules: list[CoreSchedule]
) -> np.ndarray:
    """T_m = max_k max_{(i,j)} completion — (M,) CCT vector."""
    cct = np.zeros(num_coflows)
    for cs in core_schedules:
        if len(cs.coflow):
            np.maximum.at(cct, cs.coflow, cs.complete)
    return cct
