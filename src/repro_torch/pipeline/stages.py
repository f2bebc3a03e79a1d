"""Concrete stages of the scheduling pipeline (Algorithm 1's three phases
and the paper's baselines).

Port of `repro.pipeline.stages`:

  * order stages -- `LPOrder` (per instance, solving its own LP when none
    is given, and batched), `WsptOrder` and `FifoOrder` (batched on the
    ensemble's device; per instance in host NumPy);
  * `GreedyAllocate` -- batched on the device (`allocate_batch_arrays`);
    `allocate` is the per-instance host oracle;
  * circuit stages -- `ListCircuit.schedule_batch_arrays` (both
    disciplines; the pair-space calendar, ``engine="kernel"``, or the
    flow-space one, ``engine="jax"``), with `ListCircuit.schedule` as the
    per-instance host oracle; `SequentialCircuit` (SUNFLOW-S), `BvnCircuit`
    (BvN-S) and `FluidCircuit` (EPS) schedule per instance on the host, as
    the reference does: they have no batched form.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core import bvn as bvn_mod
from repro_torch.core.allocation import allocate
from repro_torch.core.eps import eps_ccts, fluid_schedule_core
from repro_torch.core.ordering import fifo_order, lp_guided_order, wspt_order
from repro_torch.core.scheduler import _flow_priorities, _schedule_all_cores
from repro_torch.core.validate import ccts_from_schedules
from repro_torch.pipeline.batch_alloc import allocate_batch_arrays
from repro_torch.pipeline.batch_circuit import check_engine, schedule_batch_arrays

__all__ = [
    "LPOrder",
    "WsptOrder",
    "FifoOrder",
    "GreedyAllocate",
    "ListCircuit",
    "SequentialCircuit",
    "BvnCircuit",
    "FluidCircuit",
]


def _masked_stable_order(key: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(B, Mp) stable argsort with padded slots pushed to the tail.

    Row ``b`` restricted to its real prefix equals the per-instance
    ``np.argsort(key_b, kind="stable")``: masking padded slots to +inf
    cannot disturb the relative order of real entries.
    """
    return torch.argsort(torch.where(mask, key, math.inf), dim=1, stable=True)


class LPOrder:
    """LP-guided order: non-decreasing T~_m (Algorithm 1 Line 2)."""

    kind = "lp"
    needs_lp = True

    def __init__(self, method: str = "exact", iters: int = 3000):
        self.method = method
        self.iters = iters

    def order(self, instance, lp_solution=None, device="cuda"):
        """``(order, lp_solution)`` of one instance; without a given
        solution, solves the LP (``method``; ``iters`` for the
        subgradient solver on ``device``)."""
        if lp_solution is None:
            kwargs = {"iters": self.iters} if self.method == "subgradient" else {}
            _, lp_solution = lp_guided_order(
                instance, method=self.method, device=device, **kwargs
            )
        return lp_solution.order(), lp_solution

    def order_batch(self, ensemble, lp_completion: torch.Tensor) -> torch.Tensor:
        """(B, Mp) padded orders from padded f64 LP completion times."""
        return _masked_stable_order(lp_completion, ensemble.coflow_mask)


class WsptOrder:
    """WSPT-ORDER baseline [31]: non-increasing w_m / T_LB(D_m)."""

    kind = "wspt"
    needs_lp = False

    def order(self, instance, lp_solution=None):
        return wspt_order(instance), None

    def order_batch(self, ensemble) -> torch.Tensor:
        # `wspt_order`'s f64 elementwise arithmetic, the divisor a tensor.
        score = ensemble.weights / torch.clamp_min(ensemble.glb, 1e-300)
        return _masked_stable_order(-score, ensemble.coflow_mask)


class FifoOrder:
    """Release-time FIFO -- ablation reference."""

    kind = "fifo"
    needs_lp = False

    def order(self, instance, lp_solution=None):
        return fifo_order(instance), None

    def order_batch(self, ensemble) -> torch.Tensor:
        return _masked_stable_order(ensemble.releases, ensemble.coflow_mask)


class GreedyAllocate:
    """Prefix-aware greedy allocation (Lines 3-15); tau-blind when
    ``include_tau=False`` (LOAD-ONLY)."""

    kind = "greedy"

    def __init__(self, include_tau: bool = True):
        self.include_tau = include_tau

    def allocate(self, instance, order):
        """Per-instance host oracle (`repro_torch.core.allocation.allocate`)."""
        return allocate(instance, order, include_tau=self.include_tau)

    def allocate_batch_arrays(self, ensemble, orders):
        """`EnsembleBatch` + (B, Mp) orders -> `AllocationBatch`."""
        return allocate_batch_arrays(ensemble, orders, include_tau=self.include_tau)


class ListCircuit:
    """Not-all-stop greedy port-matching list scheduler (Lines 16-30).

    ``engine`` selects the calendar executor: ``"kernel"`` (pair space,
    the `pair_resolve` kernel) or ``"jax"`` (flow space, the
    `event_resolve` kernel); both give the same schedules.
    """

    kind = "list"

    def __init__(self, discipline: str = "greedy", engine: str = "kernel"):
        if discipline not in ("reserving", "greedy"):
            raise ValueError(f"unknown discipline {discipline!r}")
        self.discipline = discipline
        self.engine = check_engine(engine)

    def schedule(self, instance, alloc, order):
        """Per-instance host oracle: `schedule_core` on every core."""
        schedules = _schedule_all_cores(
            instance, alloc, order, discipline=self.discipline
        )
        return schedules, ccts_from_schedules(instance.num_coflows, schedules)

    def schedule_batch_arrays(self, ensemble, alloc_batch):
        """Padded tensors in, per-instance ``(schedules, ccts)`` out."""
        return schedule_batch_arrays(
            ensemble, alloc_batch, discipline=self.discipline, engine=self.engine
        )


class SequentialCircuit:
    """Sunflow-style one-coflow-at-a-time intra-core scheduling."""

    kind = "sequential"

    def schedule(self, instance, alloc, order):
        schedules = _schedule_all_cores(instance, alloc, order, sequential=True)
        return schedules, ccts_from_schedules(instance.num_coflows, schedules)


class BvnCircuit:
    """Birkhoff-von Neumann decomposition under the all-stop model.

    No circuit structures are kept, so the returned schedule list is None
    and feasibility validation is skipped.
    """

    kind = "bvn"

    def schedule(self, instance, alloc, order):
        M, N, K = instance.num_coflows, instance.num_ports, instance.num_cores
        per_core = alloc.per_core_demand(M, N)
        ccts = np.zeros(M)
        for k in range(K):
            mats = [(int(m), per_core[k, m]) for m in order]
            done = bvn_mod.bvn_execute_core(
                mats, instance.releases, float(instance.rates[k]), instance.delta
            )
            for m, t_done in done.items():
                ccts[m] = max(ccts[m], t_done)
        return None, ccts


class FluidCircuit:
    """EPS priority fluid rate allocation (paper Theorem 2; delta = 0)."""

    kind = "fluid"

    def schedule(self, instance, alloc, order):
        if instance.delta != 0:
            # Theorem 2 models electrical packet switching: no circuit
            # reconfiguration exists, so scheduling an OCS instance with
            # delta > 0 here would silently drop the delay and report
            # invalid (unfairly favorable) CCTs.
            raise ValueError("EPS fluid scheduling requires delta == 0")
        M, N, H = instance.num_coflows, instance.num_ports, instance.num_cores
        prio = _flow_priorities(alloc, order, M)
        schedules = []
        for h in range(H):
            sel = alloc.core == h
            schedules.append(
                fluid_schedule_core(
                    coflow=alloc.coflow[sel],
                    src=alloc.src[sel],
                    dst=alloc.dst[sel],
                    size=alloc.size[sel],
                    priority=prio[sel],
                    releases=instance.releases,
                    num_ports=N,
                    rate=float(instance.rates[h]),
                )
            )
        # EpsCoreSchedule is not a circuit CoreSchedule: no establishment
        # times exist under fluid rates, so nothing to validate downstream.
        return None, eps_ccts(instance, schedules)
