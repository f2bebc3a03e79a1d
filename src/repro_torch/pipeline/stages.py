"""Concrete stages of the `ours` pipeline (Algorithm 1's three phases).

Port of the stages of `repro.pipeline.stages` that the ``ours`` scheme
runs: `LPOrder` (per instance, solving its own LP when none is given, and
batched), `GreedyAllocate.allocate_batch_arrays` and
`ListCircuit.schedule_batch_arrays` (both disciplines; the pair-space
calendar, ``engine="kernel"``, or the flow-space one, ``engine="jax"``).
Allocation and circuits run batched only: a single instance is a
one-member batch.  The other order stages (WSPT, FIFO) and the other
circuit stages (sequential, BvN, fluid) are not ported yet.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.ordering import lp_guided_order
from repro_torch.pipeline.batch_alloc import allocate_batch_arrays
from repro_torch.pipeline.batch_circuit import check_engine, schedule_batch_arrays

__all__ = ["LPOrder", "GreedyAllocate", "ListCircuit"]


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


class GreedyAllocate:
    """Prefix-aware greedy allocation (Lines 3-15); tau-blind when
    ``include_tau=False`` (LOAD-ONLY)."""

    kind = "greedy"

    def __init__(self, include_tau: bool = True):
        self.include_tau = include_tau

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

    def schedule_batch_arrays(self, ensemble, alloc_batch):
        """Padded tensors in, per-instance ``(schedules, ccts)`` out."""
        return schedule_batch_arrays(
            ensemble, alloc_batch, discipline=self.discipline, engine=self.engine
        )
