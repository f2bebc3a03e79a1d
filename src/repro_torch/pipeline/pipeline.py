"""The stage-composed scheduling pipeline and its builders.

Port of `repro.pipeline.pipeline` for the ``ours`` scheme.
`Pipeline.run_batch` packs the instance list once into an `EnsembleBatch`
on the device, and ordering (`order_batch`), allocation
(`allocate_batch_arrays`) and circuit scheduling (`schedule_batch_arrays`)
hand padded tensors to each other; per-instance `ScheduleResult`s are
materialized at the end.  LP solutions are supplied by the caller (from
`repro_torch.experiments.solve_ensemble_lp`) or, where one is missing,
solved per instance by the order stage.  `Pipeline.run` is one instance
through the same path: its allocation and calendar run on a one-member
batch, which the reference holds bit-identical to its per-instance loop.

Not ported yet: ``stage_cache``, ``mesh`` sharding and ``refine`` (later
slices); the methods take no such argument.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.core.coflow import CoflowInstance
from repro_torch.core.lp import LPSolution
from repro_torch.core.scheduler import ScheduleResult, total_weighted_cct
from repro_torch.core.validate import validate_schedule
from repro_torch.device import resolve_device
from repro_torch.pipeline import stages as st
from repro_torch.pipeline.ensemble_batch import build_ensemble_batch
from repro_torch.pipeline.spec import SchemeSpec, get_scheme

__all__ = ["Pipeline", "build_pipeline", "get_pipeline"]


@dataclasses.dataclass
class Pipeline:
    """Order -> allocate -> circuit-schedule, as composed stages."""

    spec: SchemeSpec
    order_stage: Any
    allocate_stage: Any
    circuit_stage: Any

    def run(
        self,
        instance: CoflowInstance,
        lp_solution: LPSolution | None = None,
        validate: bool = True,
        device: str | torch.device = "cuda",
    ) -> ScheduleResult:
        """Run one instance end to end on ``device``.

        Without ``lp_solution`` the order stage solves the instance's LP
        (its ``method``).  The allocation and the calendar run as a
        one-member `run_batch`; ``wall_time_s`` covers them, not the LP.
        """
        return self.run_batch(
            [instance], [lp_solution], validate=validate, device=device
        )[0]

    def run_batch(
        self,
        instances: Sequence[CoflowInstance],
        lp_solutions: Sequence[LPSolution | None] | None = None,
        validate: bool = True,
        device: str | torch.device = "cuda",
    ) -> list[ScheduleResult]:
        """Run a whole ensemble as one tensor pipeline on ``device``.

        ``lp_solutions`` holds one ordering-LP solution per instance (the
        output of `solve_ensemble_lp`); a missing one (``None``, or no list
        at all) is solved per instance by the order stage.  With
        ``validate`` every schedule is checked by `validate_schedule`.
        Each result's ``wall_time_s`` is its share of the batched
        allocation and circuit stages.
        """
        device = resolve_device(device)
        instances = list(instances)
        B = len(instances)
        lp_solutions = [None] * B if lp_solutions is None else list(lp_solutions)
        if len(lp_solutions) != B:
            raise ValueError("lp_solutions length mismatch")
        if B == 0:
            return []
        lp_solutions = [
            self.order_stage.order(inst, sol, device=device)[1]
            for inst, sol in zip(instances, lp_solutions)
        ]
        ensemble = build_ensemble_batch(instances, device=device)
        Ms = ensemble.num_coflows

        comp = np.zeros(tuple(ensemble.weights.shape))
        for b, sol in enumerate(lp_solutions):
            comp[b, : Ms[b]] = sol.completion
        orders_arr = self.order_stage.order_batch(
            ensemble, torch.from_numpy(comp).to(ensemble.device)
        )
        t0 = time.perf_counter()
        alloc_batch = self.allocate_stage.allocate_batch_arrays(ensemble, orders_arr)
        allocs = alloc_batch.materialize(ensemble)
        pairs = self.circuit_stage.schedule_batch_arrays(ensemble, alloc_batch)
        share = (time.perf_counter() - t0) / B
        orders_host = orders_arr.cpu().numpy()

        results = []
        for b, (inst, lp_sol, alloc) in enumerate(
            zip(instances, lp_solutions, allocs)
        ):
            schedules, ccts = pairs[b]
            if validate:
                validate_schedule(inst, schedules)
            results.append(
                ScheduleResult(
                    scheme=self.spec.name,
                    order=orders_host[b, : Ms[b]],
                    allocation=alloc,
                    core_schedules=schedules,
                    ccts=ccts,
                    total_weighted_cct=total_weighted_cct(inst, ccts),
                    lp=lp_sol,
                    wall_time_s=share,
                )
            )
        return results


def build_pipeline(
    spec: SchemeSpec,
    *,
    discipline: str = "greedy",
    lp_method: str = "exact",
    lp_iters: int = 3000,
    circuit_engine: str = "kernel",
) -> Pipeline:
    """Materialize a `SchemeSpec` into an executable `Pipeline`.

    ``discipline`` applies to list-scheduler circuits whose spec leaves it
    open (the spec's own pin wins); ``lp_method`` (``"exact"`` or
    ``"subgradient"``) and ``lp_iters`` configure the LP order stage when
    it has to solve for itself; ``circuit_engine`` picks the calendar
    executor, ``"kernel"`` (pair space) or ``"jax"`` (flow space).  The
    reference's ``"wide"`` and ``"auto"`` are not ported and raise.
    """
    if spec.order != "lp":
        raise ValueError(f"order stage kind {spec.order!r} is not ported")
    if spec.circuit != "list":
        raise ValueError(f"circuit stage kind {spec.circuit!r} is not ported")
    return Pipeline(
        spec=spec,
        order_stage=st.LPOrder(lp_method, lp_iters),
        allocate_stage=st.GreedyAllocate(include_tau=spec.include_tau),
        circuit_stage=st.ListCircuit(spec.discipline or discipline, circuit_engine),
    )


def get_pipeline(scheme: str, **kwargs) -> Pipeline:
    """Pipeline for a registered scheme key (see `repro_torch.pipeline.spec`)."""
    return build_pipeline(get_scheme(scheme), **kwargs)
