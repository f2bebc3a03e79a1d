"""The stage-composed scheduling pipeline and its builders.

Port of `repro.pipeline.pipeline` for the ``ours`` scheme.
`Pipeline.run_batch` packs the instance list once into an `EnsembleBatch`
on the device, and ordering (`order_batch`), allocation
(`allocate_batch_arrays`) and circuit scheduling (`schedule_batch_arrays`)
hand padded tensors to each other; per-instance `ScheduleResult`s are
materialized at the end.  LP solutions are supplied by the caller (from
`repro_torch.experiments.solve_ensemble_lp`).

Not ported yet: the per-instance ``run``, ``stage_cache``, ``mesh``
sharding and ``refine`` (later slices).
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

    def run_batch(
        self,
        instances: Sequence[CoflowInstance],
        lp_solutions: Sequence[LPSolution],
        validate: bool = True,
        device: str | torch.device = "cuda",
    ) -> list[ScheduleResult]:
        """Run a whole ensemble as one tensor pipeline on ``device``.

        ``lp_solutions`` holds one ordering-LP solution per instance (the
        output of `solve_ensemble_lp`).  With ``validate`` every schedule is
        checked by `validate_schedule`.  Each result's ``wall_time_s`` is
        its share of the batched allocation and circuit stages.
        """
        device = resolve_device(device)
        instances = list(instances)
        B = len(instances)
        lp_solutions = list(lp_solutions)
        if len(lp_solutions) != B:
            raise ValueError("lp_solutions length mismatch")
        if any(sol is None for sol in lp_solutions):
            raise ValueError(
                "run_batch needs an LP solution per instance (solve them "
                "with solve_ensemble_lp); per-instance LP solves are not "
                "ported"
            )
        if B == 0:
            return []
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


def build_pipeline(spec: SchemeSpec, *, discipline: str = "greedy") -> Pipeline:
    """Materialize a `SchemeSpec` into an executable `Pipeline`.

    ``discipline`` applies to list-scheduler circuits whose spec leaves it
    open (the spec's own pin wins).
    """
    if spec.order != "lp":
        raise ValueError(f"order stage kind {spec.order!r} is not ported")
    if spec.circuit != "list":
        raise ValueError(f"circuit stage kind {spec.circuit!r} is not ported")
    return Pipeline(
        spec=spec,
        order_stage=st.LPOrder(),
        allocate_stage=st.GreedyAllocate(include_tau=spec.include_tau),
        circuit_stage=st.ListCircuit(spec.discipline or discipline),
    )


def get_pipeline(scheme: str, **kwargs) -> Pipeline:
    """Pipeline for a registered scheme key (see `repro_torch.pipeline.spec`)."""
    return build_pipeline(get_scheme(scheme), **kwargs)
