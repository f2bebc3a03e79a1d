"""The stage-composed scheduling pipeline and its builders.

Port of `repro.pipeline.pipeline`.  `Pipeline.run_batch` packs the
instance list once into an `EnsembleBatch` on the device; ordering
(`order_batch`), allocation (`allocate_batch_arrays`) and, for list
circuits, circuit scheduling (`schedule_batch_arrays`) hand padded tensors
to each other, and per-instance `ScheduleResult`s are materialized at the
end.  Circuit stages with no batched form (sequential, BvN, fluid) schedule
each instance on the host from its materialized allocation.  An order stage
that needs the LP reads the caller's solutions (from
`repro_torch.experiments.solve_ensemble_lp`) or, where one is missing,
solves per instance; one that needs none (WSPT, FIFO) reads none and
records ``lp=None``.  `Pipeline.run` is one instance through the same
path: a one-member batch, which the reference holds bit-identical to its
per-instance loop.

Not ported yet: ``stage_cache``, ``mesh`` sharding, ``refine`` and the
``circuit_backend`` switch (later slices); the methods take no such
argument.
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
        output of `solve_ensemble_lp`); for an order stage that needs the
        LP, a missing one (``None``, or no list at all) is solved per
        instance by the stage.  An order stage that needs no LP (WSPT,
        FIFO) ignores them and every result records ``lp=None``.  With
        ``validate`` every kept schedule is checked by `validate_schedule`
        (BvN and fluid stages keep none).  Each result's ``wall_time_s`` is
        its share of the batched allocation plus its own host schedule's
        time, or its share of the batched calendar.
        """
        device = resolve_device(device)
        instances = list(instances)
        B = len(instances)
        lp_solutions = [None] * B if lp_solutions is None else list(lp_solutions)
        if len(lp_solutions) != B:
            raise ValueError("lp_solutions length mismatch")
        if B == 0:
            return []
        ensemble = build_ensemble_batch(instances, device=device)
        Ms = ensemble.num_coflows
        if self.order_stage.needs_lp:
            lp_solutions = [
                self.order_stage.order(inst, sol, device=device)[1]
                for inst, sol in zip(instances, lp_solutions)
            ]
            comp = np.zeros(tuple(ensemble.weights.shape))
            for b, sol in enumerate(lp_solutions):
                comp[b, : Ms[b]] = sol.completion
            orders_arr = self.order_stage.order_batch(
                ensemble, torch.from_numpy(comp).to(ensemble.device)
            )
        else:
            lp_solutions = [None] * B
            orders_arr = self.order_stage.order_batch(ensemble)
        t0 = time.perf_counter()
        alloc_batch = self.allocate_stage.allocate_batch_arrays(ensemble, orders_arr)
        allocs = alloc_batch.materialize(ensemble)
        orders_host = orders_arr.cpu().numpy()
        orders = [orders_host[b, : Ms[b]] for b in range(B)]
        alloc_share = (time.perf_counter() - t0) / B

        # Circuit: the batched calendar, or (stages with no batched form)
        # one host schedule per instance, each timed on its own.
        t1 = time.perf_counter()
        per_instance_s = None
        batch_fn = getattr(self.circuit_stage, "schedule_batch_arrays", None)
        if batch_fn is not None:
            pairs = batch_fn(ensemble, alloc_batch)
        else:
            pairs, per_instance_s = [], []
            for inst, alloc, order in zip(instances, allocs, orders):
                t2 = time.perf_counter()
                pairs.append(self.circuit_stage.schedule(inst, alloc, order))
                per_instance_s.append(time.perf_counter() - t2)
        circuit_share = (time.perf_counter() - t1) / B

        results = []
        for b, (inst, lp_sol, alloc) in enumerate(
            zip(instances, lp_solutions, allocs)
        ):
            schedules, ccts = pairs[b]
            if validate and schedules is not None:
                validate_schedule(inst, schedules)
            wall = alloc_share + (
                per_instance_s[b] if per_instance_s is not None else circuit_share
            )
            results.append(
                ScheduleResult(
                    scheme=self.spec.name,
                    order=orders[b],
                    allocation=alloc,
                    core_schedules=schedules,
                    ccts=ccts,
                    total_weighted_cct=total_weighted_cct(inst, ccts),
                    lp=lp_sol,
                    wall_time_s=wall,
                )
            )
        return results


# ---------------------------------------------------------------------------
# Spec -> stages
# ---------------------------------------------------------------------------

_ORDER_STAGES = {
    "lp": lambda lp_method, lp_iters: st.LPOrder(lp_method, lp_iters),
    "wspt": lambda lp_method, lp_iters: st.WsptOrder(),
    "fifo": lambda lp_method, lp_iters: st.FifoOrder(),
}

_CIRCUIT_STAGES = {
    "list": lambda discipline, engine: st.ListCircuit(discipline, engine),
    "sequential": lambda discipline, engine: st.SequentialCircuit(),
    "bvn": lambda discipline, engine: st.BvnCircuit(),
    "fluid": lambda discipline, engine: st.FluidCircuit(),
}


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
    it has to solve for itself; ``circuit_engine`` picks the list
    scheduler's calendar executor, ``"kernel"`` (pair space) or ``"jax"``
    (flow space).  The reference's ``"wide"`` and ``"auto"`` are not
    ported and raise.  Stages without a batched form ignore both.
    """
    try:
        order_stage = _ORDER_STAGES[spec.order](lp_method, lp_iters)
    except KeyError:
        raise ValueError(f"unknown order stage kind {spec.order!r}") from None
    try:
        make_circuit = _CIRCUIT_STAGES[spec.circuit]
    except KeyError:
        raise ValueError(f"unknown circuit stage kind {spec.circuit!r}") from None
    return Pipeline(
        spec=spec,
        order_stage=order_stage,
        allocate_stage=st.GreedyAllocate(include_tau=spec.include_tau),
        circuit_stage=make_circuit(spec.discipline or discipline, circuit_engine),
    )


def get_pipeline(scheme: str, **kwargs) -> Pipeline:
    """Pipeline for a registered scheme key (see `repro_torch.pipeline.spec`)."""
    return build_pipeline(get_scheme(scheme), **kwargs)
