"""The stage-composed scheduling pipeline and its builders.

Port of `repro.pipeline.pipeline`.  `Pipeline.run_batch` packs the
instance list once into an `EnsembleBatch` on the device; ordering
(`order_batch`), allocation (`allocate_batch_arrays`) and, for list
circuits, circuit scheduling (`schedule_batch_arrays`) hand padded tensors
to each other, and per-instance `ScheduleResult`s are materialized at the
end.  Circuit stages with no batched form (sequential, BvN, fluid), and the
list circuit under ``circuit_backend="loop"``, schedule each instance on
the host from its materialized allocation.  An order stage that needs the
LP reads the caller's solutions (from
`repro_torch.experiments.solve_ensemble_lp`) or, where one is missing,
solves per instance; one that needs none (WSPT, FIFO) reads none and
records ``lp=None``.  `Pipeline.run` is one instance through the same
path: a one-member batch, which the reference holds bit-identical to its
per-instance loop.

``refine`` (a `RefineSpec`, ``True`` or a field dict; the ``ours_ls``
scheme carries one) searches candidate orders on the realized objective:
batched on the member-expanded ensemble (`refine_batch_arrays`) when the
stages have array forms and the backend is ``"batch"``, else one instance
at a time through the pipeline's own host stages (`refine_sequential`),
which ``require_batch=True`` refuses.  ``stage_cache`` shares the build,
the orders and each later stage between pipelines run on the same
(instances, lp_solutions).  The reference's ``mesh`` sharding is left
for the launch tooling (ROADMAP item 10b).
"""

from __future__ import annotations

import dataclasses
import time
import types
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.core.coflow import CoflowInstance
from repro_torch.core.lp import LPSolution
from repro_torch.core.scheduler import ScheduleResult, total_weighted_cct
from repro_torch.core.validate import validate_schedule
from repro_torch.device import resolve_device
from repro_torch.pipeline import stages as st
from repro_torch.pipeline.ensemble_batch import EnsembleBatch, build_ensemble_batch
from repro_torch.pipeline.refine import (
    RefineOutcome,
    as_refine_spec,
    refine_batch_arrays,
    refine_key,
    refine_sequential,
)
from repro_torch.pipeline.spec import SchemeSpec, get_scheme

__all__ = ["Pipeline", "build_pipeline", "get_pipeline", "order_view"]


def order_view(
    weights: torch.Tensor,
    glb: torch.Tensor,
    releases: torch.Tensor,
    coflow_mask: torch.Tensor,
) -> types.SimpleNamespace:
    """The least batch an order stage's ``order_batch`` accepts.

    Every `order_batch` reads four per-coflow fields of the ensemble --
    ``weights``, ``glb``, ``releases`` ((B, Mp) f64 tensors) and
    ``coflow_mask`` -- besides the LP completion passed apart.  A caller
    that keeps its own resident tensors (the streaming service's slot pool,
    gathered on the device to the dense convention) runs the same ordering
    code as `run_batch` through this view.  Masked entries sort to the
    tail in index order, as in a full batch.
    """
    return types.SimpleNamespace(
        weights=weights, glb=glb, releases=releases, coflow_mask=coflow_mask
    )

#: Reserved `stage_cache` keys: the fingerprint of the ensemble the cache
#: is bound to, and the `EnsembleBatch` built once for it.
_FINGERPRINT_KEY = "__ensemble_fingerprint__"
_ENSEMBLE_KEY = "__ensemble_batch__"


def _same_device(a: torch.device, b: torch.device) -> bool:
    """Whether two devices are one: a tensor's device carries its card's
    index, a resolved ``"cuda"`` may not (it means the current card)."""
    if a.type != b.type:
        return False
    if a.index == b.index:
        return True
    current = torch.cuda.current_device() if a.type == "cuda" else None
    return (current if a.index is None else a.index) == (current if b.index is None else b.index)


def _ensemble_fingerprint(instances, lp_solutions) -> tuple:
    """Identity of the (instances, lp_solutions) pair a stage_cache binds
    to.  It holds the objects themselves, not their ``id``s (which CPython
    reuses), so no other ensemble can alias it while the cache lives."""
    return (tuple(instances), None if lp_solutions is None else tuple(lp_solutions))


def _same_fingerprint(a: tuple, b: tuple) -> bool:
    """Element-wise identity of two fingerprints."""

    def same_seq(xs, ys):
        if xs is None or ys is None:
            return xs is ys
        return len(xs) == len(ys) and all(x is y for x, y in zip(xs, ys))

    return same_seq(a[0], b[0]) and same_seq(a[1], b[1])


@dataclasses.dataclass
class Pipeline:
    """Order -> allocate -> circuit-schedule, as composed stages."""

    spec: SchemeSpec
    order_stage: Any
    allocate_stage: Any
    circuit_stage: Any

    def _resolve_refine(self, refine):
        """The run's `RefineSpec`: an explicit ``refine=`` wins, ``None``
        defers to the spec, ``False`` disables the spec's."""
        if refine is None:
            refine = self.spec.refine
        if refine is None or refine is False:
            return None
        return as_refine_spec(refine)

    def _sequential_refine_eval(self, instance):
        """Objective callback for `refine_sequential` through this
        pipeline's per-instance host stages."""

        def evaluate(order: np.ndarray) -> float:
            alloc = self.allocate_stage.allocate(instance, order)
            _, ccts = self.circuit_stage.schedule(instance, alloc, order)
            return total_weighted_cct(instance, ccts)

        return evaluate

    def run(
        self,
        instance: CoflowInstance,
        lp_solution: LPSolution | None = None,
        validate: bool = True,
        device: str | torch.device = "cuda",
        refine=None,
    ) -> ScheduleResult:
        """Run one instance end to end on ``device``.

        Without ``lp_solution`` the order stage solves the instance's LP
        (its ``method``).  The allocation and the calendar (and ``refine``,
        as in `run_batch`) run as a one-member `run_batch`; ``wall_time_s``
        covers them, not the LP.
        """
        return self.run_batch(
            [instance], [lp_solution], validate=validate, device=device, refine=refine
        )[0]

    # -- stage-cache keys: each stage's identity plus everything upstream --
    def _order_key(self) -> tuple:
        s = self.order_stage
        return ("order", s.kind, getattr(s, "method", None), getattr(s, "iters", None))

    def _refine_key(self, refine_t: tuple) -> tuple:
        """Refined orders depend on the refine config and on the allocation
        and circuit configuration they were evaluated through."""
        a, c = self.allocate_stage, self.circuit_stage
        return (
            "refine", refine_t, a.kind, getattr(a, "include_tau", None),
            c.kind, getattr(c, "discipline", None), getattr(c, "backend", None),
            getattr(c, "engine", None),
        ) + self._order_key()

    def _alloc_key(self, refine_t: tuple | None = None) -> tuple:
        a = self.allocate_stage
        return ("alloc", a.kind, getattr(a, "include_tau", None)) + (
            self._order_key() if refine_t is None else self._refine_key(refine_t)
        )

    def _circuit_key(self, refine_t: tuple | None = None) -> tuple:
        c = self.circuit_stage
        return (
            "circuit", c.kind, getattr(c, "discipline", None),
            getattr(c, "backend", None), getattr(c, "engine", None),
        ) + self._alloc_key(refine_t)

    def _refine(self, ensemble, instances, orders_arr, spec, require_batch):
        """`RefineOutcome` of a search from ``orders_arr``: batched when
        the stages have array forms and the backend is ``"batch"``, else
        `refine_sequential` per instance on the host."""
        alloc_fn = getattr(self.allocate_stage, "allocate_batch_arrays", None)
        cct_fn = getattr(self.circuit_stage, "cct_batch_arrays", None)
        batch_capable = alloc_fn is not None and cct_fn is not None
        backend = getattr(self.circuit_stage, "backend", "batch")
        if batch_capable and backend == "batch":
            return refine_batch_arrays(
                ensemble, orders_arr, spec, alloc_fn=alloc_fn, cct_fn=cct_fn
            )
        if require_batch and batch_capable:
            raise RuntimeError(
                f"run_batch fell back to the sequential refinement loop for "
                f"scheme {self.spec.key!r} (circuit stage "
                f"{type(self.circuit_stage).__name__}, backend {backend!r})"
            )
        Ms = ensemble.num_coflows
        orders = orders_arr.cpu().numpy().copy()
        B = len(instances)
        objective, base = np.zeros(B), np.zeros(B)
        rounds = evals = 0
        for b, inst in enumerate(instances):
            o, objective[b], base[b], r_b, e_b = refine_sequential(
                orders[b, : Ms[b]], spec, self._sequential_refine_eval(inst)
            )
            orders[b, : Ms[b]] = o
            rounds = max(rounds, r_b)
            evals += e_b
        return RefineOutcome(
            orders=orders, objective=objective, base_objective=base,
            rounds=rounds, evaluations=evals, batched=False,
        )

    def run_batch(
        self,
        instances: Sequence[CoflowInstance],
        lp_solutions: Sequence[LPSolution | None] | None = None,
        validate: bool = True,
        device: str | torch.device = "cuda",
        require_batch: bool = False,
        stage_cache: dict | None = None,
        ensemble: EnsembleBatch | None = None,
        refine=None,
    ) -> list[ScheduleResult]:
        """Run a whole ensemble as one tensor pipeline on ``device``.

        ``lp_solutions`` holds one ordering-LP solution per instance (the
        output of `solve_ensemble_lp`); for an order stage that needs the
        LP, a missing one (``None``, or no list at all) is solved per
        instance by the stage.  An order stage that needs no LP (WSPT,
        FIFO) ignores them and every result records ``lp=None``.  With
        ``validate`` every kept schedule is checked by `validate_schedule`
        (BvN and fluid stages keep none).  Each result's ``wall_time_s`` is
        its share of the batched allocation (and refinement) plus its own
        host schedule's time, or its share of the batched calendar.

        ``ensemble`` plugs in a prebuilt `EnsembleBatch` on ``device``.
        ``stage_cache``, one dict passed to every pipeline run on the same
        (instances, lp_solutions), shares the build, the orders and each
        later stage whose configuration (and upstream) matches; it binds
        to the ensemble it was first used on and refuses another.
        ``refine`` searches candidate orders on the realized objective
        (`RefineSpec` / ``True`` / field dict; None defers to the spec,
        False disables it); refined and unrefined pipelines share the
        orders but nothing downstream.  ``require_batch`` raises where a
        batch-capable stage would fall back to a per-instance loop (the
        ``"loop"`` backend).
        """
        device = resolve_device(device)
        instances = list(instances)
        B = len(instances)
        if lp_solutions is not None:
            lp_solutions = list(lp_solutions)
            if len(lp_solutions) != B:
                raise ValueError("lp_solutions length mismatch")
        if stage_cache is not None:
            fp = _ensemble_fingerprint(instances, lp_solutions)
            prev = stage_cache.setdefault(_FINGERPRINT_KEY, fp)
            if prev is not fp and not _same_fingerprint(prev, fp):
                raise ValueError(
                    "stage_cache reuse across different ensembles: this cache was "
                    "built for another (instances, lp_solutions) pair; pass a "
                    "fresh dict per ensemble"
                )
        if B == 0:
            return []
        if ensemble is None and stage_cache is not None:
            ensemble = stage_cache.get(_ENSEMBLE_KEY)
        if ensemble is None:
            ensemble = build_ensemble_batch(instances, device=device)
        elif not _same_device(ensemble.device, device):
            raise ValueError(
                f"the given EnsembleBatch lives on {ensemble.device}, the run "
                f"on {device}"
            )
        if stage_cache is not None:
            stage_cache.setdefault(_ENSEMBLE_KEY, ensemble)
        Ms = ensemble.num_coflows

        # Ordering: one (B, Mp) tensor for the whole ensemble.
        cached = None if stage_cache is None else stage_cache.get(self._order_key())
        if cached is None:
            sols = [None] * B if lp_solutions is None else lp_solutions
            if self.order_stage.needs_lp:
                sols = [
                    self.order_stage.order(inst, sol, device=device)[1]
                    for inst, sol in zip(instances, sols)
                ]
                comp = np.zeros(tuple(ensemble.weights.shape))
                for b, sol in enumerate(sols):
                    comp[b, : Ms[b]] = sol.completion
                orders_arr = self.order_stage.order_batch(
                    ensemble, torch.from_numpy(comp).to(ensemble.device)
                )
            else:
                sols = [None] * B
                orders_arr = self.order_stage.order_batch(ensemble)
            cached = (orders_arr, sols)
            if stage_cache is not None:
                stage_cache[self._order_key()] = cached
        orders_arr, lp_list = cached
        t0 = time.perf_counter()

        # Refinement: candidate search on the realized objective.
        spec = self._resolve_refine(refine)
        refine_t = None
        if spec is not None:
            refine_t = refine_key(spec)
            rkey = self._refine_key(refine_t)
            outcome = None if stage_cache is None else stage_cache.get(rkey)
            if outcome is None:
                outcome = self._refine(ensemble, instances, orders_arr, spec, require_batch)
                if stage_cache is not None:
                    stage_cache[rkey] = outcome
            orders_arr = torch.from_numpy(outcome.orders).to(ensemble.device)

        # Allocation: the device scan, materialized once.
        a_cached = None if stage_cache is None else stage_cache.get(self._alloc_key(refine_t))
        if a_cached is None:
            alloc_batch = self.allocate_stage.allocate_batch_arrays(ensemble, orders_arr)
            a_cached = (alloc_batch, alloc_batch.materialize(ensemble))
            if stage_cache is not None:
                stage_cache[self._alloc_key(refine_t)] = a_cached
        alloc_batch, allocs = a_cached
        orders_host = orders_arr.cpu().numpy()
        orders = [orders_host[b, : Ms[b]] for b in range(B)]
        alloc_share = (time.perf_counter() - t0) / B

        # Circuit: the batched calendar, or (stages with no batched form,
        # and the "loop" backend) one host schedule per instance, each timed
        # on its own.
        per_instance_s = None
        circuit_share = 0.0
        pairs = None if stage_cache is None else stage_cache.get(self._circuit_key(refine_t))
        if pairs is None:
            t1 = time.perf_counter()
            batch_fn = getattr(self.circuit_stage, "schedule_batch_arrays", None)
            if batch_fn is not None:
                pairs = batch_fn(ensemble, alloc_batch)
            if pairs is None:
                if require_batch and batch_fn is not None:
                    raise RuntimeError(
                        f"run_batch fell back to the per-instance circuit loop for "
                        f"scheme {self.spec.key!r} (circuit stage "
                        f"{type(self.circuit_stage).__name__}, backend "
                        f"{getattr(self.circuit_stage, 'backend', None)!r})"
                    )
                pairs, per_instance_s = [], []
                for inst, alloc, order in zip(instances, allocs, orders):
                    t2 = time.perf_counter()
                    pairs.append(self.circuit_stage.schedule(inst, alloc, order))
                    per_instance_s.append(time.perf_counter() - t2)
            else:
                circuit_share = (time.perf_counter() - t1) / B
            if stage_cache is not None:
                stage_cache[self._circuit_key(refine_t)] = pairs

        results = []
        for b, (inst, lp_sol, alloc) in enumerate(zip(instances, lp_list, allocs)):
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
    "list": lambda discipline, backend, engine: st.ListCircuit(discipline, backend, engine),
    "sequential": lambda discipline, backend, engine: st.SequentialCircuit(),
    "bvn": lambda discipline, backend, engine: st.BvnCircuit(),
    "fluid": lambda discipline, backend, engine: st.FluidCircuit(),
}


def build_pipeline(
    spec: SchemeSpec,
    *,
    discipline: str = "greedy",
    lp_method: str = "exact",
    lp_iters: int = 3000,
    circuit_backend: str = "batch",
    circuit_engine: str = "kernel",
) -> Pipeline:
    """Materialize a `SchemeSpec` into an executable `Pipeline`.

    ``discipline`` applies to list-scheduler circuits whose spec leaves it
    open (the spec's own pin wins); ``lp_method`` (``"exact"`` or
    ``"subgradient"``) and ``lp_iters`` configure the LP order stage when
    it has to solve for itself.  ``circuit_backend`` selects the list
    scheduler's `run_batch` path: ``"batch"`` (the ensemble's padded
    calendar) or ``"loop"`` (the per-instance host oracle);
    ``circuit_engine`` picks the batch backend's calendar executor:
    ``"kernel"`` (pair space), ``"jax"`` (flow space), ``"wide"`` (host
    NumPy) or ``"auto"`` (kernel on a card, wide on the host, or
    ``REPRO_CIRCUIT_ENGINE``).  The default stays ``"kernel"`` where the
    reference's is ``"auto"``: which engine should be the default waits
    for the port's benchmark (ROADMAP item 4).  Stages without a batched
    form ignore both.
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
        circuit_stage=make_circuit(
            spec.discipline or discipline, circuit_backend, circuit_engine
        ),
    )


def get_pipeline(scheme: str, **kwargs) -> Pipeline:
    """Pipeline for a registered scheme key (see `repro_torch.pipeline.spec`)."""
    return build_pipeline(get_scheme(scheme), **kwargs)
