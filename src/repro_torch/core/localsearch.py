"""Local-search refinement of the LP-guided order: the per-instance oracle.

Port of `repro.core.localsearch`, in host NumPy over the port's
`allocate` and `_schedule_all_cores`.  The LP order minimizes a
relaxation; the realized weighted CCT is piecewise-constant in the order,
so swap hill climbing on the true objective (one allocation + circuit
pass per candidate) recovers rounding slack.  Only improving swaps are
accepted, so the result is never worse than Algorithm 1's schedule and
the (8K+1) bound still applies.  The batched search is
`repro_torch.pipeline.refine`; it resolves winners through
`select_candidate` here and is held against `refine_round_best`.

Determinism contract (shared with the batched search): a candidate is
accepted only when it beats the incumbent by more than `TOL` (1e-9), and
among candidates within `TOL` of the round minimum the lowest index wins.
Realized weighted CCTs are exact f64 reductions, bit-identical between
the batched and the sequential evaluators, so both pick the same winners.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.allocation import allocate
from repro_torch.core.coflow import CoflowInstance
from repro_torch.core.scheduler import _schedule_all_cores, total_weighted_cct
from repro_torch.core.validate import ccts_from_schedules

__all__ = ["TOL", "evaluate_order", "refine_order", "refine_round_best", "select_candidate"]

#: Absolute objective tolerance of every refinement accept rule.
TOL = 1e-9


def evaluate_order(
    instance: CoflowInstance, order: np.ndarray, discipline: str = "greedy"
) -> float:
    """Realized weighted CCT of Algorithm 1's allocation and list
    schedule along ``order``."""
    alloc = allocate(instance, order)
    schedules = _schedule_all_cores(instance, alloc, order, discipline=discipline)
    ccts = ccts_from_schedules(instance.num_coflows, schedules)
    return total_weighted_cct(instance, ccts)


def select_candidate(objs: np.ndarray, incumbent: int = 0, tol: float = TOL) -> int:
    """The winner among candidate objectives -- the tie-break rule.

    ``objs[incumbent]`` is the current order's objective.  It is kept
    unless some candidate improves on it by more than ``tol``; among
    candidates within ``tol`` of the round minimum the lowest index wins.
    """
    objs = np.asarray(objs, dtype=np.float64)
    best = float(objs.min())
    if not best < float(objs[incumbent]) - tol:
        return int(incumbent)
    return int(np.flatnonzero(objs <= best + tol)[0])


def refine_order(
    instance: CoflowInstance,
    order: np.ndarray,
    max_rounds: int = 4,
    discipline: str = "greedy",
    verbose: bool = False,
    tol: float = TOL,
):
    """First-improvement adjacent-swap hill climbing on the true objective:
    a swap is taken only when it beats the current best by more than
    ``tol``.  Returns ``(refined_order, best_objective, evaluations)``."""
    order = np.asarray(order).copy()
    best = evaluate_order(instance, order, discipline)
    evals = 1
    M = len(order)
    for rnd in range(max_rounds):
        improved = False
        for i in range(M - 1):
            cand = order.copy()
            cand[i], cand[i + 1] = cand[i + 1], cand[i]
            obj = evaluate_order(instance, cand, discipline)
            evals += 1
            if obj < best - tol:
                order, best = cand, obj
                improved = True
        if verbose:
            print(f"  localsearch round {rnd}: best={best:.1f}")
        if not improved:
            break
    return order, best, evals


def refine_round_best(
    instance: CoflowInstance,
    order: np.ndarray,
    discipline: str = "greedy",
    tol: float = TOL,
):
    """Best candidate of one full adjacent-swap neighborhood, one at a time.

    Slot 0 is the incumbent ``order``; slot ``i`` (1-based) swaps order
    positions ``(i - 1, i)``.  Returns ``(winner_slot, winner_order,
    objs)`` with ``objs`` the (M,) candidate objectives.
    """
    order = np.asarray(order)
    cands = [order.copy()]
    for i in range(len(order) - 1):
        c = order.copy()
        c[i], c[i + 1] = c[i + 1], c[i]
        cands.append(c)
    objs = np.array([evaluate_order(instance, c, discipline) for c in cands])
    w = select_candidate(objs, tol=tol)
    return w, cands[w].copy(), objs
