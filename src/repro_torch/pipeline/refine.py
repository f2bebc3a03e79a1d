"""Batched candidate-search refinement: order search as extra batch members.

Port of `repro.pipeline.refine`.  Algorithm 1's LP order minimizes a
relaxation; the realized weighted CCT is piecewise-constant in the order,
so searching candidate orders on the true objective recovers rounding
slack, and because only improving candidates are accepted the refined
schedule keeps the (8K+1) guarantee.  Each round:

  1. **expand** -- `EnsembleBatch.expand_members(k)` tiles every instance
     ``k`` times on the device (candidate-major: row ``b*k + c`` is slot
     ``c`` of instance ``b``; slot 0 is the incumbent), once per search.
  2. **generate** -- slots 1..k-1 cycle through the spec's generators
     (``adjacent``, ``perturb``, ``crossover``) in host NumPy, each
     (round, slot) from its own ``np.random.default_rng((seed, round,
     slot))``, so candidates do not depend on the batch's other members.
     The (B*k, Mp) orders are copied to the device once a round.
  3. **evaluate** -- one `allocate_batch_arrays` and one lean
     `cct_batch_arrays` over all instances x candidates, then each
     instance's weighted CCTs with the f64 ``np.dot`` of
     `total_weighted_cct`.
  4. **select** -- per-instance winners under
     `repro_torch.core.localsearch.select_candidate`; incumbents and elite
     pools update, an instance freezes after ``stop_after_stale``
     consecutive non-improving rounds (default one), and the search stops
     when every instance has.

`refine_sequential` is the per-instance oracle: the same generators,
rounds and selection, one candidate at a time through any
``evaluate(order) -> float``.  The batched stages are bit-identical to the
per-instance host stages and the selection rule is shared, so both paths
pick the same winners.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.core.localsearch import select_candidate
from repro_torch.pipeline.batch_alloc import allocate_batch_arrays
from repro_torch.pipeline.batch_circuit import cct_batch_arrays
from repro_torch.pipeline.ensemble_batch import EnsembleBatch
from repro_torch.pipeline.spec import REFINE_GENERATORS, RefineSpec

__all__ = [
    "RefineSpec",
    "RefineOutcome",
    "as_refine_spec",
    "refine_key",
    "generate_candidates",
    "refine_batch_arrays",
    "refine_sequential",
]


def as_refine_spec(refine) -> RefineSpec:
    """A validated `RefineSpec` from a ``refine=`` argument: a `RefineSpec`,
    ``True`` (the defaults, ``ours_ls``'s dial) or a dict of its fields."""
    if refine is True:
        spec = RefineSpec()
    elif isinstance(refine, RefineSpec):
        spec = refine
    elif isinstance(refine, dict):
        spec = RefineSpec(**refine)
    else:
        raise TypeError(
            f"refine must be a RefineSpec, True, or a field dict; got {refine!r}"
        )
    if spec.rounds < 1:
        raise ValueError(f"refine rounds must be >= 1, got {spec.rounds}")
    if spec.candidates < 1:
        raise ValueError(f"refine candidates must be >= 1, got {spec.candidates}")
    if spec.elites < 2:
        raise ValueError(f"refine elites must be >= 2, got {spec.elites}")
    if not spec.generators:
        raise ValueError("refine generators must be non-empty")
    unknown = [g for g in spec.generators if g not in REFINE_GENERATORS]
    if unknown:
        raise ValueError(
            f"unknown refine generator(s) {unknown}; expected {REFINE_GENERATORS}"
        )
    if spec.stop_after_stale is not None and spec.stop_after_stale < 1:
        raise ValueError(
            f"refine stop_after_stale must be None or >= 1, got {spec.stop_after_stale}"
        )
    return spec


def refine_key(spec: RefineSpec) -> tuple:
    """Hashable canonical form of a `RefineSpec` (stage-cache keys)."""
    return tuple(sorted(dataclasses.asdict(spec).items()))


@dataclasses.dataclass
class RefineOutcome:
    """Result of one refinement run over an ensemble."""

    orders: np.ndarray  # (B, Mp) refined padded orders
    objective: np.ndarray  # (B,) realized weighted CCT of `orders`
    base_objective: np.ndarray  # (B,) incumbent objective before search
    rounds: int  # search rounds run
    evaluations: int  # candidate evaluations (incumbents included)
    batched: bool  # evaluated on the member-expanded batch?

    @property
    def improved(self) -> np.ndarray:
        return self.objective < self.base_objective


# ------------------------------------------------------------ generators


def _order_crossover(pa: np.ndarray, pb: np.ndarray, cut: int) -> np.ndarray:
    """OX crossover: ``pa``'s prefix up to ``cut``, the rest in ``pb``'s order."""
    head = pa[:cut]
    return np.concatenate([head, pb[~np.isin(pb, head)]])


def generate_candidates(
    order: np.ndarray,
    spec: RefineSpec,
    round_idx: int,
    cursor: int,
    elites: Sequence[tuple[float, np.ndarray]],
) -> tuple[list[np.ndarray], int]:
    """Candidate orders (slots 1..candidates-1) for one instance's round.

    ``order`` is the (M,) incumbent; ``cursor`` the rolling offset into the
    adjacent-transposition neighborhood (advanced by the adjacent slots
    used); ``elites`` the instance's (objective, order) pool, best first.
    Deterministic in these inputs, ``spec`` and ``round_idx`` alone.
    Returns ``(candidates, new_cursor)``.
    """
    M = int(order.shape[0])
    cands: list[np.ndarray] = []
    n_adj = 0
    for j in range(spec.candidates - 1):
        gen = spec.generators[j % len(spec.generators)]
        if M < 2:
            cands.append(order.copy())
            continue
        rng = np.random.default_rng((spec.seed, round_idx, j))
        if gen == "adjacent":
            i = (cursor + n_adj) % (M - 1)
            n_adj += 1
            c = order.copy()
            c[i], c[i + 1] = c[i + 1], c[i]
        elif gen == "crossover" and len(elites) >= 2:
            a = int(rng.integers(len(elites)))
            b = int(rng.integers(len(elites) - 1))
            if b >= a:
                b += 1
            c = _order_crossover(elites[a][1], elites[b][1], int(rng.integers(1, M)))
        else:  # "perturb", and crossover's fallback until two elites exist
            pos = np.empty(M, dtype=np.float64)
            pos[order] = np.arange(M, dtype=np.float64)
            key = pos + spec.sigma * rng.standard_normal(M)
            c = np.argsort(key, kind="stable").astype(order.dtype)
        cands.append(c)
    return cands, (cursor + n_adj) % max(M - 1, 1)


def _update_elites(
    elites: list[tuple[float, np.ndarray]],
    scored: Sequence[tuple[float, np.ndarray]],
    max_elites: int,
) -> list[tuple[float, np.ndarray]]:
    """Merge a round's scored candidates into the elite pool: stable sort
    on objective (earlier elites first on ties, then slot order), dedupe
    by order bytes, keep the best ``max_elites``."""
    merged = list(elites) + [
        (float(obj), np.asarray(o, dtype=np.int64)) for obj, o in scored
    ]
    merged.sort(key=lambda p: p[0])
    seen: set[bytes] = set()
    out: list[tuple[float, np.ndarray]] = []
    for obj, o in merged:
        key = o.tobytes()
        if key in seen:
            continue
        seen.add(key)
        out.append((obj, o))
        if len(out) == max_elites:
            break
    return out


# -------------------------------------------------------------- batched


def refine_batch_arrays(
    ensemble: EnsembleBatch,
    orders: np.ndarray | torch.Tensor,
    refine=True,
    *,
    include_tau: bool = True,
    discipline: str = "greedy",
    engine: str = "kernel",
    alloc_fn: Callable | None = None,
    cct_fn: Callable | None = None,
) -> RefineOutcome:
    """Refine a whole ensemble's orders as one batched search.

    ``orders`` is the (B, Mp) padded incumbent array (the order stage's
    output, on the device or the host).  Each round fills
    ``spec.candidates`` rows per instance of the member-expanded batch and
    evaluates them in one pass: ``alloc_fn(expanded, orders) ->
    AllocationBatch`` and ``cct_fn(expanded, alloc) -> (B*k, Mp)`` CCTs,
    by default `allocate_batch_arrays` and `cct_batch_arrays` (the
    pipeline passes its own stages' array forms).
    """
    spec = as_refine_spec(refine)
    B = ensemble.num_instances
    k = spec.candidates
    if alloc_fn is None:
        alloc_fn = lambda ens, o: allocate_batch_arrays(  # noqa: E731
            ens, o, include_tau=include_tau
        )
    if cct_fn is None:
        cct_fn = lambda ens, a: cct_batch_arrays(  # noqa: E731
            ens, a, discipline=discipline, engine=engine
        )
    if isinstance(orders, torch.Tensor):
        orders = orders.cpu().numpy()
    orders = np.array(orders)
    Mp = orders.shape[1]
    if B == 0:
        return RefineOutcome(
            orders=orders, objective=np.zeros(0), base_objective=np.zeros(0),
            rounds=0, evaluations=0, batched=True,
        )

    expanded, _inst_of, _cand_of = ensemble.expand_members(k)
    weights = ensemble.weights.cpu().numpy()
    Ms = ensemble.num_coflows
    cursors = [0] * B
    elites: list[list[tuple[float, np.ndarray]]] = [[] for _ in range(B)]
    stale_limit = 1 if spec.stop_after_stale is None else spec.stop_after_stale
    stale = np.zeros(B, dtype=np.int64)
    done = np.zeros(B, dtype=bool)
    base = np.zeros(B)
    cur = np.zeros(B)
    evals = 0
    rounds_done = 0
    exp_orders = np.tile(np.arange(Mp, dtype=np.int64), (B * k, 1))
    cand_lists: list[list[np.ndarray]] = [[] for _ in range(B)]
    for rnd in range(spec.rounds):
        active = np.flatnonzero(~done)
        if active.size == 0:
            break
        for b in range(B):
            row0 = b * k
            inc = orders[b]
            exp_orders[row0: row0 + k] = inc  # slot 0, and frozen instances
            if done[b]:
                continue
            cands, cursors[b] = generate_candidates(
                inc[: Ms[b]], spec, rnd, cursors[b], elites[b]
            )
            for c, cand in enumerate(cands, start=1):
                exp_orders[row0 + c, : Ms[b]] = cand
            cand_lists[b] = [inc[: Ms[b]].copy()] + cands
        alloc = alloc_fn(expanded, torch.from_numpy(exp_orders).to(expanded.device))
        cct = cct_fn(expanded, alloc)
        rounds_done += 1
        evals += k * int(active.size)
        for b in active:
            M = Ms[b]
            w_vec = weights[b, :M]
            objs = np.array(
                [float(np.dot(w_vec, cct[b * k + c, :M])) for c in range(k)]
            )
            if rnd == 0:
                base[b] = objs[0]
            win = select_candidate(objs, tol=spec.tol)
            elites[b] = _update_elites(
                elites[b], [(objs[c], cand_lists[b][c]) for c in range(k)], spec.elites
            )
            cur[b] = objs[win]
            if win == 0:
                stale[b] += 1
                if stale[b] >= stale_limit:
                    done[b] = True
            else:
                stale[b] = 0
                orders[b, :M] = cand_lists[b][win]
    return RefineOutcome(
        orders=orders, objective=cur, base_objective=base,
        rounds=rounds_done, evaluations=evals, batched=True,
    )


# ----------------------------------------------------------- sequential


def refine_sequential(
    order: np.ndarray,
    refine,
    evaluate: Callable[[np.ndarray], float],
) -> tuple[np.ndarray, float, float, int, int]:
    """Per-instance oracle of `refine_batch_arrays`: the same rounds,
    candidates and selection, one order at a time through
    ``evaluate(order) -> float`` (`repro_torch.core.localsearch.
    evaluate_order`, or a pipeline's per-instance stages).

    Returns ``(refined_order, objective, base_objective, rounds,
    evaluations)``.
    """
    spec = as_refine_spec(refine)
    order = np.asarray(order, dtype=np.int64).copy()
    cursor = 0
    elites: list[tuple[float, np.ndarray]] = []
    stale_limit = 1 if spec.stop_after_stale is None else spec.stop_after_stale
    stale = 0
    base = cur = None
    evals = 0
    rounds_done = 0
    for rnd in range(spec.rounds):
        cands, cursor = generate_candidates(order, spec, rnd, cursor, elites)
        all_c = [order.copy()] + cands
        objs = np.array([evaluate(c) for c in all_c])
        evals += len(all_c)
        rounds_done += 1
        if rnd == 0:
            base = float(objs[0])
        win = select_candidate(objs, tol=spec.tol)
        elites = _update_elites(
            elites, [(objs[c], all_c[c]) for c in range(len(all_c))], spec.elites
        )
        cur = float(objs[win])
        if win == 0:
            stale += 1
            if stale >= stale_limit:
                break
        else:
            stale = 0
            order = all_c[win].copy()
    return order, cur, base, rounds_done, evals
