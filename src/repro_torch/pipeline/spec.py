"""Declarative scheme specifications and the scheme registry.

Port of `repro.pipeline.spec`.  The paper's Algorithm 1 is three composable
phases -- LP-guided ordering, inter-core flow allocation, intra-core circuit
scheduling -- and every ablation in Sec. V-B varies exactly one of them.  A
`SchemeSpec` captures that as data; the registry holds the five paper
schemes (`PAPER_SCHEMES`), Theorem 2's EPS variant and ``ours_ls``,
Algorithm 1 with candidate-search refinement (`RefineSpec`,
`repro_torch.pipeline.refine`).
"""

from __future__ import annotations

import dataclasses

__all__ = [
    "SchemeSpec", "RefineSpec", "REFINE_GENERATORS", "PAPER_SCHEMES",
    "register_scheme", "get_scheme", "list_schemes",
]

#: Candidate generators `repro_torch.pipeline.refine` understands.
REFINE_GENERATORS = ("adjacent", "perturb", "crossover")


@dataclasses.dataclass(frozen=True)
class RefineSpec:
    """Candidate-search refinement config -- the quality-vs-compute dial.

    Each round evaluates ``candidates`` orders per instance (slot 0 is the
    incumbent) in one batched alloc + circuit pass over the
    member-expanded `EnsembleBatch`, keeps per-instance winners under
    `repro_torch.core.localsearch.select_candidate`, and stops early once
    no instance improves.  Only improving candidates are accepted, so a
    refined schedule keeps the paper's (8K+1) guarantee.

    Attributes:
      rounds: maximum search rounds (>= 1).
      candidates: rows per instance per round, incumbent included (>= 1).
      generators: cycle of candidate generators filling slots 1.. --
        ``"adjacent"`` (a rolling window over the adjacent-transposition
        neighborhood), ``"perturb"`` (incumbent positions + ``sigma`` x
        Gaussian noise, stable argsort), ``"crossover"`` (order crossover
        of two elite orders; perturb until the pool holds two).
      seed: base seed; every (round, slot) draws from its own
        ``np.random.default_rng((seed, round, slot))`` per instance, so
        candidates do not depend on the batch's other members.
      sigma: perturbation strength in order-position units.
      elites: per-instance elite-pool size for crossover parents (>= 2).
      tol: accept/tie tolerance (`repro_torch.core.localsearch.TOL`).
      stop_after_stale: freeze an instance after this many consecutive
        non-improving rounds; ``None`` freezes on the first (as ``1``).
    """

    rounds: int = 2
    candidates: int = 8
    generators: tuple = REFINE_GENERATORS
    seed: int = 0
    sigma: float = 2.0
    elites: int = 4
    tol: float = 1e-9
    stop_after_stale: int | None = None


@dataclasses.dataclass(frozen=True)
class SchemeSpec:
    """One scheduling scheme as stage choices.

    Attributes:
      key: registry key (``"ours"``, ``"wspt_order"``, ...).
      name: display name used in results (``"OURS"``, ...).
      order: ordering stage kind -- ``"lp"`` | ``"wspt"`` | ``"fifo"``.
      include_tau: allocation stage flag; False drops the reconfiguration
        term (the LOAD-ONLY ablation).
      circuit: circuit stage kind -- ``"list"`` (not-all-stop port-matching
        list scheduler), ``"sequential"`` (Sunflow-style one-coflow-at-a-
        time), ``"bvn"`` (Birkhoff-von Neumann, all-stop), or ``"fluid"``
        (EPS priority fluid rates, Theorem 2).
      discipline: pins the list-scheduler discipline (``"greedy"`` /
        ``"reserving"``); None defers to the caller's default.
      refine: candidate-search refinement on the realized objective
        (`RefineSpec`), or None for Algorithm 1 as it is.
    """

    key: str
    name: str
    order: str = "lp"
    include_tau: bool = True
    circuit: str = "list"
    discipline: str | None = None
    refine: RefineSpec | None = None


#: The five Sec. V-B schemes, in the order figures report them.
PAPER_SCHEMES = ("ours", "wspt_order", "load_only", "sunflow_s", "bvn_s")

_REGISTRY: dict[str, SchemeSpec] = {}


def register_scheme(spec: SchemeSpec, replace: bool = False) -> SchemeSpec:
    """Add a spec to the registry (keys are case-insensitive);
    ``replace=True`` allows overriding a registered key."""
    key = spec.key.lower()
    if not replace and key in _REGISTRY:
        raise ValueError(f"scheme {spec.key!r} already registered")
    _REGISTRY[key] = spec
    return spec


def get_scheme(key: str) -> SchemeSpec:
    try:
        return _REGISTRY[key.lower()]
    except KeyError:
        raise ValueError(
            f"unknown scheme {key!r}; registered: {', '.join(_REGISTRY)}"
        ) from None


def list_schemes() -> tuple[str, ...]:
    return tuple(_REGISTRY)


for _spec in (
    # The paper's Algorithm 1 and its Sec. V-B ablations, as data.
    SchemeSpec(key="ours", name="OURS"),
    SchemeSpec(key="wspt_order", name="WSPT-ORDER", order="wspt"),
    SchemeSpec(key="load_only", name="LOAD-ONLY", include_tau=False),
    SchemeSpec(key="sunflow_s", name="SUNFLOW-S", circuit="sequential"),
    SchemeSpec(key="bvn_s", name="BVN-S", circuit="bvn"),
    # Theorem 2's multi-core EPS variant (delta = 0, fluid priority rates).
    SchemeSpec(key="eps", name="EPS", include_tau=False, circuit="fluid"),
    # Beyond the paper: Algorithm 1 + batched candidate-search refinement
    # on the realized objective (never worse than OURS; same (8K+1) bound).
    SchemeSpec(key="ours_ls", name="OURS+LS", refine=RefineSpec()),
):
    register_scheme(_spec)
del _spec
