"""Declarative scheme specifications and the scheme registry.

Port of `repro.pipeline.spec`.  The paper's Algorithm 1 is three composable
phases -- LP-guided ordering, inter-core flow allocation, intra-core circuit
scheduling -- and every ablation in Sec. V-B varies exactly one of them.  A
`SchemeSpec` captures that as data; the registry holds the five paper
schemes (`PAPER_SCHEMES`) and Theorem 2's EPS variant.  Refinement
(`RefineSpec`, ``ours_ls``) is not ported yet.
"""

from __future__ import annotations

import dataclasses

__all__ = [
    "SchemeSpec", "PAPER_SCHEMES", "register_scheme", "get_scheme", "list_schemes",
]


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
    """

    key: str
    name: str
    order: str = "lp"
    include_tau: bool = True
    circuit: str = "list"
    discipline: str | None = None


#: The five Sec. V-B schemes, in the order figures report them.
PAPER_SCHEMES = ("ours", "wspt_order", "load_only", "sunflow_s", "bvn_s")

_REGISTRY: dict[str, SchemeSpec] = {}


def register_scheme(spec: SchemeSpec) -> SchemeSpec:
    """Add a spec to the registry (keys are case-insensitive)."""
    key = spec.key.lower()
    if key in _REGISTRY:
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
):
    register_scheme(_spec)
del _spec
