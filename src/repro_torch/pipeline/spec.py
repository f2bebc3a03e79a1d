"""Declarative scheme specifications and the scheme registry.

Port of `repro.pipeline.spec`, holding the schemes this port can run: the
paper's Algorithm 1 (``ours``).  The other registry schemes (WSPT-ORDER,
LOAD-ONLY, SUNFLOW-S, BvN-S, EPS) and refinement (`RefineSpec`,
``ours_ls``) are not ported yet.
"""

from __future__ import annotations

import dataclasses

__all__ = ["SchemeSpec", "register_scheme", "get_scheme", "list_schemes"]


@dataclasses.dataclass(frozen=True)
class SchemeSpec:
    """One scheduling scheme as stage choices.

    Attributes:
      key: registry key (``"ours"``).
      name: display name used in results (``"OURS"``).
      order: ordering stage kind -- ``"lp"``.
      include_tau: allocation stage flag; False drops the reconfiguration
        term (the LOAD-ONLY ablation).
      circuit: circuit stage kind -- ``"list"`` (the not-all-stop
        port-matching list scheduler).
      discipline: pins the list-scheduler discipline (``"greedy"`` /
        ``"reserving"``); None defers to the caller's default.
    """

    key: str
    name: str
    order: str = "lp"
    include_tau: bool = True
    circuit: str = "list"
    discipline: str | None = None


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


register_scheme(SchemeSpec(key="ours", name="OURS"))
