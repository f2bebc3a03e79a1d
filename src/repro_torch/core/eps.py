"""EPS variant of Algorithm 1 (paper Theorem 2: 4H / 4H+1 approximation).

Multi-core electrical packet switching: no reconfiguration (delta = 0), the
LP drops the reconfiguration-capacity constraints, the single-core lower
bound becomes rho^k_m / r^h, and the intra-core "circuit scheduling" becomes
priority fluid rate allocation: at every instant each port of core h has
capacity r^h shared by its flows; rates are assigned greedily in global
coflow priority order (work-conserving — leftover capacity flows to lower
priority), which is the EPS analogue of the port-matching greedy.

Port of `repro.core.eps`: the fluid simulation and the CCT fold in host
NumPy, bit for bit in f64 (its 1e-15 rate and 1e-9 completion thresholds
are the reference's); `run_eps` runs the port's ``"eps"`` pipeline, which
allocates on ``device`` and simulates each core on the host.
"""

from __future__ import annotations

import dataclasses

import numpy as np

import torch

from repro_torch.core import lp as lp_mod
from repro_torch.core.coflow import CoflowInstance

__all__ = ["EpsCoreSchedule", "fluid_schedule_core", "eps_ccts", "EpsResult", "run_eps"]


@dataclasses.dataclass
class EpsCoreSchedule:
    coflow: np.ndarray
    src: np.ndarray
    dst: np.ndarray
    size: np.ndarray
    complete: np.ndarray
    rate: float


def fluid_schedule_core(
    coflow: np.ndarray,
    src: np.ndarray,
    dst: np.ndarray,
    size: np.ndarray,
    priority: np.ndarray,
    releases: np.ndarray,
    num_ports: int,
    rate: float,
) -> EpsCoreSchedule:
    """Event-driven fluid simulation with greedy priority rate allocation."""
    F = int(coflow.shape[0])
    if F == 0:
        z = np.zeros(0)
        zi = np.zeros(0, dtype=np.int64)
        return EpsCoreSchedule(zi, zi, zi, z, z, rate)

    order = np.argsort(priority, kind="stable")
    coflow, src, dst, size = coflow[order], src[order], dst[order], size[order]
    rel = releases[coflow]
    remaining = size.astype(np.float64).copy()
    complete = np.full(F, -1.0)
    t = float(rel.min())
    active = remaining > 0

    for _ in range(4 * F + 4):  # each event completes >= 1 flow or releases
        live = active & (rel <= t)
        if not live.any():
            future = rel[active]
            if future.size == 0:
                break
            t = float(future.min())
            continue
        # Greedy priority water-fill: flows in priority order grab
        # min(remaining in-cap, remaining out-cap).
        cap_in = np.full(num_ports, rate)
        cap_out = np.full(num_ports, rate)
        rates_f = np.zeros(F)
        for f in np.nonzero(live)[0]:
            r = min(cap_in[src[f]], cap_out[dst[f]])
            if r > 1e-15:
                rates_f[f] = r
                cap_in[src[f]] -= r
                cap_out[dst[f]] -= r
        # Next event: earliest completion under these rates, or next release.
        with np.errstate(divide="ignore"):
            finish = np.where(rates_f > 0, remaining / np.maximum(rates_f, 1e-300), np.inf)
        dt = finish[live].min() if np.isfinite(finish[live]).any() else np.inf
        future = rel[active & (rel > t)]
        t_next_rel = future.min() if future.size else np.inf
        step = min(dt, t_next_rel - t)
        if not np.isfinite(step):  # pragma: no cover
            raise RuntimeError("EPS fluid simulation stalled")
        remaining -= rates_f * step
        t += step
        done = active & (remaining <= 1e-9)
        complete[done] = t
        active &= ~done
        if not active.any():
            break
    if active.any():  # pragma: no cover
        raise RuntimeError("EPS fluid simulation did not converge")
    return EpsCoreSchedule(coflow, src, dst, size, complete, rate)


def eps_ccts(
    instance: CoflowInstance,
    core_schedules: list[EpsCoreSchedule],
) -> np.ndarray:
    cct = np.zeros(instance.num_coflows)
    for cs in core_schedules:
        if len(cs.coflow):
            np.maximum.at(cct, cs.coflow, cs.complete)
    return cct


@dataclasses.dataclass
class EpsResult:
    order: np.ndarray
    ccts: np.ndarray
    total_weighted_cct: float
    lp_objective: float
    lp_completion: np.ndarray
    approx_ratio: float
    bound: float  # 4H (+1 with releases)
    theorem2_percoflow_violation: float  # max (T_m - a_m - 4H T~_m)


def run_eps(
    instance: CoflowInstance,
    lp_solution: lp_mod.LPSolution | None = None,
    device: str | torch.device = "cuda",
) -> EpsResult:
    """Algorithm 1 (EPS variant): H-core EPS, delta = 0 (paper Theorem 2).

    Runs the registered ``"eps"`` scheme of the port's pipeline (LP order,
    tau-blind greedy allocation on ``device``, fluid-rate circuit stage on
    the host) and wraps the result with the Theorem-2 bound bookkeeping.
    Without ``lp_solution`` it solves the exact LP (HiGHS).
    """
    from repro_torch.pipeline import get_pipeline

    if instance.delta != 0:
        raise ValueError("EPS variant requires delta == 0")
    sol = lp_mod.solve_exact(instance) if lp_solution is None else lp_solution
    res = get_pipeline("eps").run(
        instance, lp_solution=sol, validate=False, device=device
    )
    H = instance.num_cores
    ccts = res.ccts
    total = res.total_weighted_cct
    bound = 4.0 * H + (1.0 if (instance.releases > 0).any() else 0.0)
    viol = float(
        np.max(ccts - instance.releases - 4.0 * H * sol.completion)
    )
    return EpsResult(
        order=res.order,
        ccts=ccts,
        total_weighted_cct=total,
        lp_objective=sol.objective,
        lp_completion=sol.completion,
        approx_ratio=total / max(sol.objective, 1e-300),
        bound=bound,
        theorem2_percoflow_violation=viol,
    )
