"""Lower bounds for K-core OCS coflow scheduling (paper Sec. IV-A; NumPy
copy of `repro.core.lower_bounds`).

Single-core lower bound (Eq. 1 / Lemma 1): for traffic D on core k,
    T^k_LB(D) = max_p ( rho_p / r^k + tau_p * delta ).

Prefix statistics use tau with multiplicity (DESIGN.md §1): the prefix
reconfiguration count on a port is the *sum over coflows* of per-coflow
nonzero counts, because each scheduled subflow pays its own circuit
establishment (Algorithm 1 Line 24).
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.coflow import CoflowInstance, port_stats

__all__ = [
    "single_core_lb",
    "single_core_lb_ports",
    "prefix_port_stats",
    "allocation_upper_bound_rhs",
]


def single_core_lb_ports(
    rho_ports: np.ndarray, tau_ports: np.ndarray, rate: float, delta: float
) -> np.ndarray:
    """Per-port terms L_p = rho_p / r + tau_p * delta (any leading batch dims)."""
    return rho_ports / rate + tau_ports * delta


def single_core_lb(
    rho_ports: np.ndarray, tau_ports: np.ndarray, rate: float, delta: float
) -> float:
    """T^k_LB = max_p (rho_p / r^k + tau_p * delta)  (Eq. 1).

    Accepts (2N,) port vectors for a single core.  Zero matrices give 0.
    """
    return float(np.max(single_core_lb_ports(rho_ports, tau_ports, rate, delta)))


def prefix_port_stats(
    instance: CoflowInstance, order: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Cumulative per-port stats along `order`.

    Returns (rho_prefix, tau_prefix), each (M, 2N): row r holds the stats of
    the first r+1 coflows in the given order (tau with multiplicity).
    """
    rho, tau = port_stats(instance.demands)
    rho_o = rho[order]
    tau_o = tau[order]
    return np.cumsum(rho_o, axis=0), np.cumsum(tau_o, axis=0)


def allocation_upper_bound_rhs(
    instance: CoflowInstance, rho_prefix_max: np.ndarray, tau_prefix_max: np.ndarray
) -> np.ndarray:
    """RHS of Lemma 4: rho_{1:m}/r_max + tau_{1:m} * delta, shape (M,)."""
    r_max = float(instance.rates.max())
    return rho_prefix_max / r_max + tau_prefix_max * instance.delta
