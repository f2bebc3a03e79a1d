"""Prefix port statistics for the certificate (NumPy copy of the part of
`repro.core.lower_bounds` that `repro_torch.core.theory.certify` reaches).

Prefix statistics use tau with multiplicity (DESIGN.md §1): the prefix
reconfiguration count on a port is the *sum over coflows* of per-coflow
nonzero counts, because each scheduled subflow pays its own circuit
establishment (Algorithm 1 Line 24).
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.coflow import CoflowInstance, port_stats

__all__ = ["prefix_port_stats"]


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
