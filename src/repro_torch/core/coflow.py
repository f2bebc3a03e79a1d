"""Coflow abstractions for K-core OCS scheduling (NumPy copy of
`repro.core.coflow`).

A coflow is an N x N demand matrix D_m with weight w_m and release a_m
(paper Sec. III-B/III-D).  Ports are indexed 0..N-1 (ingress) and
N..2N-1 (egress) so that per-port quantities live in flat (2N,) vectors.

The per-port statistics used throughout the paper:
  rho_{m,p} : aggregate load incident to port p in D_m        (Sec. IV-A)
  tau_{m,p} : number of nonzero entries incident to port p    (Sec. IV-A)

Prefix statistics use the *multiplicity* reading of tau (see DESIGN.md §1):
tau_{1:m,p} = sum_{l<=m} tau_{l,p} — one circuit establishment per subflow.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "CoflowInstance",
    "port_stats",
    "flows_of",
    "FlowTable",
    "flow_table",
]


def port_stats(demands: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-port load and reconfiguration counts.

    Args:
      demands: (M, N, N) nonnegative demand matrices.

    Returns:
      rho: (M, 2N) float — row sums (ingress ports 0..N-1) then column sums
        (egress ports N..2N-1).
      tau: (M, 2N) int — nonzero counts per row, then per column.
    """
    demands = np.asarray(demands)
    if demands.ndim == 2:
        demands = demands[None]
    nz = demands > 0
    rho = np.concatenate([demands.sum(axis=2), demands.sum(axis=1)], axis=-1)
    tau = np.concatenate([nz.sum(axis=2), nz.sum(axis=1)], axis=-1)
    return rho, tau.astype(np.int64)


@dataclasses.dataclass(frozen=True)
class CoflowInstance:
    """An instance of the K-core OCS multi-coflow scheduling problem."""

    demands: np.ndarray  # (M, N, N) float64
    weights: np.ndarray  # (M,) > 0
    releases: np.ndarray  # (M,) >= 0
    rates: np.ndarray  # (K,) per-port rate r^k of each core
    delta: float  # reconfiguration delay

    def __post_init__(self):
        d = np.asarray(self.demands, dtype=np.float64)
        object.__setattr__(self, "demands", d)
        object.__setattr__(
            self, "weights", np.asarray(self.weights, dtype=np.float64)
        )
        object.__setattr__(
            self, "releases", np.asarray(self.releases, dtype=np.float64)
        )
        object.__setattr__(self, "rates", np.asarray(self.rates, dtype=np.float64))
        if d.ndim != 3 or d.shape[1] != d.shape[2]:
            raise ValueError(f"demands must be (M, N, N), got {d.shape}")
        if (d < 0).any():
            raise ValueError("demands must be nonnegative")
        if self.weights.shape != (d.shape[0],):
            raise ValueError("weights shape mismatch")
        if self.releases.shape != (d.shape[0],):
            raise ValueError("releases shape mismatch")
        if (self.weights <= 0).any():
            raise ValueError("weights must be positive")
        if (self.rates <= 0).any():
            raise ValueError("core rates must be positive")
        if self.delta < 0:
            raise ValueError("delta must be nonnegative")

    # -- basic sizes ------------------------------------------------------
    @property
    def num_coflows(self) -> int:
        return self.demands.shape[0]

    @property
    def num_ports(self) -> int:
        return self.demands.shape[1]

    @property
    def num_cores(self) -> int:
        return self.rates.shape[0]

    @property
    def aggregate_rate(self) -> float:
        """R = sum_k r^k."""
        return float(self.rates.sum())

    # -- derived stats ----------------------------------------------------
    def port_stats(self) -> tuple[np.ndarray, np.ndarray]:
        """(rho, tau): each (M, 2N)."""
        return port_stats(self.demands)

    def max_port_load(self) -> np.ndarray:
        """rho_m = max_p rho_{m,p}, shape (M,)."""
        rho, _ = self.port_stats()
        return rho.max(axis=1)

    def global_lower_bound(self) -> np.ndarray:
        """Allocation-independent single-coflow LB of [31]: delta + rho_m/R."""
        return self.delta + self.max_port_load() / self.aggregate_rate


def flows_of(demand: np.ndarray):
    """Nonzero flows (i, j, d) of one demand matrix, largest first.

    Returns (i_idx, j_idx, sizes) arrays sorted by size descending
    (Algorithm 1 Line 8; stable so equal sizes keep row-major order).
    """
    i_idx, j_idx = np.nonzero(demand)
    sizes = demand[i_idx, j_idx]
    order = np.argsort(-sizes, kind="stable")
    return i_idx[order], j_idx[order], sizes[order]


@dataclasses.dataclass
class FlowTable:
    """Flat table of all nonzero flows of an instance.

    Fields are parallel arrays over flows; `coflow` indexes the original
    (un-reordered) coflow id.
    """

    coflow: np.ndarray  # (F,) int
    src: np.ndarray  # (F,) int in [0, N)
    dst: np.ndarray  # (F,) int in [0, N)
    size: np.ndarray  # (F,) float

    def __len__(self) -> int:
        return int(self.coflow.shape[0])


def flow_table(instance: CoflowInstance) -> FlowTable:
    ms, is_, js = np.nonzero(instance.demands)
    return FlowTable(
        coflow=ms.astype(np.int64),
        src=is_.astype(np.int64),
        dst=js.astype(np.int64),
        size=instance.demands[ms, is_, js],
    )
