"""Result type of the inter-core flow allocation (Algorithm 1 Lines 3-15).

The port computes allocations batched on the device
(`repro_torch.pipeline.batch_alloc`); this module holds only the
per-instance result type, field for field `repro.core.allocation.Allocation`.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["Allocation"]


@dataclasses.dataclass
class Allocation:
    """Result of the inter-core allocation phase.

    Parallel arrays over all nonzero flows, in allocation (i.e. scheduling
    priority) order: coflow id (original indexing), src / dst port, size,
    assigned core.
    """

    coflow: np.ndarray  # (F,) int64
    src: np.ndarray  # (F,) int64
    dst: np.ndarray  # (F,) int64
    size: np.ndarray  # (F,) float64
    core: np.ndarray  # (F,) int64
    # Final per-core per-port prefix stats (K, 2N) — for theory checks.
    rho_ports: np.ndarray
    tau_ports: np.ndarray
    # Per-coflow-prefix max-over-cores LB after each coflow, (M,) in order.
    prefix_lb: np.ndarray

    def num_flows(self) -> int:
        return int(self.coflow.shape[0])
