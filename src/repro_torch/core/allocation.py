"""Inter-core flow allocation (Algorithm 1 Lines 3-15).

Port of `repro.core.allocation`: the result type and `allocate`, the
per-instance host NumPy oracle.  Pipelines allocate batched on the device
(`repro_torch.pipeline.batch_alloc`), which gives the same bits.

Prefix-aware greedy: coflows processed in the global order; within a coflow,
flows largest-first; each flow goes whole to the core minimizing the
post-placement single-core prefix lower bound

    T^k_LB(D^k_{1:m} (+) d) = max_p ( rho^k_{1:m,p} / r^k + tau^k_{1:m,p} * delta ).

Placing flow (i, j, d) only changes ports i and N + j, and all per-port
terms are monotone non-decreasing, so

    LB_after(k) = max(LB(k), L(k, i), L(k, N + j))

with L(k, p) the updated port term -- an O(K) incremental update per flow.
The LOAD-ONLY baseline drops the tau term.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.coflow import CoflowInstance, flows_of

__all__ = ["Allocation", "allocate"]


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

    def per_core_demand(self, num_coflows: int, num_ports: int) -> np.ndarray:
        """Materialize D^k_m as a dense (K, M, N, N) tensor."""
        K = self.rho_ports.shape[0]
        out = np.zeros((K, num_coflows, num_ports, num_ports))
        np.add.at(out, (self.core, self.coflow, self.src, self.dst), self.size)
        return out


def allocate(
    instance: CoflowInstance,
    order: np.ndarray,
    include_tau: bool = True,
) -> Allocation:
    """Run the greedy allocation along `order`.

    Args:
      instance: problem instance.
      order: (M,) permutation — global coflow priority (highest first).
      include_tau: False gives the LOAD-ONLY ablation (core chosen by
        post-placement max load / rate only; paper Sec. V-B).
    """
    M, N, K = instance.num_coflows, instance.num_ports, instance.num_cores
    rates = instance.rates
    delta = instance.delta if include_tau else 0.0

    rho = np.zeros((K, 2 * N))
    tau = np.zeros((K, 2 * N))
    lb = np.zeros(K)

    out_m, out_i, out_j, out_d, out_k = [], [], [], [], []
    prefix_lb = np.zeros(M)

    inv_rates = 1.0 / rates
    for pos, m in enumerate(order):
        i_idx, j_idx, sizes = flows_of(instance.demands[m])
        for i, j, d in zip(i_idx, j_idx, sizes):
            pi, pj = i, N + j
            # Candidate LB on every core if this flow lands there.
            li = (rho[:, pi] + d) * inv_rates + (tau[:, pi] + 1.0) * delta
            lj = (rho[:, pj] + d) * inv_rates + (tau[:, pj] + 1.0) * delta
            cand = np.maximum(lb, np.maximum(li, lj))
            k = int(np.argmin(cand))
            rho[k, pi] += d
            rho[k, pj] += d
            tau[k, pi] += 1.0
            tau[k, pj] += 1.0
            lb[k] = cand[k]
            out_m.append(m)
            out_i.append(i)
            out_j.append(j)
            out_d.append(d)
            out_k.append(k)
        prefix_lb[pos] = lb.max() if lb.size else 0.0

    return Allocation(
        coflow=np.asarray(out_m, dtype=np.int64),
        src=np.asarray(out_i, dtype=np.int64),
        dst=np.asarray(out_j, dtype=np.int64),
        size=np.asarray(out_d, dtype=np.float64),
        core=np.asarray(out_k, dtype=np.int64),
        rho_ports=rho,
        tau_ports=tau,
        prefix_lb=prefix_lb,
    )
