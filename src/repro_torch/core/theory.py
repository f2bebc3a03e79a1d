"""Per-instance certificates of the paper's analysis chain (Sec. IV-C).

NumPy copy of `repro.core.theory`: the certificate is the auditor's own
host-side computation, independent of the device stages it audits.

Each check mirrors one lemma/theorem; together they certify, on a concrete
instance, exactly the inequality chain used to prove the (8K+1) bound:

  Lemma 2:  rho_{1:m}  <= 2 R T~_m                     (ordering phase)
  Lemma 3:  tau_{1:m}  <= (2K/delta) T~_m              (ordering phase)
  Lemma 4:  max_k T^k_LB(D^k_{1:m}) <= rho_{1:m}/r_max + tau_{1:m} delta
                                                        (allocation phase)
  Lemma 5:  T_m <= a_m + 2 max_k T^k_LB(D^k_{1:m})     (scheduling phase)
  Thm 1:    T_m <= a_m + 8K T~_m  and  sum w T <= (8K+1) sum w T~.

tau uses the multiplicity reading (DESIGN.md §1).  All functions return the
maximum violation (<= tol means the certificate holds).

REPRODUCTION FINDING (see EXPERIMENTS.md §Repro): Lemma 5's factor-2 busy-
time accounting does not hold verbatim for either natural reading of the
intra-core scheduler.  The greedy scheduler (paper Line 23 read literally)
satisfies the "no idle port pair" step of the proof but lets
*lower-priority* flows occupy i*/j* (the proof counts prefix traffic only);
the reserving variant makes the accounting prefix-only but can leave both
ports reserved-idle.  Measured Lemma-5 factors: reserving <= ~3.5 across
all tested instances (zero AND trace releases); greedy up to ~24 under
arbitrary releases — and with arbitrary releases greedy also violates the
*per-coflow* Theorem-1 bound T_m <= a_m + 8K T~_m (violations up to ~140
time units on trace instances), while RESERVING never violated it.  The
paper's proof is therefore consistent with the reserving reading of its
"work-conserving ... on a port pair" property, not with literal greedy
backfilling.  Greedy remains the better *practical* scheduler on aggregate
weighted CCT (what Fig. 3/6 report), and the aggregate (8K+1) ratio held
with large margin for both disciplines on every instance tested.  `ok()`
checks the chain the paper's Theorem actually claims; certify with
discipline="reserving" for the per-coflow guarantee.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.allocation import Allocation
from repro_torch.core.coflow import CoflowInstance
from repro_torch.core.lower_bounds import prefix_port_stats

__all__ = ["CertificateReport", "certify"]


@dataclasses.dataclass
class CertificateReport:
    lemma2_violation: float
    lemma3_violation: float
    lemma4_violation: float
    lemma5_violation: float  # informational — see module docstring
    lemma5_factor: float  # tightest c with T_m <= a_m + c * max_k T^k_LB
    theorem1_percoflow_violation: float
    approx_ratio: float  # sum w T / sum w T~ (paper's "Approx" metric)
    bound: float  # 8K (+1 if any release > 0)

    def ok(self, tol: float = 1e-6) -> bool:
        """The chain Theorem 1 claims (Lemma 5 reported separately)."""
        return (
            self.lemma2_violation <= tol
            and self.lemma3_violation <= tol
            and self.lemma4_violation <= tol
            and self.theorem1_percoflow_violation <= tol
            and self.approx_ratio <= self.bound + tol
        )

    def lemma5_ok(self, tol: float = 1e-6) -> bool:
        return self.lemma5_violation <= tol


def _per_core_prefix_lb(
    instance: CoflowInstance, allocation: Allocation, order: np.ndarray
) -> np.ndarray:
    """max_k T^k_LB(D^k_{1:m}) after each prefix, recomputed from scratch.

    Independent of the incremental values tracked inside `allocate` — this is
    the *auditor's* computation for Lemma 4/5 checks.
    """
    M, N, K = instance.num_coflows, instance.num_ports, instance.num_cores
    pos = np.empty(M, dtype=np.int64)
    pos[order] = np.arange(M)
    rho = np.zeros((K, 2 * N))
    tau = np.zeros((K, 2 * N))
    out = np.zeros(M)
    f_pos = pos[allocation.coflow]
    lb = np.zeros(K)
    order_f = np.argsort(f_pos, kind="stable")
    fi = 0
    flows = (
        allocation.coflow[order_f],
        allocation.src[order_f],
        allocation.dst[order_f],
        allocation.size[order_f],
        allocation.core[order_f],
        f_pos[order_f],
    )
    for p_rank in range(M):
        while fi < len(order_f) and flows[5][fi] == p_rank:
            _, i, j, d, k, _ = (arr[fi] for arr in flows)
            rho[k, i] += d
            rho[k, N + j] += d
            tau[k, i] += 1
            tau[k, N + j] += 1
            fi += 1
        per_core = (
            rho / instance.rates[:, None] + tau * instance.delta
        ).max(axis=1)
        out[p_rank] = per_core.max()
    return out


def certify(
    instance: CoflowInstance,
    order: np.ndarray,
    lp_completion: np.ndarray,
    allocation: Allocation,
    ccts: np.ndarray,
) -> CertificateReport:
    """Check Lemmas 2-5 and Theorem 1 on a solved instance.

    Args:
      order: global order used (coflow ids, highest priority first).
      lp_completion: T~_m from the *exact* LP (original indexing).
      allocation: result of the allocation phase.
      ccts: realized T_m (original indexing).
    """
    M = instance.num_coflows
    K = instance.num_cores
    R = instance.aggregate_rate
    delta = instance.delta
    r_max = float(instance.rates.max())

    T_sorted = lp_completion[order]
    rho_prefix, tau_prefix = prefix_port_stats(instance, order)
    rho_1m = rho_prefix.max(axis=1)  # (M,) rho_{1:m}
    tau_1m = tau_prefix.max(axis=1)

    l2 = float(np.max(rho_1m - 2.0 * R * T_sorted))
    if delta > 0:
        l3 = float(np.max(tau_1m * delta / (2.0 * K) - T_sorted))
    else:
        l3 = 0.0

    lhs4 = _per_core_prefix_lb(instance, allocation, order)
    rhs4 = rho_1m / r_max + tau_1m * delta
    l4 = float(np.max(lhs4 - rhs4))

    ccts_sorted = ccts[order]
    rel_sorted = instance.releases[order]
    l5 = float(np.max(ccts_sorted - (rel_sorted + 2.0 * lhs4)))
    l5_factor = float(
        np.max((ccts_sorted - rel_sorted) / np.maximum(lhs4, 1e-300))
    )

    per_coflow = float(np.max(ccts_sorted - (rel_sorted + 8.0 * K * T_sorted)))

    num = float(np.dot(instance.weights, ccts))
    den = float(np.dot(instance.weights, lp_completion))
    ratio = num / max(den, 1e-300)
    bound = 8.0 * K + (1.0 if (instance.releases > 0).any() else 0.0)

    return CertificateReport(
        lemma2_violation=l2,
        lemma3_violation=l3,
        lemma4_violation=l4,
        lemma5_violation=l5,
        lemma5_factor=l5_factor,
        theorem1_percoflow_violation=per_coflow,
        approx_ratio=ratio,
        bound=bound,
    )
