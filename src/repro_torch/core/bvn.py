"""Birkhoff–von Neumann decomposition + all-stop executor (BvN-S baseline).

Port of `repro.core.bvn`, in host NumPy, bit for bit in f64.

BvN-S (paper Sec. V-B): replace the intra-core circuit scheduler with BvN
decomposition under the *all-stop* model.  Per core, coflows are served in
the global order; each coflow's per-core demand matrix is stuffed to a
constant-line-sum matrix (doubly-"stochastic" up to scale), decomposed into
weighted permutation matrices, and each configuration is executed
synchronously: every switch costs delta (all ports stopped), then all
circuits of the permutation transmit for coef / r^k.

The stuffing traffic is dummy padding — transmitting it is wasted time, which
together with the per-configuration all-stop delta is exactly why BvN-S
trails the not-all-stop greedy (paper Fig. 3).
"""

from __future__ import annotations

import numpy as np

__all__ = ["stuff_to_constant_line_sums", "bvn_decompose", "bvn_execute_core"]


def stuff_to_constant_line_sums(mat: np.ndarray) -> np.ndarray:
    """Add dummy traffic so all row and column sums equal max line sum."""
    m = mat.astype(np.float64).copy()
    n = m.shape[0]
    target = max(m.sum(axis=1).max(), m.sum(axis=0).max()) if m.size else 0.0
    if target <= 0:
        return m
    for _ in range(2 * n * n):  # each step zeroes at least one deficit
        row_def = target - m.sum(axis=1)
        col_def = target - m.sum(axis=0)
        row_def[row_def < 1e-12] = 0.0
        col_def[col_def < 1e-12] = 0.0
        if not row_def.any() and not col_def.any():
            break
        i = int(np.argmax(row_def))
        j = int(np.argmax(col_def))
        add = min(row_def[i], col_def[j])
        if add <= 0:  # pragma: no cover - total row defs == total col defs
            break
        m[i, j] += add
    return m


def _perfect_matching(positive: np.ndarray) -> np.ndarray | None:
    """Kuhn's augmenting-path perfect matching on the positive-entry graph.

    Returns match_col: (N,) col index per row, or None if no perfect matching.
    """
    n = positive.shape[0]
    adj = [np.nonzero(positive[i])[0] for i in range(n)]
    match_of_col = np.full(n, -1, dtype=np.int64)

    def try_augment(row: int, seen: np.ndarray) -> bool:
        for col in adj[row]:
            if seen[col]:
                continue
            seen[col] = True
            if match_of_col[col] < 0 or try_augment(int(match_of_col[col]), seen):
                match_of_col[col] = row
                return True
        return False

    for row in range(n):
        if not try_augment(row, np.zeros(n, dtype=bool)):
            return None
    match_col = np.empty(n, dtype=np.int64)
    match_col[match_of_col] = np.arange(n)
    return match_col


def bvn_decompose(
    mat: np.ndarray, atol: float = 1e-9
) -> list[tuple[float, np.ndarray]]:
    """Decompose a constant-line-sum matrix into (coef, permutation) pairs.

    Birkhoff's theorem guarantees a perfect matching exists on the positive
    entries of any constant-line-sum nonnegative matrix; subtracting the
    min-weight matching zeroes >= 1 entry per round, so <= nnz rounds.
    """
    m = mat.astype(np.float64).copy()
    n = m.shape[0]
    out: list[tuple[float, np.ndarray]] = []
    for _ in range(n * n + 1):
        if m.max(initial=0.0) <= atol:
            break
        match_col = _perfect_matching(m > atol)
        if match_col is None:
            # Numerical residue can break exact constant sums; re-stuff.
            m = stuff_to_constant_line_sums(m)
            match_col = _perfect_matching(m > atol)
            if match_col is None:  # pragma: no cover
                raise RuntimeError("BvN: no perfect matching on positive graph")
        coef = float(m[np.arange(n), match_col].min())
        out.append((coef, match_col.copy()))
        m[np.arange(n), match_col] -= coef
    return out


def bvn_execute_core(
    per_coflow_mats: list[tuple[int, np.ndarray]],
    releases: np.ndarray,
    rate: float,
    delta: float,
) -> dict[int, float]:
    """All-stop execution of BvN configurations, one coflow at a time.

    Args:
      per_coflow_mats: [(coflow_id, D^k_m)] in global priority order.
      releases: (M,) release times.
      rate: r^k.
      delta: all-stop reconfiguration delay per configuration switch.

    Returns: {coflow_id: completion time on this core}.
    """
    t = 0.0
    done: dict[int, float] = {}
    for m_id, mat in per_coflow_mats:
        if mat.max(initial=0.0) <= 0:
            continue
        t = max(t, float(releases[m_id]))
        stuffed = stuff_to_constant_line_sums(mat)
        for coef, _perm in bvn_decompose(stuffed):
            t += delta + coef / rate  # all-stop: switch, then transmit
        done[m_id] = t
    return done
