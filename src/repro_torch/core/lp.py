"""Ordering LP of the K-core OCS problem (paper Sec. IV-A2).

Port of `repro.core.lp`.  Variables: completion times T_m and pairwise
precedences x_{m,m'} in [0, 1] with x_{m,m'} + x_{m',m} = 1; per coflow m
and port p

  transmission (Eq. 4):     T_m >= (1/R) ( rho_{m,p} + sum_{m'!=m} rho_{m',p} x_{m',m} )
  reconfiguration (Eq. 5):  T_m >= (delta/K) ( tau_{m,p} + sum_{m'!=m} tau_{m',p} x_{m',m} )
  release (Eq. 6):          T_m >= a_m

and the objective min sum_m w_m T_m.  Three solvers:

  * `solve_exact` -- SciPy/HiGHS on the host, on the reduced LP
    (x_{m',m} = 1 - x_{m,m'} for m < m' eliminated): the reference's
    NumPy code, the same HiGHS call on the same arrays.
  * `solve_subgradient` -- one instance: projected Adam on the
    temperature-annealed smoothed objective (a Python loop in place of
    ``lax.scan``), on the device.
  * `solve_subgradient_batch` -- the same iteration for a bucket of
    instances padded to one shape, batched over the leading member axis
    (a written-out batch axis in place of ``vmap``).

The streaming service's warm starts live here too: `warm_start_Y0_dense`
(any order, default the weighted lower-bound one) and the resident warm
state's gather and scatter on the device (`warm_gather_device`,
`warm_scatter_device`).

In both subgradient solvers the smooth annealed-logsumexp gradient is
autograd over plain matrix products (the JAX package leaves that product
to XLA, outside any kernel), and the hard-max objective of every step
(best-so-far tracking, the start and the returned T) is a kernel --
`lp_terms` for one instance, `lp_terms_batch` for a bucket -- then a max
with the releases.  Matrix products run in full f32: TF32 is switched off
where the solvers run.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Sequence

import numpy as np
import scipy.sparse as sp
import torch
from scipy.optimize import linprog

from repro_torch.core import coflow
from repro_torch.core.coflow import CoflowInstance
from repro_torch.device import resolve_device
from repro_torch.kernels.lp_terms import lp_terms, lp_terms_batch
from repro_torch.kernels.port_stats import port_stats

__all__ = [
    "LPSolution",
    "LPSolutionBatch",
    "solve_exact",
    "solve_subgradient",
    "pack_lp_arrays",
    "solve_subgradient_batch",
    "solve_subgradient_batch_arrays",
    "warm_start_Y0_dense",
    "warm_gather_device",
    "warm_scatter_device",
]

#: Solver inputs of `pack_lp_arrays`, in `solve_subgradient_batch_arrays` order.
LP_ARRAY_NAMES = (
    "Y0", "p_rho", "p_tau", "weights", "releases", "inv_R",
    "delta_over_K", "coflow_mask", "port_mask",
)


@dataclasses.dataclass(frozen=True)
class LPSolution:
    """Solution of the ordering LP relaxation (host NumPy)."""

    completion: np.ndarray  # (M,) T~_m
    precedence: np.ndarray  # (M, M) x_{m,m'}; diag = 0 by convention
    objective: float  # sum_m w_m T~_m
    method: str
    iterations: int = 0

    def order(self) -> np.ndarray:
        """Coflow ids sorted by non-decreasing T~_m (Algorithm 1 Line 2)."""
        return np.argsort(self.completion, kind="stable")


def _precedence_from_Y(Y: np.ndarray) -> np.ndarray:
    """Full precedence matrix (diag 0, x_ab + x_ba = 1) from the solver's
    strict-upper-triangular Y."""
    M = Y.shape[0]
    x = np.zeros((M, M))
    iu = np.triu_indices(M, k=1)
    x[iu] = Y[iu]
    x[(iu[1], iu[0])] = 1.0 - Y[iu]
    return x


@dataclasses.dataclass(frozen=True)
class LPSolutionBatch:
    """Padded ensemble solution of the ordering LP, as device tensors.

    One row per bucket member, padded to the bucket shape; padded coflow
    slots carry completion 0.  `order_batch` turns the completions into
    every member's global order in one masked stable argsort; `unpack`
    materializes per-instance `LPSolution`s on the host.
    """

    completion: torch.Tensor  # (B, Mp) f32 T~_m, 0 on padded slots
    y: torch.Tensor  # (B, Mp, Mp) f32 strict-upper-tri precedence values
    objective: torch.Tensor  # (B,) f32 sum_m w_m T~_m
    method: str
    iterations: int = 0

    def order_batch(self, coflow_mask: torch.Tensor) -> torch.Tensor:
        """(B, Mp) padded orders: non-decreasing T~_m per member, padded
        slots pushed stably to the tail (Algorithm 1 Line 2)."""
        key = torch.where(
            coflow_mask, self.completion.to(torch.float64), math.inf
        )
        return torch.argsort(key, dim=1, stable=True)

    def unpack(self, num_coflows: Sequence[int]) -> list[LPSolution]:
        """Per-instance `LPSolution`s (host f64, as the reference's)."""
        comp = self.completion.cpu().numpy().astype(np.float64)
        y = self.y.cpu().numpy().astype(np.float64)
        obj = self.objective.cpu().numpy().astype(np.float64)
        return [
            LPSolution(
                completion=comp[b, :M],
                precedence=_precedence_from_Y(y[b, :M, :M]),
                objective=float(obj[b]),
                method=self.method,
                iterations=self.iterations,
            )
            for b, M in enumerate(num_coflows)
        ]


# ---------------------------------------------------------------------------
# Exact solver (HiGHS, host)
# ---------------------------------------------------------------------------


def _pair_index(m: int):
    """Map (a, b), a < b -> flat pair id; returns (ia, ib, P)."""
    ia, ib = np.triu_indices(m, k=1)
    return ia, ib, ia.shape[0]


def solve_exact(instance: CoflowInstance) -> LPSolution:
    """Solve the ordering LP exactly with SciPy's HiGHS backend (host).

    Reduced variables: z = [T_1..T_M, y_1..y_P] with y_{(a,b)} = x_{a,b} for
    a < b (so x_{b,a} = 1 - y_{(a,b)}).  Constraint rows (<= form):

      -T_m + (1/R) [ sum_{m'<m} rho_{m',p} y_{(m',m)}
                     - sum_{m'>m} rho_{m',p} y_{(m,m')} ]
          <= -(1/R) [ rho_{m,p} + sum_{m'>m} rho_{m',p} ]

    and the analogous tau rows with delta/K.  Release handled via bounds.
    The rows, their order and the HiGHS call are the reference's, so the
    solution is too.
    """
    M, N = instance.num_coflows, instance.num_ports
    K = instance.num_cores
    R = instance.aggregate_rate
    delta = instance.delta
    rho, tau = coflow.port_stats(instance.demands)
    tau = tau.astype(np.float64)
    ia, ib, P = _pair_index(M)
    # Dense pair-id lookup (M, M) for the strict upper triangle.
    pair_id = np.full((M, M), -1, dtype=np.int64)
    pair_id[ia, ib] = np.arange(P)

    rows, cols, vals, rhs = [], [], [], []

    def add_block(stats: np.ndarray, coef: float) -> None:
        """Append M*2N constraint rows (one per coflow m and port p)."""
        for m in range(M):
            # y columns: pairs (m', m) with m' < m get +coef*stats[m',p];
            # pairs (m, m') with m' > m get -coef*stats[m',p].
            lower = np.arange(0, m)
            upper = np.arange(m + 1, M)
            for p in range(2 * N):
                r = len(rhs)
                rows.append(r)
                cols.append(m)
                vals.append(-1.0)
                base = stats[m, p] + stats[upper, p].sum() if upper.size else stats[m, p]
                rhs.append(-coef * base)
                for others, pid, sign in (
                    (lower, pair_id[lower, m], 1.0),
                    (upper, pair_id[m, upper], -1.0),
                ):
                    if not others.size:
                        continue
                    nz = stats[others, p] != 0
                    if nz.any():
                        rows.extend([r] * int(nz.sum()))
                        cols.extend((M + pid[nz]).tolist())
                        vals.extend((sign * coef * stats[others[nz], p]).tolist())

    add_block(rho, 1.0 / R)
    if delta > 0:
        add_block(tau, delta / K)

    A = sp.csr_matrix(
        (np.asarray(vals), (np.asarray(rows), np.asarray(cols))),
        shape=(len(rhs), M + P),
    )
    c = np.concatenate([instance.weights, np.zeros(P)])
    bounds = [(float(a), None) for a in instance.releases] + [(0.0, 1.0)] * P
    res = linprog(c, A_ub=A, b_ub=np.asarray(rhs), bounds=bounds, method="highs")
    if not res.success:
        raise RuntimeError(f"ordering LP failed: {res.message}")
    T = res.x[:M]
    y = res.x[M:]
    x = np.zeros((M, M))
    x[ia, ib] = y
    x[ib, ia] = 1.0 - y
    return LPSolution(
        completion=T,
        precedence=x,
        objective=float(res.fun),
        method="exact",
        iterations=int(res.nit) if res.nit is not None else 0,
    )


# ---------------------------------------------------------------------------
# Packing
# ---------------------------------------------------------------------------


def instance_port_stats(
    instances: Sequence[CoflowInstance], device: torch.device
) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """Per-instance ``(rho (M, 2N) f64, tau (M, 2N) int32)`` on ``device``.

    One `port_stats` launch per distinct port count, which takes any N (up
    to the kernel's `MAX_PORTS`): matrices of one N are stacked unpadded
    (zero padding would change NumPy's pairwise summation order, and with
    it the last bits of rho).
    """
    out: list = [None] * len(instances)
    by_n: dict[int, list[int]] = {}
    for b, inst in enumerate(instances):
        by_n.setdefault(inst.num_ports, []).append(b)
    for n, idx in by_n.items():
        demands = torch.from_numpy(
            np.concatenate([instances[b].demands for b in idx])
        ).to(device)
        rho, tau = port_stats(demands)
        start = 0
        for b in idx:
            M = instances[b].num_coflows
            out[b] = (rho[start:start + M], tau[start:start + M])
            start += M
    return out


def global_lower_bound(
    instance: CoflowInstance, rho: torch.Tensor
) -> torch.Tensor:
    """delta + rho_m / R per coflow, f64 -- `CoflowInstance.global_lower_bound`
    from device port stats, with the same f64 operations.  R is a tensor on
    ``rho``'s device: CUDA's division by a Python scalar multiplies by its
    rounded reciprocal, and WSPT's order reads these bits."""
    if rho.shape[0] == 0:
        return rho.new_zeros(0)
    return instance.delta + rho.amax(dim=1) / rho.new_tensor(instance.aggregate_rate)


def warm_start_Y0_dense(
    weights: torch.Tensor,
    glb: torch.Tensor,
    warm_start_order: np.ndarray | torch.Tensor | None = None,
) -> torch.Tensor:
    """Strict-upper-triangular f32 warm start from per-coflow tensors, on
    their device (`repro.core.lp.warm_start_Y0_dense`).

    The order defaults to the weighted global lower-bound order
    (WSPT-like); Y0[a, b] = 1 iff a precedes b, kept only for a < b.  The
    streaming service builds each epoch's warm start from its resident
    per-slot vectors with it, and `pack_lp_arrays` from each instance's.
    """
    M = weights.shape[0]
    if warm_start_order is None:
        score = weights / torch.clamp(glb, min=1e-12)
        warm_start_order = torch.argsort(-score, stable=True)
    order = torch.as_tensor(warm_start_order, dtype=torch.int64, device=weights.device)
    pos = torch.empty(M, dtype=torch.int64, device=weights.device)
    pos[order] = torch.arange(M, device=weights.device)
    return torch.triu((pos[:, None] < pos[None, :]).to(torch.float32), 1)


def _pack(
    instances: Sequence[CoflowInstance],
    stats: Sequence[tuple[torch.Tensor, torch.Tensor]],
    glbs: Sequence[torch.Tensor],
    pad_coflows: int | None,
    pad_ports: int | None,
    device: torch.device,
    warm_start_orders: Sequence[np.ndarray | None] | None = None,
) -> dict[str, torch.Tensor]:
    B = len(instances)
    if warm_start_orders is None:
        warm_start_orders = [None] * B
    Ms = [inst.num_coflows for inst in instances]
    Ps = [2 * inst.num_ports for inst in instances]
    Mp = pad_coflows if pad_coflows is not None else max(Ms, default=0)
    Pp = pad_ports if pad_ports is not None else max(Ps, default=0)
    if B and (Mp < max(Ms) or Pp < max(Ps)):
        raise ValueError(
            f"bucket shape ({Mp}, {Pp}) too small for ensemble maxima "
            f"({max(Ms)}, {max(Ps)})"
        )

    f32 = dict(dtype=torch.float32, device=device)
    Y0 = torch.zeros((B, Mp, Mp), **f32)
    p_rho = torch.zeros((B, Mp, Pp), **f32)
    p_tau = torch.zeros((B, Mp, Pp), **f32)
    weights = np.zeros((B, Mp), dtype=np.float32)
    releases = np.zeros((B, Mp), dtype=np.float32)
    inv_R = np.zeros(B, dtype=np.float32)
    delta_over_K = np.zeros(B, dtype=np.float32)
    coflow_mask = np.zeros((B, Mp), dtype=bool)
    port_mask = np.zeros((B, Pp), dtype=bool)
    for b, inst in enumerate(instances):
        M, P = Ms[b], Ps[b]
        rho, tau = stats[b]
        p_rho[b, :M, :P] = rho.to(torch.float32)
        p_tau[b, :M, :P] = tau.to(torch.float32)
        weights[b, :M] = inst.weights
        releases[b, :M] = inst.releases
        inv_R[b] = 1.0 / inst.aggregate_rate
        delta_over_K[b] = inst.delta / inst.num_cores
        coflow_mask[b, :M] = True
        port_mask[b, :P] = True
        w64 = torch.from_numpy(inst.weights).to(device)
        Y0[b, :M, :M] = warm_start_Y0_dense(w64, glbs[b], warm_start_orders[b])
    host = dict(
        weights=weights, releases=releases, inv_R=inv_R,
        delta_over_K=delta_over_K, coflow_mask=coflow_mask,
        port_mask=port_mask,
    )
    out = dict(Y0=Y0, p_rho=p_rho, p_tau=p_tau)
    out.update({k: torch.from_numpy(v).to(device) for k, v in host.items()})
    return out


def pack_lp_arrays(
    instances: Sequence[CoflowInstance],
    pad_coflows: int | None = None,
    pad_ports: int | None = None,
    warm_start_orders: Sequence[np.ndarray | None] | None = None,
    device: str | torch.device = "cuda",
) -> dict[str, torch.Tensor]:
    """Pad an ensemble into the batched LP solver's input tensors.

    Same dict, layout and values as `repro.core.lp.pack_lp_arrays`, as
    tensors on ``device``; the port statistics come from the `port_stats`
    kernel.  ``pad_*`` default to the ensemble maxima;
    ``warm_start_orders`` gives a member's warm start from a priority
    order in place of the weighted lower-bound order.
    """
    device = resolve_device(device)
    instances = list(instances)
    stats = instance_port_stats(instances, device)
    glbs = [global_lower_bound(i, s[0]) for i, s in zip(instances, stats)]
    return _pack(
        instances, stats, glbs, pad_coflows, pad_ports, device, warm_start_orders
    )


# ---------------------------------------------------------------------------
# Projected-subgradient solvers
# ---------------------------------------------------------------------------


def _precedence_X(
    Y: torch.Tensor, coflow_mask: torch.Tensor | None = None
) -> torch.Tensor:
    """X~ (..., M, M): X[a, b] = Y[a, b] (a < b), 1 - Y[b, a] (a > b), diag
    1 (folding the coflow's own stats into the product); with a
    ``coflow_mask`` (..., M), padded coflow rows and columns zeroed."""
    M = Y.shape[-1]
    ones = torch.ones((M, M), dtype=torch.bool, device=Y.device)
    iu = torch.triu(ones, 1)
    il = torch.tril(ones, -1)
    X = torch.where(iu, Y, 0.0) + torch.where(il, 1.0 - Y.transpose(-1, -2), 0.0)
    X = X + torch.eye(M, dtype=Y.dtype, device=Y.device)
    if coflow_mask is None:
        return X
    cm = coflow_mask.to(Y.dtype)
    return X * (cm[..., :, None] * cm[..., None, :])


def _completion_from_Y(
    Y: torch.Tensor,
    p_rho: torch.Tensor,
    p_tau: torch.Tensor,
    releases: torch.Tensor,
    inv_R,
    delta_over_K,
    coflow_mask: torch.Tensor | None = None,
    port_mask: torch.Tensor | None = None,
    temp: torch.Tensor | None = None,
) -> torch.Tensor:
    """T_m(Y) -- optimal completion values for fixed precedences.

    One instance: Y (M, M), float scales, no masks -> (M,).  A padded
    bucket: Y (B, Mp, Mp), per-member scales (B,) and the coflow and port
    masks -> (B, Mp).

    Hard (``temp=None``): the scaled row maxima of the `lp_terms` kernel
    (one instance) or the `lp_terms_batch` kernel (a bucket), then a max
    with the releases -- the reference's max over [load, rec, release]
    (padded ports hold zeros, real loads are >= 0).  Smooth: the
    temperature-scaled logsumexp over the same columns, padded ports masked
    to -inf, through a matrix product so autograd differentiates it.
    """
    batched = Y.dim() == 3
    X = _precedence_X(Y, coflow_mask)
    if temp is None:
        kernel = lp_terms_batch if batched else lp_terms
        load, rec = kernel(X, p_rho, p_tau, inv_R, delta_over_K)
        return torch.maximum(torch.maximum(load, rec), releases)
    t = temp
    if batched:
        inv_R, delta_over_K = inv_R[:, None, None], delta_over_K[:, None, None]
        t = temp[:, None, None]
    Xt = X.transpose(-1, -2)
    load = (Xt @ p_rho) * inv_R
    rec = (Xt @ p_tau) * delta_over_K
    z = torch.cat([load, rec, releases[..., None]], dim=-1) / t
    if port_mask is not None:
        col_mask = torch.cat(
            [port_mask, port_mask, torch.ones_like(port_mask[:, :1])], dim=1
        )
        z = torch.where(col_mask[:, None, :], z, -math.inf)
    return temp[..., None] * torch.logsumexp(z, dim=-1)


def _adam_step(Y, m, v, g, t: int, lr: float):
    """One projected Adam step of the reference's update."""
    m = 0.9 * m + 0.1 * g
    v = 0.999 * v + 0.001 * g * g
    mh = m / (1.0 - 0.9 ** (t + 1.0))
    vh = v / (1.0 - 0.999 ** (t + 1.0))
    return torch.clamp(Y - lr * mh / (torch.sqrt(vh) + 1e-8), 0.0, 1.0), m, v


def _subgradient_run(
    Y0: torch.Tensor,
    weights: torch.Tensor,
    completion: Callable[..., torch.Tensor],
    *,
    iters: int,
    lr: float = 0.05,
):
    """Projected Adam on the temperature-annealed smoothed objective.

    ``completion(Y, temp=None)`` is `_completion_from_Y` bound to one
    instance's or one bucket's statics; ``weights`` has Y0's leading axes
    and its last axis.  Instances of a bucket are independent, so the
    gradient of the summed smooth objective is the stack of per-instance
    gradients, and Adam is elementwise: the bucket advances in lockstep.
    The smoothing temperature decays geometrically from about the scale of
    the objective spread to about 0; the best-so-far point is tracked under
    the true piecewise-linear objective (one hard-terms kernel launch per
    step, plus one for the start and one for the returned T), so the result
    is never worse than the warm start.
    """
    T0 = completion(Y0)
    temp0 = torch.clamp(T0.amax(dim=-1) * 0.05, min=1e-3)
    Y = Y0
    m = torch.zeros_like(Y0)
    v = torch.zeros_like(Y0)
    best_Y = Y0
    best_F = (weights * T0).sum(dim=-1)
    for t in range(iters):
        temp = temp0 * math.exp(-4.0 * t / iters) + 1e-3
        with torch.enable_grad():
            Yg = Y.detach().requires_grad_(True)
            smooth = completion(Yg, temp=temp)
            (g,) = torch.autograd.grad((weights * smooth).sum(), Yg)
        Y, m, v = _adam_step(Y, m, v, g, t, lr)
        F = (weights * completion(Y)).sum(dim=-1)
        better = F < best_F
        best_Y = torch.where(better[..., None, None], Y, best_Y)
        best_F = torch.where(better, F, best_F)
    return best_Y, completion(best_Y), best_F


def solve_subgradient(
    instance: CoflowInstance,
    iters: int = 3000,
    warm_start_order: np.ndarray | None = None,
    device: str | torch.device = "cuda",
) -> LPSolution:
    """Projected-subgradient solve of one instance's ordering LP on
    ``device``, from the warm start of ``warm_start_order`` (default: the
    weighted lower-bound order).

    Returns a feasible solution (Y in the box, pair equalities by
    construction): its objective upper-bounds the LP optimum, within about
    1 % of HiGHS in practice.
    """
    device = resolve_device(device)
    # The smooth gradient's products must be full f32, as in the reference.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ((rho, tau),) = instance_port_stats([instance], device)
    weights = torch.from_numpy(instance.weights).to(device)
    Y0 = warm_start_Y0_dense(
        weights, global_lower_bound(instance, rho), warm_start_order
    )
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)  # noqa: E731
    completion = functools.partial(
        _completion_from_Y, p_rho=rho.to(torch.float32),
        p_tau=tau.to(torch.float32), releases=f32(instance.releases),
        inv_R=float(1.0 / instance.aggregate_rate),
        delta_over_K=float(instance.delta / instance.num_cores),
    )
    best_Y, T_best, best_F = _subgradient_run(
        Y0, f32(weights), completion, iters=iters
    )
    return LPSolution(
        completion=T_best.cpu().numpy().astype(np.float64),
        precedence=_precedence_from_Y(best_Y.cpu().numpy().astype(np.float64)),
        objective=float(best_F),
        method="subgradient",
        iterations=iters,
    )


def solve_subgradient_batch_arrays(
    arrays: dict[str, torch.Tensor],
    iters: int = 3000,
) -> LPSolutionBatch:
    """Array-in/array-out ensemble LP solve on the arrays' device.

    ``arrays`` is the `pack_lp_arrays` dict.  Returns the padded
    `LPSolutionBatch` -- nothing is unpadded here.
    """
    # The smooth gradient's products must be full f32, as in the reference.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ins = [arrays[k] for k in LP_ARRAY_NAMES]
    B, Mp = ins[0].shape[:2]
    if B == 0 or Mp == 0:
        # Degenerate bucket: nothing to iterate on.
        zeros = lambda *s: torch.zeros(s, device=ins[0].device)  # noqa: E731
        return LPSolutionBatch(
            completion=zeros(B, Mp), y=zeros(B, Mp, Mp), objective=zeros(B),
            method="subgradient_batch", iterations=iters,
        )
    Y0, p_rho, p_tau, weights, releases, inv_R, delta_over_K, cm, pm = ins
    completion = functools.partial(
        _completion_from_Y, p_rho=p_rho, p_tau=p_tau, releases=releases,
        inv_R=inv_R, delta_over_K=delta_over_K, coflow_mask=cm, port_mask=pm,
    )
    best_Y, T_best, best_F = _subgradient_run(
        Y0, weights, completion, iters=iters
    )
    return LPSolutionBatch(
        completion=T_best, y=best_Y, objective=best_F,
        method="subgradient_batch", iterations=iters,
    )


def solve_subgradient_batch(
    instances: Sequence[CoflowInstance],
    iters: int = 3000,
    device: str | torch.device = "cuda",
) -> list[LPSolution]:
    """Solve the ordering LP for a whole ensemble in one batched loop.

    List-in/list-out wrapper over `pack_lp_arrays` ->
    `solve_subgradient_batch_arrays` -> `LPSolutionBatch.unpack`.
    """
    instances = list(instances)
    if not instances:
        return []
    arrays = pack_lp_arrays(instances, device=device)
    batch = solve_subgradient_batch_arrays(arrays, iters=iters)
    return batch.unpack([inst.num_coflows for inst in instances])


# ---------------------------------------------------------------------------
# Resident warm state (streaming epochs)
# ---------------------------------------------------------------------------
#
# The streaming service keeps one (S, S) precedence matrix on the device for
# the life of a stream; each epoch gathers the active slots' pairwise
# precedences into its dense warm start and scatters the solved pairs back.
# Slot vectors are padded to S with the out-of-range index S, which the
# reference reads as "fill" and writes as "drop".  PyTorch has neither mode,
# and an out-of-range CUDA gather is a device-side assert, so these clip the
# index before every gather and mask what it read, and scatter through a
# sentinel row and column that are then cut away.


def warm_gather_device(
    Yw: torch.Tensor, solved: torch.Tensor, slots: torch.Tensor, default_Y0: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Warm-start gather: overwrite solved pairs of the dense Y0.

    ``Yw`` (S, S) f32 and ``solved`` (S,) bool are the resident warm state;
    ``slots`` (D,) maps dense position d to its slot (S on padded
    positions, read as unsolved); ``default_Y0`` (D, D) f32 is the epoch's
    cold warm start.  Returns ``(Y0, any_warm)``: strict-upper Y0 with each
    pair solved before replaced by its last precedence, and whether any
    pair was (a bool tensor the host reads to pick the warm budget).
    """
    S = Yw.shape[0]
    inside = slots < S
    sc = torch.where(inside, slots, 0).long()
    prev = solved[sc] & inside
    both = prev[:, None] & prev[None, :]
    Ys = Yw[sc][:, sc]
    warm_pair = torch.triu(both, 1)
    Y0 = torch.where(warm_pair, Ys, default_Y0)
    return torch.triu(Y0, 1), warm_pair.any()


def warm_scatter_device(
    Yw: torch.Tensor, slots: torch.Tensor, y: torch.Tensor
) -> torch.Tensor:
    """Scatter an epoch's solved precedences back into the warm state.

    ``y`` (D, D) f32 is the batched solver's strict-upper solution for the
    dense epoch.  The full precedence matrix (x_ab + x_ba = 1, zero
    diagonal) is formed in f32 on the device and written at
    ``(slots[a], slots[b])``; padded positions (slot S) land in a sentinel
    row and column that are dropped.  Returns the updated (S, S) matrix.
    """
    S = Yw.shape[0]
    u = torch.triu(y, 1)
    full = u + torch.tril(1.0 - u.T, -1)
    sc = torch.clamp(slots.long(), max=S)
    out = torch.zeros((S + 1, S + 1), dtype=Yw.dtype, device=Yw.device)
    out[:S, :S] = Yw
    out[sc[:, None], sc[None, :]] = full
    return out[:S, :S].clone()
