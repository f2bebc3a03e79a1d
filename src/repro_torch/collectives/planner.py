"""Coflow-aware collective planner: the paper's Algorithm 1 applied to
multi-pod training traffic over parallel OCS planes.

Port of `repro.collectives.planner`.  A training step's inter-pod traffic
maps onto the paper's abstractions:

  ports   = pods -- each pod's uplink set per OCS plane;
  coflow  = one gradient bucket's inter-pod exchange.  A ring
            reduce-scatter + all-gather over P pods is a circulant demand
            matrix: each pod sends 2(P-1)/P of the bucket to its ring
            neighbour.  Expert-parallel all-to-alls are dense matrices;
  weight  = bucket criticality (deeper layers' buckets weigh more);
  release = when the bucket's gradient is ready in the backward pass;
  K cores = OCS planes with per-plane bandwidth r^k;
  delta   = OCS retarget latency (~1 ms).

`plan` runs Algorithm 1 through the port's pipeline (``ours``, on the
card unless ``device="cpu"``) and a FIFO + load-only baseline on the host,
and returns the better as a `CollectivePlan`: bucket issue order, plane
and establish time of every flow, and both simulated completion times.
PyTorch cannot steer physical OCS planes either, so plane assignment and
timing are exported and simulated; the order is what a trainer can act on.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import tree
from repro_torch.core import lp as lp_mod
from repro_torch.core.allocation import allocate
from repro_torch.core.coflow import CoflowInstance
from repro_torch.core.scheduler import _schedule_all_cores
from repro_torch.core.validate import ccts_from_schedules
from repro_torch.device import resolve_device
from repro_torch.pipeline import get_pipeline

__all__ = ["GradientBucket", "CollectivePlan", "buckets_from_params", "plan"]


@dataclasses.dataclass
class GradientBucket:
    name: str
    bytes: int
    layer_frac: float  # 0 = first layer, 1 = last (release ordering)


@dataclasses.dataclass
class CollectivePlan:
    order: list[str]  # bucket names, issue order (of the chosen plan)
    plane_of_flow: dict[str, list[tuple[int, int, int, float]]]
    # bucket -> [(src_pod, dst_pod, plane, establish_time)]
    cct_ours: float  # simulated completion (last bucket) -- Algorithm 1
    cct_fifo: float  # FIFO + load-only baseline
    total_weighted_ours: float
    total_weighted_fifo: float
    instance: CoflowInstance
    chosen: str = "ours"  # which plan the planner selected

    @property
    def speedup(self) -> float:
        return self.cct_fifo / max(self.cct_ours, 1e-30)

    @property
    def chosen_weighted(self) -> float:
        return min(self.total_weighted_ours, self.total_weighted_fifo)


def _numel(leaf) -> int:
    """Elements of a tensor (any device, ``meta`` included) or an array."""
    return int(leaf.numel()) if isinstance(leaf, torch.Tensor) else int(np.size(leaf))


def buckets_from_params(
    params_shapes, bucket_bytes: int = 64 << 20, dtype_bytes: int = 2
) -> list[GradientBucket]:
    """Greedy-pack parameter leaves (in tree order, about layer order) into
    fixed-size gradient buckets.  The tree flattens as `repro_torch.tree`
    does (dict values in sorted key order, list items in order)."""
    leaves = tree.leaves(params_shapes)
    out: list[GradientBucket] = []
    cur = 0
    idx = 0
    n = len(leaves)
    for i, leaf in enumerate(leaves):
        cur += _numel(leaf) * dtype_bytes
        if cur >= bucket_bytes or i == n - 1:
            out.append(
                GradientBucket(name=f"bucket{idx}", bytes=cur, layer_frac=i / max(n - 1, 1))
            )
            cur = 0
            idx += 1
    return out


def _ring_demand(num_pods: int, nbytes: float) -> np.ndarray:
    """Ring reduce-scatter + all-gather demand matrix (bytes pod -> pod)."""
    d = np.zeros((num_pods, num_pods))
    per_hop = 2.0 * (num_pods - 1) / num_pods * nbytes / max(num_pods - 1, 1)
    for p in range(num_pods):
        d[p, (p + 1) % num_pods] = per_hop * (num_pods - 1)
    return d


def _a2a_demand(num_pods: int, nbytes: float) -> np.ndarray:
    d = np.full((num_pods, num_pods), nbytes / max(num_pods, 1) ** 2)
    np.fill_diagonal(d, 0.0)
    return d


def plan(
    buckets: list[GradientBucket],
    num_pods: int = 2,
    plane_rates_gbps: tuple[float, ...] = (50.0, 50.0, 50.0, 50.0),
    delta_ms: float = 1.0,
    backward_ms: float = 100.0,
    a2a_buckets: list[GradientBucket] | None = None,
    lp_method: str = "exact",
    refine=None,
    device: str | torch.device = "cuda",
) -> CollectivePlan:
    """Run Algorithm 1 over the step's inter-pod coflows on ``device``.

    Units: time in ms, sizes in MB, rates in GB/s (1 GB/s = 1 MB/ms).
    Weights encode optimizer criticality: deeper buckets weigh more.  The
    LP is HiGHS on the host (``lp_method="exact"``) or the subgradient
    solver on ``device``; ``ours`` runs as a one-member `run_batch`, so
    ``refine`` (a `RefineSpec` / ``True`` / field dict) takes the batched
    candidate search, which only accepts improving orders.  The FIFO +
    load-only baseline runs on the host; the planner ships the better plan
    (taking the min keeps the (8K+1) guarantee of Algorithm 1's).
    """
    device = resolve_device(device)
    demands, weights, releases, names = [], [], [], []
    for b in buckets:
        demands.append(_ring_demand(num_pods, b.bytes / 1e6))
        # Deeper layers' gradients arrive first in backward and unblock the
        # optimizer earliest: weight by (1 - layer_frac) + epsilon.
        weights.append(1.0 + 4.0 * (1.0 - b.layer_frac))
        releases.append(backward_ms * (1.0 - b.layer_frac))
        names.append(b.name)
    for b in a2a_buckets or []:
        demands.append(_a2a_demand(num_pods, b.bytes / 1e6))
        weights.append(5.0)  # blocking the forward: maximal criticality
        releases.append(backward_ms * b.layer_frac)
        names.append(b.name)

    inst = CoflowInstance(
        demands=np.stack(demands),
        weights=np.asarray(weights),
        releases=np.asarray(releases),
        rates=np.asarray(plane_rates_gbps),  # GB/s == MB/ms
        delta=delta_ms,
    )
    lp_sol = (
        lp_mod.solve_exact(inst)
        if lp_method == "exact"
        else lp_mod.solve_subgradient(inst, device=device)
    )
    ours = get_pipeline("ours").run_batch(
        [inst], lp_solutions=[lp_sol], refine=refine, device=device
    )[0]

    # FIFO + load-only baseline: release order, tau-blind allocation.  Step
    # coflows can be arrival-dominated (a few ms of service against a
    # ~100 ms backward), where release-order FIFO beats any release-blind
    # priority order, so both are simulated and the better one ships.
    fifo_order = np.argsort(inst.releases, kind="stable")
    alloc_f = allocate(inst, fifo_order, include_tau=False)
    scheds_f = _schedule_all_cores(inst, alloc_f, fifo_order)
    ccts_f = ccts_from_schedules(inst.num_coflows, scheds_f)
    w_ours = float(ours.total_weighted_cct)
    w_fifo = float(np.dot(inst.weights, ccts_f))

    chosen = "ours" if w_ours <= w_fifo else "fifo"
    sched_src = ours.core_schedules if chosen == "ours" else scheds_f
    order_src = ours.order if chosen == "ours" else fifo_order
    plane_of_flow: dict[str, list] = {n: [] for n in names}
    for k, cs in enumerate(sched_src):
        for m, i, j, t in zip(cs.coflow, cs.src, cs.dst, cs.establish):
            plane_of_flow[names[int(m)]].append((int(i), int(j), k, float(t)))

    return CollectivePlan(
        order=[names[m] for m in order_src],
        plane_of_flow=plane_of_flow,
        cct_ours=float(ours.ccts.max()),
        cct_fifo=float(ccts_f.max()),
        total_weighted_ours=w_ours,
        total_weighted_fifo=w_fifo,
        instance=inst,
        chosen=chosen,
    )
