"""Ensemble-batched inter-core allocation (Algorithm 1 Lines 3-15).

Port of `repro.pipeline.batch_alloc.allocate_batch_arrays`.  The ordered
flow sequence is one stable gather of the batch's canonical flow table;
then every member's (rho, tau, lb) state advances through one device loop
over the flow axis, batched over members, in f64.  Each flow places itself
on the core minimizing the post-placement prefix lower bound

    cand_k = max(lb_k, L(k, i), L(k, N + j)),
    L(k, p) = (rho_{k,p} + d) * inv_rate_k + (tau_{k,p} + 1) * delta

with exactly the NumPy oracle's (`repro.core.allocation.allocate`)
expressions and order of operations.  Every PyTorch op rounds on its own,
so nothing is contracted into an FMA, and core choices, prefix port stats
and prefix lower bounds are bit-identical to the oracle.  (The JAX package
needed a runtime 1.0 factor to stop XLA:CPU from contracting; eager ops
need none, and this module uses no ``addcmul`` or ``torch.compile``.)

Padding mirrors the reference: padded flow steps add 0 and keep ``lb``;
padded cores start at `PAD_LB` with a `PAD_LB` inverse rate, so the argmin
never picks them.  The order's permutation sends invalid flows to the tail,
so the loop stops after the longest member's valid flows: the steps it
skips would be no-ops, and only their ``core`` entries (never read) stay 0.
That matters where most of the flow axis is free capacity (the streaming
service's slot arena); an ensemble built to its maxima has a member that
fills the axis, so its loop is unchanged.  The loop costs a few launches
per flow; a kernel for this scan has no Pallas counterpart and is later
work.

Under a sharded batch (``ensemble.sharding``) the orders are placed with
the batch's sharding and each shard's scan runs on its device, the
shards' flow steps issued in turns (`repro_torch.launch.mesh.drive`); the
results are gathered on the batch's device.  A shard's loop stops after
its own longest member, which changes only the never-read ``core``
entries of invalid flows.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.core.allocation import Allocation
from repro_torch.core.coflow import CoflowInstance
from repro_torch.launch.mesh import Sharded, drive, place
from repro_torch.pipeline.ensemble_batch import (
    PAD_LB, AllocationBatch, EnsembleBatch, build_ensemble_batch,
)

__all__ = ["allocate_batch_arrays", "allocate_batch"]


def allocate_batch(
    instances: Sequence[CoflowInstance],
    orders: Sequence[np.ndarray],
    include_tau: bool = True,
    device: str | torch.device = "cuda",
) -> list[Allocation]:
    """Greedy allocation for a whole ensemble (the reference's list-in,
    list-out wrapper): one `build_ensemble_batch` on ``device`` without
    the LP arrays, `allocate_batch_arrays`, then
    `AllocationBatch.materialize`.  Bit-identical to ``[allocate(inst,
    order, include_tau) for ...]``; instances may differ in every
    dimension."""
    instances = list(instances)
    if len(instances) != len(orders):
        raise ValueError("instances/orders length mismatch")
    if not instances:
        return []
    ensemble = build_ensemble_batch(instances, device, with_lp_arrays=False)
    batch = allocate_batch_arrays(ensemble, ensemble.pad_orders(orders),
                                  include_tau=include_tau)
    return batch.materialize(ensemble)


def allocate_batch_arrays(
    ensemble: EnsembleBatch,
    orders: torch.Tensor,
    include_tau: bool = True,
) -> AllocationBatch:
    """Greedy allocation of a whole `EnsembleBatch` along (Bp, Mp) orders,
    each shard on its device under the batch's sharding."""
    if ensemble.sharding is None:
        return drive([_allocate_steps(ensemble, orders, include_tau)])[0]
    parts = ensemble.shards()
    placed = place(orders, ensemble.sharding)
    order_parts = placed.shards if isinstance(placed, Sharded) else (placed,)
    results = drive([
        _allocate_steps(p, o, include_tau) for p, o in zip(parts, order_parts)
    ])
    return AllocationBatch.concat(results, ensemble.device)


def _allocate_steps(ensemble: EnsembleBatch, orders: torch.Tensor, include_tau: bool):
    """The scan as a generator: one yield a flow step, the
    `AllocationBatch` its return value."""
    B, Fp = ensemble.flow_size.shape
    dev = ensemble.device
    perm = ensemble.permute_flows(orders)

    def take(a):
        return torch.gather(a, 1, perm)

    coflow = take(ensemble.flow_coflow)
    src = take(ensemble.flow_src)
    dst = take(ensemble.flow_dst)
    size = take(ensemble.flow_size)
    pi = take(ensemble.flow_pi)
    pj = take(ensemble.flow_pj)
    valid = take(ensemble.flow_valid)
    ends = ensemble.prefix_ends(orders)

    Kp, Pp = ensemble.pad_cores, ensemble.pad_flat_ports
    delta = ensemble.delta if include_tau else torch.zeros_like(ensemble.delta)
    delta = delta[:, None]
    inv_rates = ensemble.inv_rates
    core_mask = ensemble.core_mask
    rho = torch.zeros((B, Kp, Pp), dtype=torch.float64, device=dev)
    tau = torch.zeros((B, Kp, Pp), dtype=torch.float64, device=dev)
    lb = torch.full((B, Kp), PAD_LB, dtype=torch.float64, device=dev)
    lb = lb.masked_fill(core_mask, 0.0)
    core = torch.zeros((B, Fp), dtype=torch.int64, device=dev)
    lbs = torch.zeros((B, Fp), dtype=torch.float64, device=dev)
    rows = torch.arange(B, device=dev)
    live = int(valid.sum(dim=1).max()) if B and Fp else 0
    for f in range(live):
        i = pi[:, f, None, None].expand(B, Kp, 1)
        j = pj[:, f, None, None].expand(B, Kp, 1)
        dd = size[:, f, None]
        v = valid[:, f]
        # Candidate LB on every core if this flow lands there -- the
        # oracle's expressions, one rounding per op.
        li = (torch.gather(rho, 2, i)[..., 0] + dd) * inv_rates + (
            torch.gather(tau, 2, i)[..., 0] + 1.0
        ) * delta
        lj = (torch.gather(rho, 2, j)[..., 0] + dd) * inv_rates + (
            torch.gather(tau, 2, j)[..., 0] + 1.0
        ) * delta
        cand = torch.maximum(lb, torch.maximum(li, lj))
        k = torch.argmin(cand, dim=1)
        dv = torch.where(v, size[:, f], 0.0)
        ov = v.to(torch.float64)
        ii, jj = pi[:, f], pj[:, f]
        rho[rows, k, ii] += dv
        rho[rows, k, jj] += dv
        tau[rows, k, ii] += ov
        tau[rows, k, jj] += ov
        lb[rows, k] = torch.where(v, cand[rows, k], lb[rows, k])
        core[:, f] = k
        lbs[:, f] = torch.where(core_mask, lb, -torch.inf).amax(dim=1)
        yield

    # lb starts at zero, so before any flow lands the prefix LB is 0.
    if Fp:
        prefix_lb = torch.where(
            ends > 0, torch.gather(lbs, 1, torch.clamp(ends - 1, min=0)), 0.0
        )
    else:
        prefix_lb = torch.zeros(ends.shape, dtype=torch.float64, device=dev)
    return AllocationBatch(
        order=orders, perm=perm, coflow=coflow, src=src, dst=dst, size=size,
        valid=valid, core=core, rho_ports=rho, tau_ports=tau,
        prefix_lb=prefix_lb, ends=ends,
    )
