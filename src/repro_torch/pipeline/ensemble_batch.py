"""The `EnsembleBatch`: one padded set of device tensors from LP to circuit.

Port of the offline part of `repro.pipeline.ensemble_batch`.  One
construction per ensemble, padded to its maxima, packs

  * the LP solver's padded arrays (`lp_*`, exactly the
    `repro_torch.core.lp.pack_lp_arrays` layout: f32 + masks), with the
    per-port statistics from the `port_stats` kernel on the device;
  * f64 per-coflow vectors (`weights`, `releases`, `glb`);
  * the canonical flow table (`flow_*`): every instance's nonzero flows in
    (coflow id ascending, largest-first within coflow) order, padded to a
    shared flow axis, f64 sizes -- order-independent, so applying a global
    coflow order is a stable permutation (`permute_flows`);
  * per-core arrays (`rates`, `inv_rates`, `core_mask`, `delta`) for the
    allocation scan and the calendar's durations.

Every field is a tensor on the batch's device; the member axis is the
instance list (no mesh padding in this port).  `expand_members` tiles it
for refinement's candidates.  The slot-pool batch of the streaming service
is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.core import lp as lp_mod
from repro_torch.core.allocation import Allocation
from repro_torch.core.coflow import CoflowInstance, flows_of
from repro_torch.device import resolve_device

__all__ = [
    "EnsembleBatch", "AllocationBatch", "build_ensemble_batch", "expansion_maps", "PAD_LB",
]

# Padded-core sentinel: dominates every real candidate bound but stays
# finite so padded-step arithmetic never produces inf * 0 = NaN.
PAD_LB = 1e30


@dataclasses.dataclass(frozen=True)
class EnsembleBatch:
    """One shape bucket of instances as padded device tensors.

    Array fields have a leading member axis of size ``num_instances``;
    the tuples record the true per-instance sizes used to unpad.
    """

    # --- LP arrays (f32 + masks; `pack_lp_arrays` layout) ----------------
    lp_Y0: torch.Tensor  # (B, Mp, Mp) f32 warm start
    lp_rho: torch.Tensor  # (B, Mp, Pp) f32
    lp_tau: torch.Tensor  # (B, Mp, Pp) f32
    lp_weights: torch.Tensor  # (B, Mp) f32
    lp_releases: torch.Tensor  # (B, Mp) f32
    inv_R: torch.Tensor  # (B,) f32
    delta_over_K: torch.Tensor  # (B,) f32
    coflow_mask: torch.Tensor  # (B, Mp) bool
    port_mask: torch.Tensor  # (B, Pp) bool
    # --- f64 per-coflow vectors ------------------------------------------
    weights: torch.Tensor  # (B, Mp) f64
    releases: torch.Tensor  # (B, Mp) f64
    glb: torch.Tensor  # (B, Mp) f64 -- delta + rho_m / R
    # --- canonical flow table (coflow asc, largest-first within) ---------
    flow_coflow: torch.Tensor  # (B, Fp) i64, 0 on padding
    flow_src: torch.Tensor  # (B, Fp) i64 raw ingress i
    flow_dst: torch.Tensor  # (B, Fp) i64 raw egress j
    flow_pi: torch.Tensor  # (B, Fp) i64 flat ingress port (= i)
    flow_pj: torch.Tensor  # (B, Fp) i64 flat egress port (= N + j)
    flow_size: torch.Tensor  # (B, Fp) f64
    flow_valid: torch.Tensor  # (B, Fp) bool
    flow_counts: torch.Tensor  # (B, Mp) i64 -- flows per coflow
    # --- per-core arrays -------------------------------------------------
    rates: torch.Tensor  # (B, Kp) f64, 1.0 on padding
    inv_rates: torch.Tensor  # (B, Kp) f64, PAD_LB on padding
    core_mask: torch.Tensor  # (B, Kp) bool
    delta: torch.Tensor  # (B,) f64
    # --- true sizes ------------------------------------------------------
    num_instances: int
    num_coflows: tuple
    num_ports: tuple
    num_cores: tuple
    num_flows: tuple

    @property
    def device(self) -> torch.device:
        return self.weights.device

    @property
    def pad_coflows(self) -> int:
        return int(self.weights.shape[1])

    @property
    def pad_flat_ports(self) -> int:
        return int(self.port_mask.shape[1])

    @property
    def pad_cores(self) -> int:
        return int(self.rates.shape[1])

    # -- LP ---------------------------------------------------------------
    def lp_arrays(self) -> dict[str, torch.Tensor]:
        """`solve_subgradient_batch_arrays` input dict (no copy)."""
        return dict(
            Y0=self.lp_Y0, p_rho=self.lp_rho, p_tau=self.lp_tau,
            weights=self.lp_weights, releases=self.lp_releases,
            inv_R=self.inv_R, delta_over_K=self.delta_over_K,
            coflow_mask=self.coflow_mask, port_mask=self.port_mask,
        )

    # -- ordering ---------------------------------------------------------
    def pad_orders(self, orders: Sequence[np.ndarray]) -> torch.Tensor:
        """(B, Mp) padded order tensor from per-instance permutations
        (padded coflow ids appended in id order)."""
        B, Mp = self.weights.shape
        out = np.tile(np.arange(Mp, dtype=np.int64), (B, 1))
        for b, o in enumerate(orders):
            out[b, : self.num_coflows[b]] = o
        return torch.from_numpy(out).to(self.device)

    # -- flows ------------------------------------------------------------
    def permute_flows(self, orders: torch.Tensor) -> torch.Tensor:
        """(B, Fp) stable flow permutation realizing a global coflow order:
        coflows along the order, largest-first within each coflow."""
        B, Mp = orders.shape
        pos = torch.empty_like(orders)
        pos.scatter_(
            1, orders,
            torch.arange(Mp, device=orders.device).expand(B, Mp).contiguous(),
        )
        key = torch.gather(pos, 1, self.flow_coflow)
        key = torch.where(self.flow_valid, key, Mp)
        return torch.argsort(key, dim=1, stable=True)

    def prefix_ends(self, orders: torch.Tensor) -> torch.Tensor:
        """(B, Mp) running flow count after each order position."""
        return torch.gather(self.flow_counts, 1, orders).cumsum(dim=1)

    # -- member expansion -------------------------------------------------
    def expand_members(
        self, reps: int
    ) -> tuple["EnsembleBatch", np.ndarray, np.ndarray]:
        """Tile every member ``reps`` times along the member axis.

        The expansion behind candidate-search refinement
        (`repro_torch.pipeline.refine`): expanded row ``b * reps + c`` is
        copy (candidate slot) ``c`` of instance ``b``, candidate-major
        within instance, so downstream stages see ``B * reps`` ordinary
        members.  One `index_select` per tensor field on the batch's
        device: a gather of this build, not a rebuild, so `port_stats`
        does not run again.  Returns ``(expanded, instance_of,
        candidate_of)``, the row maps of `expansion_maps`.
        """
        reps = int(reps)
        if reps < 1:
            raise ValueError(f"reps must be >= 1, got {reps}")
        B = self.num_instances
        idx = torch.arange(B, device=self.device).repeat_interleave(reps)

        def rep(t: tuple) -> tuple:
            return tuple(x for x in t for _ in range(reps))

        kw = {
            f.name: getattr(self, f.name).index_select(0, idx)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)
        }
        kw.update(
            num_instances=B * reps,
            num_coflows=rep(self.num_coflows),
            num_ports=rep(self.num_ports),
            num_cores=rep(self.num_cores),
            num_flows=rep(self.num_flows),
        )
        return EnsembleBatch(**kw), *expansion_maps(B, reps)


@dataclasses.dataclass(frozen=True)
class AllocationBatch:
    """Batched result of Algorithm 1 Lines 3-15 over one `EnsembleBatch`.

    The flow axis is in allocation order (global coflow order,
    largest-first within coflow), which is also the circuit stage's
    priority order.
    """

    order: torch.Tensor  # (B, Mp) i64 -- the global order used
    perm: torch.Tensor  # (B, Fp) i64 canonical -> ordered gather
    coflow: torch.Tensor  # (B, Fp) i64
    src: torch.Tensor  # (B, Fp) i64 raw ingress
    dst: torch.Tensor  # (B, Fp) i64 raw egress
    size: torch.Tensor  # (B, Fp) f64
    valid: torch.Tensor  # (B, Fp) bool
    core: torch.Tensor  # (B, Fp) i64 -- assigned core per flow
    rho_ports: torch.Tensor  # (B, Kp, Pp) f64 final prefix port loads
    tau_ports: torch.Tensor  # (B, Kp, Pp) f64 final prefix port counts
    prefix_lb: torch.Tensor  # (B, Mp) f64 per order position
    ends: torch.Tensor  # (B, Mp) i64 running flow count per order position

    def materialize(self, ensemble: EnsembleBatch) -> list[Allocation]:
        """Per-instance `Allocation`s on the host -- field for field what
        `repro.core.allocation.allocate` returns."""
        h = {
            f.name: getattr(self, f.name).cpu().numpy()
            for f in dataclasses.fields(self)
        }
        out = []
        for b in range(ensemble.num_instances):
            F = ensemble.num_flows[b]
            K = ensemble.num_cores[b]
            P = 2 * ensemble.num_ports[b]
            M = ensemble.num_coflows[b]
            out.append(
                Allocation(
                    coflow=h["coflow"][b, :F],
                    src=h["src"][b, :F],
                    dst=h["dst"][b, :F],
                    size=h["size"][b, :F],
                    core=h["core"][b, :F],
                    rho_ports=h["rho_ports"][b, :K, :P],
                    tau_ports=h["tau_ports"][b, :K, :P],
                    prefix_lb=h["prefix_lb"][b, :M],
                )
            )
        return out


def expansion_maps(num_instances: int, reps: int) -> tuple[np.ndarray, np.ndarray]:
    """Row maps of `EnsembleBatch.expand_members`'s layout: expanded row
    ``r`` holds candidate slot ``candidate_of[r]`` of instance
    ``instance_of[r]``, the inverse of ``r = instance * reps + candidate``."""
    instance_of = np.repeat(np.arange(num_instances, dtype=np.int64), reps)
    candidate_of = np.tile(np.arange(reps, dtype=np.int64), num_instances)
    return instance_of, candidate_of


def _canonical_flows(inst: CoflowInstance):
    """(coflow, src, dst, size) of one instance: coflow id ascending,
    largest-first within each coflow."""
    ms, is_, js, ds = [], [], [], []
    for m in range(inst.num_coflows):
        i_idx, j_idx, sizes = flows_of(inst.demands[m])
        ms.append(np.full(i_idx.shape[0], m, dtype=np.int64))
        is_.append(i_idx)
        js.append(j_idx)
        ds.append(sizes)

    def cat(parts, dt):
        return np.concatenate(parts).astype(dt) if parts else np.zeros(0, dtype=dt)

    return (
        cat(ms, np.int64), cat(is_, np.int64), cat(js, np.int64),
        cat(ds, np.float64),
    )


def build_ensemble_batch(
    instances: Sequence[CoflowInstance],
    device: str | torch.device = "cuda",
) -> EnsembleBatch:
    """Build the padded tensors of one ensemble -- once -- on ``device``,
    padded to the ensemble maxima."""
    device = resolve_device(device)
    instances = list(instances)
    B = len(instances)
    Ms = tuple(inst.num_coflows for inst in instances)
    Ns = tuple(inst.num_ports for inst in instances)
    Ks = tuple(inst.num_cores for inst in instances)
    Mp = max(Ms, default=0)
    Kp = max(max(Ks, default=1), 1)

    # Per-port statistics on the device (the port_stats kernel): the LP
    # arrays and the f64 global lower bounds both read them.
    stats = lp_mod.instance_port_stats(instances, device)
    glbs = [lp_mod.global_lower_bound(i, s[0]) for i, s in zip(instances, stats)]
    lp_arr = lp_mod._pack(instances, stats, glbs, None, None, device)

    seqs = [_canonical_flows(inst) for inst in instances]
    Fs = tuple(s[0].shape[0] for s in seqs)
    Fp = max(Fs, default=0)

    weights = np.zeros((B, Mp))
    releases = np.zeros((B, Mp))
    glb = torch.zeros((B, Mp), dtype=torch.float64, device=device)
    flow_coflow = np.zeros((B, Fp), dtype=np.int64)
    flow_src = np.zeros((B, Fp), dtype=np.int64)
    flow_dst = np.zeros((B, Fp), dtype=np.int64)
    flow_pi = np.zeros((B, Fp), dtype=np.int64)
    flow_pj = np.zeros((B, Fp), dtype=np.int64)
    flow_size = np.zeros((B, Fp))
    flow_valid = np.zeros((B, Fp), dtype=bool)
    flow_counts = np.zeros((B, Mp), dtype=np.int64)
    rates = np.ones((B, Kp))
    inv_rates = np.full((B, Kp), PAD_LB)
    core_mask = np.zeros((B, Kp), dtype=bool)
    delta = np.zeros(B)
    for b, inst in enumerate(instances):
        M, N, K, F = Ms[b], Ns[b], Ks[b], Fs[b]
        weights[b, :M] = inst.weights
        releases[b, :M] = inst.releases
        glb[b, :M] = glbs[b]
        ms, i_idx, j_idx, sizes = seqs[b]
        flow_coflow[b, :F] = ms
        flow_src[b, :F] = i_idx
        flow_dst[b, :F] = j_idx
        flow_pi[b, :F] = i_idx
        flow_pj[b, :F] = N + j_idx
        flow_size[b, :F] = sizes
        flow_valid[b, :F] = True
        if F:
            flow_counts[b, :M] = np.bincount(ms, minlength=M)
        rates[b, :K] = inst.rates
        inv_rates[b, :K] = 1.0 / inst.rates
        core_mask[b, :K] = True
        delta[b] = inst.delta

    def dev(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(device)

    return EnsembleBatch(
        lp_Y0=lp_arr["Y0"], lp_rho=lp_arr["p_rho"], lp_tau=lp_arr["p_tau"],
        lp_weights=lp_arr["weights"], lp_releases=lp_arr["releases"],
        inv_R=lp_arr["inv_R"], delta_over_K=lp_arr["delta_over_K"],
        coflow_mask=lp_arr["coflow_mask"], port_mask=lp_arr["port_mask"],
        weights=dev(weights), releases=dev(releases), glb=glb,
        flow_coflow=dev(flow_coflow), flow_src=dev(flow_src),
        flow_dst=dev(flow_dst), flow_pi=dev(flow_pi), flow_pj=dev(flow_pj),
        flow_size=dev(flow_size), flow_valid=dev(flow_valid),
        flow_counts=dev(flow_counts), rates=dev(rates),
        inv_rates=dev(inv_rates), core_mask=dev(core_mask), delta=dev(delta),
        num_instances=B, num_coflows=Ms, num_ports=Ns, num_cores=Ks,
        num_flows=Fs,
    )
