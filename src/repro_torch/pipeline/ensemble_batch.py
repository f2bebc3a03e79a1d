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

Every field is a tensor on the batch's device.  With ``mesh=`` the member
axis pads up to a multiple of the mesh's ``data`` size with fully masked
members and the batch records the data-axis `NamedSharding`
(`repro_torch.launch.mesh.data_sharding`): the batched stages (the LP,
the allocation scan, the card calendars) then run each shard on its own
device (`EnsembleBatch.shards`) and gather the result.  Members are
independent, so a member's bits do not depend on the shard count.
`expand_members` tiles the real members for refinement's candidates.
`BUILD_COUNT` counts constructions.

The streaming service's resident epochs run on a `SlotPoolBatch`: one
batch whose coflow axis is a pool of slots and whose flow axis is an arena
of per-slot extents, written in place by `update_slots` /
`set_slot_releases` / `free_slots` (counted by `SLOT_SCATTER_COUNT`) and
widened geometrically when it runs out (`SLOT_GROW_COUNT`).
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
from repro_torch.kernels.port_stats import port_stats
from repro_torch.launch.mesh import Mesh, NamedSharding, Sharded, data_axis_size, data_sharding, place

__all__ = [
    "EnsembleBatch", "AllocationBatch", "SlotPoolBatch", "build_ensemble_batch",
    "build_slot_pool_batch", "update_slots", "set_slot_releases", "free_slots",
    "expansion_maps", "BUILD_COUNT", "SLOT_SCATTER_COUNT", "SLOT_GROW_COUNT", "PAD_LB",
]

# Padded-core sentinel: dominates every real candidate bound but stays
# finite so padded-step arithmetic never produces inf * 0 = NaN.
PAD_LB = 1e30

#: `EnsembleBatch` constructions from host data in this process
#: (`expand_members` gathers a build and does not count).
BUILD_COUNT = 0

#: In-place writes into a resident `SlotPoolBatch` (`update_slots` /
#: `free_slots`): the streaming service's one exemption from building once.
SLOT_SCATTER_COUNT = 0

#: Flow-arena growths of resident slot pools (each a new, wider flow axis).
SLOT_GROW_COUNT = 0

#: Flow-table fields of an `EnsembleBatch`: the arena of a slot pool.
_FLOW_FIELDS = (
    "flow_coflow", "flow_src", "flow_dst", "flow_pi", "flow_pj", "flow_size", "flow_valid",
)


def _round_up(n: int, q: int) -> int:
    return -(-n // q) * q


@dataclasses.dataclass(frozen=True)
class EnsembleBatch:
    """One shape bucket of instances as padded device tensors.

    Array fields have a leading member axis of size ``pad_members``
    (``num_instances``, or more under a sharding: rows past
    ``num_instances`` are fully masked); the tuples record the true
    per-instance sizes used to unpad.
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
    sharding: NamedSharding | None = None

    @property
    def device(self) -> torch.device:
        return self.weights.device

    @property
    def pad_members(self) -> int:
        return int(self.weights.shape[0])

    @property
    def pad_coflows(self) -> int:
        return int(self.weights.shape[1])

    @property
    def pad_flat_ports(self) -> int:
        return int(self.port_mask.shape[1])

    @property
    def pad_flows(self) -> int:
        return int(self.flow_size.shape[1])

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

    def _tensor_fields(self) -> dict[str, torch.Tensor]:
        return {
            f.name: getattr(self, f.name)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)
        }

    # -- sharding ---------------------------------------------------------
    def shards(self) -> list["EnsembleBatch"]:
        """The batch split along its member axis under its sharding, one
        unsharded `EnsembleBatch` a shard: shard ``i`` holds rows
        ``[i Bp / n, (i + 1) Bp / n)`` on its device, the real members among
        them first (a shard may hold none).  Without a sharding, the batch
        itself."""
        if self.sharding is None:
            return [self]
        placed = {k: place(v, self.sharding) for k, v in self._tensor_fields().items()}
        n = self.sharding.num_shards
        rows = self.pad_members // n
        out = []
        for i in range(n):
            lo = i * rows
            real = slice(lo, lo + max(0, min(self.num_instances - lo, rows)))
            kw = {k: v.shards[i] if isinstance(v, Sharded) else v for k, v in placed.items()}
            out.append(EnsembleBatch(
                **kw, num_instances=real.stop - real.start,
                num_coflows=self.num_coflows[real], num_ports=self.num_ports[real],
                num_cores=self.num_cores[real], num_flows=self.num_flows[real],
            ))
        return out

    # -- ordering ---------------------------------------------------------
    def pad_orders(self, orders: Sequence[np.ndarray]) -> torch.Tensor:
        """(Bp, Mp) padded order tensor from per-instance permutations
        (padded coflow ids appended in id order)."""
        B, Mp = self.weights.shape
        out = np.tile(np.arange(Mp, dtype=np.int64), (B, 1))
        for b, o in enumerate(orders):
            out[b, : self.num_coflows[b]] = o
        return torch.from_numpy(out).to(self.device)

    # -- flows ------------------------------------------------------------
    def permute_flows(self, orders: torch.Tensor) -> torch.Tensor:
        """(Bp, Fp) stable flow permutation realizing a global coflow order:
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
        """(Bp, Mp) running flow count after each order position."""
        return torch.gather(self.flow_counts, 1, orders).cumsum(dim=1)

    # -- member expansion -------------------------------------------------
    def expand_members(
        self, reps: int
    ) -> tuple["EnsembleBatch", np.ndarray, np.ndarray]:
        """Tile every real member ``reps`` times along the member axis.

        The expansion behind candidate-search refinement
        (`repro_torch.pipeline.refine`): expanded row ``b * reps + c`` is
        copy (candidate slot) ``c`` of instance ``b``, candidate-major
        within instance, so downstream stages see ``B * reps`` ordinary
        members.  Padding rows are not tiled; under a sharding the tail
        pads to a multiple of the ``data`` size with copies of the last
        (fully masked) row, and the sharding is kept.  One `index_select`
        per tensor field on the batch's device: a gather of this build, not
        a rebuild, so `port_stats` does not run again.  Returns
        ``(expanded, instance_of, candidate_of)``, the row maps of
        `expansion_maps`.
        """
        reps = int(reps)
        if reps < 1:
            raise ValueError(f"reps must be >= 1, got {reps}")
        B = self.num_instances
        idx = torch.arange(B, device=self.device).repeat_interleave(reps)
        new_Bp = B * reps
        if self.sharding is not None:
            new_Bp = _round_up(max(new_Bp, 1), self.sharding.num_shards)
        if new_Bp > B * reps:
            # A remainder means B was rounded up too: row Bp - 1 is masked.
            if self.pad_members <= B:
                raise AssertionError("sharded batch without a masked padding row")
            tail = torch.full((new_Bp - B * reps,), self.pad_members - 1, device=self.device)
            idx = torch.cat([idx, tail])

        def rep(t: tuple) -> tuple:
            return tuple(x for x in t for _ in range(reps))

        kw = {k: v.index_select(0, idx) for k, v in self._tensor_fields().items()}
        kw.update(
            num_instances=B * reps,
            num_coflows=rep(self.num_coflows),
            num_ports=rep(self.num_ports),
            num_cores=rep(self.num_cores),
            num_flows=rep(self.num_flows),
            sharding=self.sharding,
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

    @staticmethod
    def concat(parts: Sequence["AllocationBatch"], device: torch.device) -> "AllocationBatch":
        """The shards' batches as one, member axis in shard order, on
        ``device``."""
        return AllocationBatch(**{
            f.name: torch.cat([getattr(p, f.name).to(device) for p in parts])
            for f in dataclasses.fields(AllocationBatch)
        })

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
    *,
    pad_coflows: int | None = None,
    pad_ports: int | None = None,
    pad_flows: int | None = None,
    pad_cores: int | None = None,
    mesh: Mesh | None = None,
    warm_start_orders: Sequence[np.ndarray | None] | None = None,
    with_lp_arrays: bool = True,
) -> EnsembleBatch:
    """Build the padded tensors of one ensemble -- once -- on ``device``.

    ``pad_*`` default to the ensemble maxima; ``warm_start_orders`` seeds
    the LP warm starts (`lp.pack_lp_arrays`).  With ``mesh`` the member
    axis pads up to a multiple of the mesh's ``data`` size (fully masked
    members) and the batch records the data-axis sharding its stages run
    under.  ``with_lp_arrays=False`` leaves the LP solver's (B, Mp, Mp)
    warm starts and (B, Mp, Pp) port statistics out (zero-width), keeping
    the masks: the mode of a caller that solved its LP elsewhere.  The
    per-port statistics still run (the `port_stats` kernel), since ``glb``
    reads them.
    """
    global BUILD_COUNT
    BUILD_COUNT += 1
    device = resolve_device(device)
    instances = list(instances)
    B = len(instances)
    sharding, Bp = None, B
    if mesh is not None:
        sharding = data_sharding(mesh)
        sharding.devices()  # a card the host lacks raises here
        Bp = max(_round_up(max(B, 1), data_axis_size(mesh)), B)
    Ms = tuple(inst.num_coflows for inst in instances)
    Ns = tuple(inst.num_ports for inst in instances)
    Ks = tuple(inst.num_cores for inst in instances)
    Mp = pad_coflows if pad_coflows is not None else max(Ms, default=0)
    Pp = pad_ports if pad_ports is not None else max((2 * n for n in Ns), default=0)
    Kp = max(pad_cores if pad_cores is not None else max(Ks, default=1), 1)

    # Per-port statistics on the device (the port_stats kernel): the LP
    # arrays and the f64 global lower bounds both read them.
    stats = lp_mod.instance_port_stats(instances, device)
    glbs = [lp_mod.global_lower_bound(i, s[0]) for i, s in zip(instances, stats)]
    if with_lp_arrays:
        lp_arr = lp_mod._pack(
            instances, stats, glbs, Mp, Pp, device, warm_start_orders, pad_members=Bp
        )
    else:
        coflow_mask = np.zeros((Bp, Mp), dtype=bool)
        port_mask = np.zeros((Bp, Pp), dtype=bool)
        for b, inst in enumerate(instances):
            coflow_mask[b, : Ms[b]] = True
            port_mask[b, : 2 * Ns[b]] = True
        f32 = dict(dtype=torch.float32, device=device)
        lp_arr = dict(
            Y0=torch.zeros((Bp, 0, 0), **f32), p_rho=torch.zeros((Bp, 0, 0), **f32),
            p_tau=torch.zeros((Bp, 0, 0), **f32), weights=torch.zeros((Bp, 0), **f32),
            releases=torch.zeros((Bp, 0), **f32), inv_R=torch.zeros(Bp, **f32),
            delta_over_K=torch.zeros(Bp, **f32),
            coflow_mask=torch.from_numpy(coflow_mask).to(device),
            port_mask=torch.from_numpy(port_mask).to(device),
        )

    seqs = [_canonical_flows(inst) for inst in instances]
    Fs = tuple(s[0].shape[0] for s in seqs)
    Fp = pad_flows if pad_flows is not None else max(Fs, default=0)

    weights = np.zeros((Bp, Mp))
    releases = np.zeros((Bp, Mp))
    glb = torch.zeros((Bp, Mp), dtype=torch.float64, device=device)
    flow_coflow = np.zeros((Bp, Fp), dtype=np.int64)
    flow_src = np.zeros((Bp, Fp), dtype=np.int64)
    flow_dst = np.zeros((Bp, Fp), dtype=np.int64)
    flow_pi = np.zeros((Bp, Fp), dtype=np.int64)
    flow_pj = np.zeros((Bp, Fp), dtype=np.int64)
    flow_size = np.zeros((Bp, Fp))
    flow_valid = np.zeros((Bp, Fp), dtype=bool)
    flow_counts = np.zeros((Bp, Mp), dtype=np.int64)
    rates = np.ones((Bp, Kp))
    inv_rates = np.full((Bp, Kp), PAD_LB)
    core_mask = np.zeros((Bp, Kp), dtype=bool)
    delta = np.zeros(Bp)
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
        num_flows=Fs, sharding=sharding,
    )


# ---------------------------------------------------------------------------
# Resident slot pool: one EnsembleBatch written in place across epochs
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SlotPoolBatch:
    """A long-lived `EnsembleBatch` whose coflow axis is a slot pool.

    The streaming service's resident epoch state: one batch padded to the
    pool capacity ``slots`` on the coflow axis, its flow axis a flat arena
    of extents (one contiguous extent per occupied slot, its capacity fixed
    at admission).  `update_slots` / `free_slots` write residual demands,
    weights, releases and masks into the batch's tensors in place; the
    frozen `EnsembleBatch` is replaced only when the arena grows.  The
    arena's bookkeeping (``flow_start``, ``flow_cap``) is host NumPy.

    Rows are slot-indexed.  The resident epoch matches the dense rebuild
    because the allocation scan reads only (port, size, validity) in
    permuted order and the permutation sends invalid flows to the tail
    (`repro_torch.streaming.service`).
    """

    batch: EnsembleBatch
    member: int  # the row the writes go to (0; a sharded pool's others stay masked)
    flow_quantum: int
    flow_start: np.ndarray  # (S,) i64 arena offset per slot, -1 = free
    flow_cap: np.ndarray  # (S,) i64 extent capacity per slot
    aggregate_rate: float
    delta: float

    @property
    def slots(self) -> int:
        return self.batch.pad_coflows

    @property
    def flow_capacity(self) -> int:
        return self.batch.pad_flows

    def occupied(self) -> np.ndarray:
        """(S,) bool -- slots currently holding a coflow."""
        return self.flow_start >= 0


def build_slot_pool_batch(
    slots: int,
    num_ports: int,
    rates: np.ndarray,
    delta: float,
    *,
    flow_quantum: int = 64,
    device: str | torch.device = "cuda",
    mesh: Mesh | None = None,
) -> SlotPoolBatch:
    """An empty resident pool on ``device`` (one build, one `port_stats`
    launch): the `EnsembleBatch` of a zero-demand template of ``slots``
    coflows, every slot then marked free.  With ``mesh`` the batch pads
    its member axis to the ``data`` size as `build_ensemble_batch` does;
    the slot writes go to member 0 and the padding rows stay masked."""
    if slots <= 0:
        raise ValueError(f"slots must be positive, got {slots}")
    if flow_quantum <= 0:
        raise ValueError(f"flow_quantum must be positive, got {flow_quantum}")
    rates = np.asarray(rates, dtype=np.float64)
    template = CoflowInstance(
        demands=np.zeros((slots, num_ports, num_ports)),
        weights=np.ones(slots),  # placeholder: every slot starts masked
        releases=np.zeros(slots),
        rates=rates.copy(),
        delta=float(delta),
    )
    batch = build_ensemble_batch([template], device, pad_flows=flow_quantum, mesh=mesh)
    batch.coflow_mask[0, :] = False  # every slot starts free
    batch.weights[0, :] = 0.0
    batch.lp_weights[0, :] = 0.0
    batch.glb[0, :] = 0.0
    return SlotPoolBatch(
        batch=batch,
        member=0,
        flow_quantum=int(flow_quantum),
        flow_start=np.full(slots, -1, dtype=np.int64),
        flow_cap=np.zeros(slots, dtype=np.int64),
        aggregate_rate=float(rates.sum()),
        delta=float(delta),
    )


def _arena_gaps(pool: SlotPoolBatch) -> list[tuple[int, int]]:
    """Free arena intervals [start, stop) in address order."""
    occ = np.nonzero(pool.flow_start >= 0)[0]
    ivals = sorted((int(pool.flow_start[s]), int(pool.flow_cap[s])) for s in occ)
    gaps, cursor = [], 0
    for start, cap in ivals:
        if start > cursor:
            gaps.append((cursor, start))
        cursor = start + cap
    if cursor < pool.flow_capacity:
        gaps.append((cursor, pool.flow_capacity))
    return gaps


def _compact_arena(pool: SlotPoolBatch) -> None:
    """Left-pack every occupied extent, address order kept.

    Arena addresses mean nothing downstream (the allocation permutation
    orders flows by slot priority, ties by address, and a slot's flows stay
    contiguous), so compaction changes no schedule.  An extent moved left
    by less than its length overlaps its old place, and an in-place copy
    between overlapping views is not safe in PyTorch, so the source is
    cloned first.
    """
    b, r = pool.batch, pool.member
    occ = np.nonzero(pool.flow_start >= 0)[0]
    cursor = 0
    for s in sorted(occ, key=lambda s: int(pool.flow_start[s])):
        start, cap = int(pool.flow_start[s]), int(pool.flow_cap[s])
        if start != cursor:
            for name in _FLOW_FIELDS:
                arr = getattr(b, name)
                arr[r, cursor:cursor + cap] = arr[r, start:start + cap].clone()
                arr[r, max(start, cursor + cap):start + cap] = 0
        pool.flow_start[s] = cursor
        cursor += cap


def _grow_arena(pool: SlotPoolBatch, need: int) -> None:
    """Geometric flow-capacity growth: a new, wider flow axis.

    Doubling (rounded to the quantum) keeps the number of distinct arena
    widths logarithmic in the stream's flow volume; `SLOT_GROW_COUNT`
    counts the steps.  The frozen batch is replaced by one with wider flow
    tensors; nothing else of it derives from the flow axis (``pad_flows``
    reads the new width).
    """
    global SLOT_GROW_COUNT
    SLOT_GROW_COUNT += 1
    b = pool.batch
    new_cap = _round_up(max(need, 2 * pool.flow_capacity), pool.flow_quantum)

    def widen(arr: torch.Tensor) -> torch.Tensor:
        out = arr.new_zeros((arr.shape[0], new_cap))
        out[:, : arr.shape[1]] = arr
        return out

    pool.batch = dataclasses.replace(
        b, **{name: widen(getattr(b, name)) for name in _FLOW_FIELDS}
    )


def _reserve_extent(pool: SlotPoolBatch, slot: int, count: int) -> int:
    """Arena offset for ``count`` flows of ``slot``: its own extent if it
    fits, else first fit, then compaction, then growth.  An extent keeps
    its capacity until the slot is freed (residuals only shrink in the
    streaming service) or outgrown."""
    cap = max(int(count), 1)
    if pool.flow_start[slot] >= 0:
        if pool.flow_cap[slot] >= cap:
            return int(pool.flow_start[slot])
        _release_extent(pool, [slot])
    for lo, hi in _arena_gaps(pool):
        if hi - lo >= cap:
            pool.flow_start[slot] = lo
            pool.flow_cap[slot] = cap
            return lo
    used = int(pool.flow_cap[pool.flow_start >= 0].sum())
    _compact_arena(pool)
    if pool.flow_capacity - used < cap:
        _grow_arena(pool, used + cap)
    pool.flow_start[slot] = used
    pool.flow_cap[slot] = cap
    return used


def _extent_positions(pool: SlotPoolBatch, slots) -> np.ndarray:
    """Arena addresses of the given slots' whole extents, concatenated."""
    parts = [
        np.arange(pool.flow_start[s], pool.flow_start[s] + pool.flow_cap[s])
        for s in slots
        if pool.flow_start[s] >= 0
    ]
    return np.concatenate(parts) if parts else np.zeros(0, dtype=np.int64)


def _release_extent(pool: SlotPoolBatch, slots) -> None:
    """Zero the given slots' extents (one write a field) and free them."""
    b, r = pool.batch, pool.member
    pos = _extent_positions(pool, slots)
    if pos.size:
        idx = torch.from_numpy(pos).to(b.device)
        for name in _FLOW_FIELDS:
            getattr(b, name)[r, idx] = 0
    for s in slots:
        pool.flow_start[s] = -1
        pool.flow_cap[s] = 0


def update_slots(
    pool: SlotPoolBatch,
    slots: np.ndarray,
    demands: np.ndarray,
    weights: np.ndarray,
    releases: np.ndarray,
) -> None:
    """Write per-slot coflow state into the resident batch, in place.

    ``demands`` is (n, N, N) host residual demand per updated slot;
    ``weights`` and ``releases`` are (n,).  Each slot's canonical flow list
    (largest first, `flows_of`) goes to its extent (reserved first fit,
    then compacted, then grown); the whole update is one host table and
    one write a field.  The stacked demands take one `port_stats` launch,
    whose ``rho`` keeps NumPy's bits, for the LP's port statistics and the
    f64 ``glb`` (divided by R as a tensor: WSPT and the warm start read its
    bits).  Counted by `SLOT_SCATTER_COUNT`.
    """
    global SLOT_SCATTER_COUNT
    SLOT_SCATTER_COUNT += 1
    slots = np.asarray(slots, dtype=np.int64)
    demands = np.ascontiguousarray(demands, dtype=np.float64)
    flows = [flows_of(demands[n]) for n in range(slots.shape[0])]
    for s, (i_idx, _, _) in zip(slots, flows):
        _reserve_extent(pool, int(s), i_idx.shape[0])
    b, r = pool.batch, pool.member  # the reservations may have grown it
    N = b.num_ports[r]
    cols = {name: [] for name in _FLOW_FIELDS}
    for s, (i_idx, j_idx, sizes) in zip(slots, flows):
        pad = np.zeros(int(pool.flow_cap[s]) - i_idx.shape[0], dtype=np.int64)
        cols["flow_coflow"] += [np.full(i_idx.shape[0], s), pad]
        cols["flow_src"] += [i_idx, pad]
        cols["flow_dst"] += [j_idx, pad]
        cols["flow_pi"] += [i_idx, pad]
        cols["flow_pj"] += [N + j_idx, pad]
        cols["flow_size"] += [sizes, pad.astype(np.float64)]
        cols["flow_valid"] += [np.ones(i_idx.shape[0], dtype=bool), pad.astype(bool)]
    dev = b.device

    def put(arr: torch.Tensor, idx: torch.Tensor, values: np.ndarray) -> None:
        arr[r, idx] = torch.from_numpy(values).to(dev, arr.dtype)

    if slots.size:
        idx = torch.from_numpy(_extent_positions(pool, slots)).to(dev)
        for name, parts in cols.items():
            put(getattr(b, name), idx, np.concatenate(parts))
    st = torch.from_numpy(slots).to(dev)
    put(b.flow_counts, st, np.array([f[0].shape[0] for f in flows], dtype=np.int64))
    rho, tau = port_stats(torch.from_numpy(demands).to(dev))
    b.lp_rho[r, st] = rho.to(torch.float32)
    b.lp_tau[r, st] = tau.to(torch.float32)
    if slots.size:
        b.glb[r, st] = pool.delta + rho.amax(dim=1) / rho.new_tensor(pool.aggregate_rate)
    weights = np.asarray(weights, dtype=np.float64)
    releases = np.asarray(releases, dtype=np.float64)
    put(b.weights, st, weights)
    put(b.releases, st, releases)
    put(b.lp_weights, st, weights.astype(np.float32))
    put(b.lp_releases, st, releases.astype(np.float32))
    b.coflow_mask[r, st] = True


def set_slot_releases(pool: SlotPoolBatch, slots: np.ndarray, releases: np.ndarray) -> None:
    """The per-epoch release refresh (``max(arrival, now)``): no flow or
    port-statistics rewrite."""
    b, r = pool.batch, pool.member
    st = torch.from_numpy(np.asarray(slots, dtype=np.int64)).to(b.device)
    releases = np.asarray(releases, dtype=np.float64)
    b.releases[r, st] = torch.from_numpy(releases).to(b.device)
    b.lp_releases[r, st] = torch.from_numpy(releases.astype(np.float32)).to(b.device)


def free_slots(pool: SlotPoolBatch, slots: np.ndarray) -> None:
    """Return slots to the pool: masks cleared, extents and every per-slot
    field zeroed, so a later tenant of the slot sees nothing of this one."""
    global SLOT_SCATTER_COUNT
    SLOT_SCATTER_COUNT += 1
    slots = np.asarray(slots, dtype=np.int64)
    b, r = pool.batch, pool.member
    _release_extent(pool, slots)
    st = torch.from_numpy(slots).to(b.device)
    for arr in (
        b.flow_counts, b.coflow_mask, b.weights, b.releases, b.glb,
        b.lp_weights, b.lp_releases, b.lp_rho, b.lp_tau,
    ):
        arr[r, st] = 0
