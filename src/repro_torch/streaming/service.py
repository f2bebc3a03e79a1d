"""`stream()` -- the event-driven online scheduler (port of
`repro.streaming.service`).

Event loop (one *epoch* per event), as the reference runs it:

  1. **Arrival batches.**  Coflows are sorted by release time and grouped
     into arrival batches -- ``n_batches`` equal chunks (replay-style: a
     chunk is admitted when its first coflow arrives, original releases
     are honored as lower bounds) or a ``batch_window`` grouping (true
     online: the scheduler acts when the last coflow of the window has
     arrived).  The default (``batch_window=None``) re-solves once per
     distinct arrival instant.
  2. **Advance.**  At epoch time ``now`` the incumbent calendar is settled
     in host NumPy, one masked pass over its rows: flows with
     ``complete <= now`` are delivered, flows with ``establish >= now`` are
     cancelled back into the pool, and in-flight flows are either
     *preempted* (``preempt=True``: the bytes sent so far leave the
     residual; the remainder pays the reconfiguration delta again) or
     *committed* (``preempt=False``: the flow runs to completion as a
     phantom circuit blocking its port pair in every later calendar, see
     ``schedule_batch_arrays(busy=...)``).  Coflows whose residual reaches
     zero free their pool slot.
  3. **Admit.**  Queued arrivals take free slots in ring order
     (`repro_torch.streaming.pool.SlotPool`); overflow waits.
  4. **Re-solve.**  The active set runs the stages of the offline
     `Pipeline.run_batch` on the device: ordering LP -> masked stable
     order -> allocation scan -> circuit calendar.  The batched LP is
     warm-started: the previous epoch's precedences are kept per slot
     pair and seed ``Y0`` for every pair solved together before, and warm
     epochs run ``lp_iters_warm`` (< ``lp_iters``) steps.

Epoch modes (``epoch_mode``):

  * ``"rebuild"`` -- every epoch packs a dense residual `CoflowInstance`
    and builds a fresh `EnsembleBatch` on the device; it hosts the
    per-epoch exact LP (``lp_method="exact"``, HiGHS on the host).
  * ``"resident"`` -- one `SlotPoolBatch` padded to the pool capacity S
    lives on the device for the whole stream; epochs write residuals,
    weights, releases and masks into occupied slots in place
    (`update_slots`: one `port_stats` launch for the updated slots'
    stacked demands), gather the dense LP inputs on the device and keep
    the warm-start precedence matrix there (`lp.warm_gather_device` /
    ``warm_scatter_device``): it never visits the host.  The allocation
    scan runs over the whole slot arena in slot space, free slots at the
    tail of the order (their invalid flows sort last: exact no-ops).
    With ``warm_start=False`` a resident epoch is bit-identical to a
    rebuild epoch: the gathered LP inputs equal `pack_lp_arrays`'s at the
    same padded shapes, the dense order view sorts the same keys, and the
    slot-space scan differs from the dense one only by no-op steps.
  * ``"auto"`` (default) -- resident for the batched solver, rebuild for
    ``lp_method="exact"``.

With one arrival batch and preemption off the loop is exactly one epoch
whose instance is the offline instance, so orders, allocations and CCTs
are bit-identical to `Pipeline.run_batch`; every streamed run is within
the paper's (8K + 1[any release > 0]) bound of the full instance's exact
LP.  Bookkeeping (settlement, the pool, the calendar and the committed
circuits) is host NumPy; the LP, the order, the allocation and the
calendar rounds run where the stream runs, on the card unless the caller
passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from repro_torch.core import lp
from repro_torch.core.allocation import Allocation
from repro_torch.core.circuit import CoreSchedule
from repro_torch.core.coflow import CoflowInstance
from repro_torch.core.validate import validate_schedule
from repro_torch.device import resolve_device
from repro_torch.pipeline.batch_circuit import schedule_batch_arrays
from repro_torch.pipeline.ensemble_batch import (
    _round_up,
    build_ensemble_batch,
    build_slot_pool_batch,
    free_slots,
    set_slot_releases,
    update_slots,
)
from repro_torch.pipeline.pipeline import get_pipeline, order_view
from repro_torch.pipeline.stages import ListCircuit
from repro_torch.streaming.pool import SlotPool

__all__ = ["EPOCH_MODES", "EpochRecord", "StreamResult", "stream"]

EPOCH_MODES = ("auto", "rebuild", "resident")


@dataclasses.dataclass
class EpochRecord:
    """One re-solve: who was active, what the scheduler decided."""

    index: int
    time: float  # epoch (event) time
    actives: np.ndarray  # global coflow ids, dense order (ascending id)
    admitted: np.ndarray  # global ids admitted at this epoch
    order: np.ndarray  # global ids, highest priority first
    allocation: Allocation | None  # epoch-dense coflow indexing
    ccts: np.ndarray  # (Me,) projected absolute completions, dense
    lp: lp.LPSolution | None
    warm: bool  # LP seeded from the previous iterate
    lp_iters_used: int
    lp_wall_s: float
    num_busy: int  # phantom committed circuits carried in
    wall_s: float
    lp_objective: float | None = None  # kept even when `lp` is dropped
    # Host seconds by stage (resident: "slots", "lp", "order",
    # "allocation", "calendar"; rebuild: "build" in place of "slots"),
    # read at the stage boundaries with no synchronize of their own: device
    # work a stage queued and the device had not finished shows in the next
    # stage that reads a result.
    stage_s: dict[str, float] = dataclasses.field(default_factory=dict)
    slots_written: int = 0  # slots `update_slots` rewrote (resident mode)


@dataclasses.dataclass
class StreamResult:
    """Realized outcome of one streamed run (absolute times throughout)."""

    scheme: str
    discipline: str
    lp_method: str
    preempt: bool
    warm_start: bool
    pool_size: int
    lp_iters: int
    lp_iters_warm: int
    weights: np.ndarray  # (M,)
    arrival: np.ndarray  # (M,) release/arrival times
    admission: np.ndarray  # (M,) epoch time the coflow got a slot
    finish: np.ndarray  # (M,) realized completion (last byte delivered)
    epochs: list[EpochRecord]
    lp_time_s: float
    wall_time_s: float
    admission_policy: str = "fifo"  # slot-pool policy (see SlotPool)
    epoch_mode: str = "rebuild"  # resolved epoch mode (never "auto")

    @property
    def realized_weighted_cct(self) -> float:
        """Sum_m w_m T_m with T_m the realized absolute completion."""
        return float(np.dot(self.weights, self.finish))

    @property
    def num_resolves(self) -> int:
        return len(self.epochs)

    @property
    def warm_resolves(self) -> int:
        return sum(1 for e in self.epochs if e.warm)

    @property
    def iteration_savings(self) -> int:
        """Subgradient iterations avoided by warm-started re-solves."""
        return sum(
            self.lp_iters - e.lp_iters_used for e in self.epochs if e.warm
        )

    def coflow_rows(self, base: dict | None = None) -> list[dict]:
        """One row per coflow: arrival → admission → completion."""
        base = dict(base or {})
        rows = []
        for m in range(self.weights.shape[0]):
            rows.append(
                dict(
                    base,
                    coflow=m,
                    weight=float(self.weights[m]),
                    arrival=float(self.arrival[m]),
                    admission=float(self.admission[m]),
                    completion=float(self.finish[m]),
                    cct=float(self.finish[m] - self.arrival[m]),
                    latency=float(self.finish[m] - self.admission[m]),
                    wait=float(self.admission[m] - self.arrival[m]),
                )
            )
        return rows

    def epoch_rows(self, base: dict | None = None) -> list[dict]:
        base = dict(base or {})
        return [
            dict(
                base,
                epoch=e.index,
                time=e.time,
                num_active=int(e.actives.shape[0]),
                num_admitted=int(e.admitted.shape[0]),
                num_busy=e.num_busy,
                warm=e.warm,
                lp_iters_used=e.lp_iters_used,
                lp_objective=(
                    e.lp_objective
                    if e.lp_objective is not None
                    else (float(e.lp.objective) if e.lp is not None else None)
                ),
                lp_wall_s=e.lp_wall_s,
                wall_s=e.wall_s,
            )
            for e in self.epochs
        ]

    def summary(self) -> dict[str, Any]:
        cct = self.finish - self.arrival
        return dict(
            scheme=self.scheme,
            discipline=self.discipline,
            lp_method=self.lp_method,
            preempt=self.preempt,
            warm_start=self.warm_start,
            pool_size=self.pool_size,
            admission_policy=self.admission_policy,
            epoch_mode=self.epoch_mode,
            num_coflows=int(self.weights.shape[0]),
            realized_weighted_cct=self.realized_weighted_cct,
            num_resolves=self.num_resolves,
            warm_resolves=self.warm_resolves,
            iteration_savings=self.iteration_savings,
            mean_cct=float(cct.mean()) if cct.size else 0.0,
            p95_cct=float(np.quantile(cct, 0.95)) if cct.size else 0.0,
            mean_wait=(
                float((self.admission - self.arrival).mean())
                if cct.size
                else 0.0
            ),
            lp_time_s=self.lp_time_s,
            wall_time_s=self.wall_time_s,
        )

    def save(self, name: str) -> dict[str, str]:
        """Write `{name}_coflows` / `{name}_epochs` JSON+CSV rows and a
        `{name}_summary` JSON into
        `repro_torch.experiments.results.results_dir`."""
        from repro_torch.experiments.results import save_json, save_rows

        base = dict(scheme=self.scheme, discipline=self.discipline)
        cj, cc = save_rows(f"{name}_coflows", self.coflow_rows(base))
        ej, ec = save_rows(f"{name}_epochs", self.epoch_rows(base))
        sj = save_json(f"{name}_summary", self.summary())
        return dict(
            coflows_json=cj, coflows_csv=cc,
            epochs_json=ej, epochs_csv=ec, summary_json=sj,
        )


class _WarmState:
    """Slot-pair warm-start memory for the batched LP.

    ``Y[sa, sb]`` stores the full precedence value x_{a,b} (probability
    that the coflow in slot ``sa`` precedes the one in ``sb``) from the
    last solve that held both; storing the full matrix makes the gather
    orientation-free.  A slot's rows go stale the moment it is freed
    (``solved`` cleared).

    With a ``device`` (the resident mode) ``Y`` is an (S, S) f32 tensor
    there for the life of the stream, gathered into the dense warm start
    and scattered back by `lp.warm_gather_device` / ``warm_scatter_device``;
    only the (S,) ``solved`` mask stays on the host.  Without one (the
    rebuild mode) everything is host NumPy, as in the reference.
    """

    def __init__(self, size: int, device: torch.device | None = None):
        self.size = size
        self.device = device
        if device is not None:
            self.Y = torch.zeros((size, size), dtype=torch.float32, device=device)
        else:
            self.Y = np.zeros((size, size), dtype=np.float32)
        self.solved = np.zeros(size, dtype=bool)

    # -- host path (rebuild mode) ----------------------------------------
    def gather(self, slots: np.ndarray, default_Y0: np.ndarray) -> tuple:
        """Warm Y0 for the dense active set; returns (Y0, any_warm)."""
        prev = self.solved[slots]
        both = prev[:, None] & prev[None, :]
        if not np.triu(both, k=1).any():
            return default_Y0, False
        Ys = self.Y[np.ix_(slots, slots)]
        return np.triu(np.where(both, Ys, default_Y0), k=1), True

    def scatter(self, slots: np.ndarray, precedence: np.ndarray) -> None:
        self.Y[np.ix_(slots, slots)] = precedence.astype(np.float32)
        self.solved[slots] = True

    # -- device path (resident mode) -------------------------------------
    def gather_device(self, slots_padded: torch.Tensor, default_Y0: torch.Tensor) -> tuple:
        """Device warm Y0 ((S, S) f32) for dense positions ``slots_padded``
        (padded with the out-of-range index S); returns (Y0, any_warm)."""
        solved = torch.from_numpy(self.solved).to(self.device)
        Y0, any_warm = lp.warm_gather_device(self.Y, solved, slots_padded, default_Y0)
        return Y0, bool(any_warm)

    def scatter_device(
        self, slots_padded: torch.Tensor, slots: np.ndarray, y_dense: torch.Tensor
    ) -> None:
        """Write the solver's dense strict-upper ``y`` back at slot pairs."""
        self.Y = lp.warm_scatter_device(self.Y, slots_padded, y_dense)
        self.solved[slots] = True

    # -- shared ------------------------------------------------------------
    def forget_slots(self, slots) -> None:
        """Invalidate freed slots (one write per drain event)."""
        self.solved[np.asarray(slots, dtype=np.int64)] = False

    def forget(self, slot: int) -> None:
        self.forget_slots(np.asarray([slot], dtype=np.int64))


@dataclasses.dataclass
class _Calendar:
    """Incumbent calendar as parallel arrays: one row per scheduled flow.

    The `_advance` settlement is a handful of masked array ops over these
    rows instead of a Python loop — (m, i, j) triples are unique within a
    calendar (a flow is placed on exactly one core and scheduled once),
    so plain fancy-indexed subtraction settles residuals exactly.
    """

    m: np.ndarray  # (n,) global coflow ids
    k: np.ndarray  # (n,) core ids
    i: np.ndarray  # (n,) ingress ports
    j: np.ndarray  # (n,) egress ports
    size: np.ndarray  # (n,) scheduled sizes
    est: np.ndarray  # (n,) establish times
    comp: np.ndarray  # (n,) completion times

    @classmethod
    def empty(cls) -> "_Calendar":
        z = np.zeros(0)
        zi = np.zeros(0, dtype=np.int64)
        return cls(zi, zi, zi, zi, z, z, z)

    @classmethod
    def from_schedules(
        cls, schedules: list[CoreSchedule], coflow_map: np.ndarray
    ) -> "_Calendar":
        """Concatenate per-core schedules; ``coflow_map`` sends the
        schedules' coflow ids (dense or slot) to global ids."""
        ms, ks, is_, js, sz, es, cp = [], [], [], [], [], [], []
        for k, cs in enumerate(schedules):
            if len(cs.coflow) == 0:
                continue
            ms.append(coflow_map[cs.coflow])
            ks.append(np.full(len(cs.coflow), k, dtype=np.int64))
            is_.append(np.asarray(cs.src, dtype=np.int64))
            js.append(np.asarray(cs.dst, dtype=np.int64))
            sz.append(np.asarray(cs.size, dtype=np.float64))
            es.append(np.asarray(cs.establish, dtype=np.float64))
            cp.append(np.asarray(cs.complete, dtype=np.float64))
        if not ms:
            return cls.empty()
        return cls(
            np.concatenate(ms), np.concatenate(ks), np.concatenate(is_),
            np.concatenate(js), np.concatenate(sz), np.concatenate(es),
            np.concatenate(cp),
        )


@dataclasses.dataclass
class _Busy:
    """Committed in-flight circuits as parallel arrays (k, i, j, end)."""

    k: np.ndarray
    i: np.ndarray
    j: np.ndarray
    end: np.ndarray

    @classmethod
    def empty(cls) -> "_Busy":
        zi = np.zeros(0, dtype=np.int64)
        return cls(zi, zi, zi, np.zeros(0))

    def keep_after(self, now: float) -> "_Busy":
        sel = self.end > now
        return _Busy(self.k[sel], self.i[sel], self.j[sel], self.end[sel])

    def extend(self, k, i, j, end) -> "_Busy":
        return _Busy(
            np.concatenate([self.k, k]), np.concatenate([self.i, i]),
            np.concatenate([self.j, j]), np.concatenate([self.end, end]),
        )

    def tables(self, now: float, num_cores: int) -> dict | None:
        """`schedule_batch_arrays(busy=...)` phantom tables (or None)."""
        if self.k.size == 0:
            return None
        tabs = {}
        for k in range(num_cores):
            sel = self.k == k
            n = int(sel.sum())
            if n:
                tabs[0, k] = dict(
                    src=self.i[sel], dst=self.j[sel],
                    rel=np.full(n, now, dtype=np.float64),
                    dur=self.end[sel] - now,
                )
        return tabs


class _StageClock:
    """Host seconds between an epoch's stage boundaries, by stage."""

    def __init__(self, t0: float):
        self.t, self.seconds = t0, {}

    def lap(self, stage: str) -> None:
        t = time.perf_counter()
        self.seconds[stage] = t - self.t
        self.t = t


def _arrival_batches(
    releases: np.ndarray,
    n_batches: int | None,
    batch_window: float | None,
) -> list[tuple[float, list[int]]]:
    """Group coflows into arrival batches: [(epoch_time, [global ids])].

    ``n_batches``: split the release-sorted trace into that many chunks;
    a chunk's epoch fires when its FIRST coflow arrives (replay-style —
    later members are admitted early but their releases still lower-bound
    every establishment).  ``batch_window``: group coflows whose releases
    fall within one window; the epoch fires at the LAST release of the
    group (true online — nothing is known before it arrives).  Default
    (both None): one batch per distinct release instant.
    """
    if n_batches is not None and batch_window is not None:
        raise ValueError("pass n_batches or batch_window, not both")
    order = np.argsort(releases, kind="stable")
    if order.size == 0:
        return []
    if n_batches is not None:
        if n_batches <= 0:
            raise ValueError(f"n_batches must be positive, got {n_batches}")
        chunks = np.array_split(order, min(n_batches, order.size))
        return [
            (float(releases[c[0]]), [int(m) for m in c])
            for c in chunks
            if c.size
        ]
    window = 0.0 if batch_window is None else float(batch_window)
    if window < 0:
        raise ValueError(f"batch_window must be >= 0, got {batch_window}")
    rs = releases[order]
    batches = []
    i = 0
    while i < order.size:
        j = i + 1
        while j < order.size and rs[j] <= rs[i] + window:
            j += 1
        batches.append((float(rs[j - 1]), [int(m) for m in order[i:j]]))
        i = j
    return batches


def stream(
    instance: CoflowInstance,
    *,
    scheme: str = "ours",
    lp_method: str = "batch",
    lp_iters: int = 3000,
    lp_iters_warm: int | None = None,
    discipline: str = "greedy",
    engine: str = "auto",
    n_batches: int | None = None,
    batch_window: float | None = None,
    pool_size: int | None = None,
    preempt: bool = True,
    warm_start: bool = True,
    validate: bool = True,
    admission: str = "fifo",
    epoch_mode: str = "auto",
    flow_quantum: int = 64,
    device: str | torch.device = "cuda",
) -> StreamResult:
    """Schedule `instance`'s coflows online, admitting by release time.

    ``instance.releases`` are the arrival times (stamp any arrival process
    onto a workload with `repro_torch.traffic.with_releases`).
    ``lp_method`` is ``"batch"`` (the warm-startable batched subgradient
    solver on the device) or ``"exact"`` (per-epoch HiGHS on the host).
    ``admission`` picks the slot pool's policy under contention
    (``"fifo"``, ``"weighted"``, ``"size_aware"``; it matters only when
    ``pool_size`` binds).  ``epoch_mode`` picks the epoch mode (module
    docstring).  ``flow_quantum`` quantizes the resident flow arena: its
    capacity starts at one quantum or the stream's expected concurrent
    flow count, whichever is larger, and grows geometrically.  ``engine``
    is the calendar executor (``"auto"``: the pair calendar on a card, the
    host engine on the CPU).  The stream runs on ``device``: the card by
    default, which raises when there is none; the host only when the
    caller passes ``device="cpu"``.  With ``n_batches=1`` and
    ``preempt=False`` it replays the offline `Pipeline.run_batch` bit for
    bit.
    """
    t_start = time.perf_counter()
    dev = resolve_device(device)
    M = instance.num_coflows
    if lp_method not in ("batch", "exact"):
        raise ValueError(f"lp_method must be 'batch' or 'exact', {lp_method!r}")
    if epoch_mode not in EPOCH_MODES:
        raise ValueError(f"epoch_mode must be one of {EPOCH_MODES}, got {epoch_mode!r}")
    if epoch_mode == "auto":
        epoch_mode = "resident" if lp_method == "batch" else "rebuild"
    if epoch_mode == "resident" and lp_method == "exact":
        raise ValueError(
            "epoch_mode='resident' drives the batched subgradient solver off the "
            "resident slot pool; use lp_method='batch' (or epoch_mode='rebuild' for "
            "per-epoch exact LPs)"
        )
    if lp_iters_warm is None:
        lp_iters_warm = max(lp_iters // 3, 1)

    # The pipeline's own LP stage never solves (epoch LPs are solved here,
    # warm-started, and handed in as completions), so its lp_method is
    # immaterial.
    pipe = get_pipeline(
        scheme,
        discipline=discipline,
        lp_method="exact",
        lp_iters=lp_iters,
        circuit_backend="batch",
        circuit_engine=engine,
    )
    circuit = pipe.circuit_stage
    if not isinstance(circuit, ListCircuit) or circuit.backend != "batch":
        raise ValueError(
            f"stream() requires a batched list-circuit scheme; {scheme!r} uses "
            f"{type(circuit).__name__}"
        )
    order_stage = pipe.order_stage
    needs_lp = bool(getattr(order_stage, "needs_lp", False))

    S = M if pool_size is None else int(pool_size)
    result = StreamResult(
        scheme=scheme, discipline=discipline, lp_method=lp_method,
        preempt=preempt, warm_start=warm_start, pool_size=S,
        lp_iters=lp_iters, lp_iters_warm=lp_iters_warm,
        weights=np.asarray(instance.weights, dtype=np.float64).copy(),
        arrival=np.asarray(instance.releases, dtype=np.float64).copy(),
        admission=np.zeros(M), finish=np.zeros(M),
        epochs=[], lp_time_s=0.0, wall_time_s=0.0,
    )
    result.admission_policy = admission
    result.epoch_mode = epoch_mode
    if M == 0:
        result.wall_time_s = time.perf_counter() - t_start
        return result

    rates_by_core = np.asarray(instance.rates, dtype=np.float64)
    residual = np.asarray(instance.demands, dtype=np.float64).copy()
    pool = SlotPool(
        S,
        policy=admission,
        weights=result.weights,
        sizes=residual.reshape(M, -1).sum(axis=1),
    )
    resident = epoch_mode == "resident"
    warm = _WarmState(S, device=dev if resident else None)
    rpool = None
    slot_to_global = None
    if resident:
        # Size the arena so a full pool of average coflows fits without
        # growth; the geometric ladder covers estimate misses.
        nnz = int(np.count_nonzero(residual))
        expected = -(-nnz * min(S, M) // M)
        quantum = max(int(flow_quantum), 1)
        rpool = build_slot_pool_batch(
            S, instance.num_ports, rates_by_core, instance.delta,
            flow_quantum=_round_up(max(int(flow_quantum), expected, 1), quantum),
            device=dev,
        )
        slot_to_global = np.full(S, -1, dtype=np.int64)
    finished = np.zeros(M, dtype=bool)
    calendar = _Calendar.empty()
    busy = _Busy.empty()
    last_ccts = np.zeros(M)  # projected completion per active id
    two_pi_ports = 2 * instance.num_ports  # flat port axis for LP padding

    def _advance(now: float) -> np.ndarray:
        """Settle the incumbent calendar at `now`; free drained slots.

        Returns the global ids whose residual changed and who are still
        active (the slots the resident pool must rewrite)."""
        nonlocal calendar, busy
        dirty = np.zeros(0, dtype=np.int64)
        if calendar.m.size:
            delivered = calendar.comp <= now
            started = calendar.est < now
            if preempt:
                inflight = ~delivered & started
                sent = rates_by_core[calendar.k] * np.maximum(
                    0.0, now - calendar.est - instance.delta
                )
                full = inflight & (sent >= calendar.size)
                deliver = delivered | full  # complete within float rounding
                partial = inflight & ~full
            else:  # committed: in-flight runs to completion as a phantom
                deliver = delivered | started
                partial = np.zeros_like(deliver)
            # (m, i, j) rows are unique per calendar: no accumulation.
            residual[
                calendar.m[deliver], calendar.i[deliver], calendar.j[deliver]
            ] -= calendar.size[deliver]
            if partial.any():
                residual[
                    calendar.m[partial], calendar.i[partial], calendar.j[partial],
                ] -= sent[partial]
            np.maximum.at(result.finish, calendar.m[deliver], calendar.comp[deliver])
            dirty = np.unique(calendar.m[deliver | partial])
            busy = busy.keep_after(now)
            if not preempt:
                committed = ~delivered & started
                busy = busy.extend(
                    calendar.k[committed], calendar.i[committed],
                    calendar.j[committed], calendar.comp[committed],
                )
            # Rows with est >= now were never established: cancelled back
            # into the pool with their residual untouched.
            calendar = _Calendar.empty()
        else:
            busy = busy.keep_after(now)
        np.maximum(residual, 0.0, out=residual)  # exact-0 guard only
        act = pool.active_array()
        if act.size:
            drained = act[~residual[act].reshape(act.size, -1).any(axis=1)]
            if drained.size:
                finished[drained] = True
                slots = pool.release_many(drained)
                warm.forget_slots(slots)
                if resident:
                    free_slots(rpool, slots)
                    slot_to_global[slots] = -1
                dirty = np.setdiff1d(dirty, drained, assume_unique=True)
        return dirty

    def _admit(now: float) -> list[int]:
        """Move queued arrivals into free slots (ring order, policy)."""
        admitted_all = []
        while True:
            admitted = pool.admit_waiting()
            if not admitted:
                return admitted_all
            for m in admitted:
                result.admission[m] = now
                if residual[m].any():
                    admitted_all.append(m)
                else:  # degenerate zero-demand coflow: done on arrival
                    result.finish[m] = max(result.finish[m], now)
                    finished[m] = True
                    warm.forget(pool.release(m))

    def _epoch_instance(act: np.ndarray, releases: np.ndarray) -> CoflowInstance:
        return CoflowInstance(
            demands=residual[act].copy(),
            weights=result.weights[act].copy(),
            releases=releases,
            rates=rates_by_core.copy(),
            delta=instance.delta,
        )

    def _record(now, act, admitted, order_dense, alloc, ccts, lp_sol, is_warm,
                iters_used, lp_wall, busy_tabs, t_epoch, lp_objective, stage_s,
                slots_written=0) -> None:
        result.epochs.append(
            EpochRecord(
                index=len(result.epochs),
                time=now,
                actives=act,
                admitted=np.asarray(admitted, dtype=np.int64),
                order=act[order_dense],
                allocation=alloc,
                ccts=ccts.copy(),
                lp=lp_sol,
                warm=is_warm,
                lp_iters_used=iters_used,
                lp_wall_s=lp_wall,
                num_busy=0 if busy_tabs is None else int(busy.k.size),
                wall_s=time.perf_counter() - t_epoch,
                lp_objective=lp_objective,
                stage_s=stage_s,
                slots_written=slots_written,
            )
        )

    def _epoch_rebuild(now: float, admitted: list[int]) -> None:
        """Rebuild epoch: a dense residual instance, a fresh `EnsembleBatch`."""
        nonlocal calendar
        t_epoch = time.perf_counter()
        clock = _StageClock(t_epoch)
        actives = pool.active_ids()
        if not actives:
            return
        act = np.asarray(actives, dtype=np.int64)
        Me = act.shape[0]
        inst_e = _epoch_instance(act, np.maximum(result.arrival[act], now))

        lp_sol = None
        is_warm = False
        iters_used = 0
        lp_wall = 0.0
        if needs_lp:
            t_lp = time.perf_counter()
            if lp_method == "exact":
                lp_sol = lp.solve_exact(inst_e)
            else:
                arrays = lp.pack_lp_arrays(
                    [inst_e], pad_coflows=S, pad_ports=two_pi_ports, device=dev
                )
                slots = pool.slots_of(actives)
                if warm_start:
                    Y0, is_warm = warm.gather(
                        slots, arrays["Y0"][0, :Me, :Me].cpu().numpy()
                    )
                    arrays["Y0"][0, :Me, :Me] = torch.from_numpy(Y0).to(dev)
                iters_used = lp_iters_warm if is_warm else lp_iters
                batch = lp.solve_subgradient_batch_arrays(arrays, iters=iters_used)
                lp_sol = batch.unpack([Me])[0]
                warm.scatter(slots, lp_sol.precedence)
            lp_wall = time.perf_counter() - t_lp
            result.lp_time_s += lp_wall
        clock.lap("lp")

        ensemble = build_ensemble_batch([inst_e], dev, with_lp_arrays=False)
        clock.lap("build")
        if needs_lp:
            comp = np.zeros(tuple(ensemble.weights.shape))
            comp[0, :Me] = lp_sol.completion
            orders_arr = order_stage.order_batch(ensemble, torch.from_numpy(comp).to(dev))
        else:
            orders_arr = order_stage.order_batch(ensemble)
        clock.lap("order")
        alloc_batch = pipe.allocate_stage.allocate_batch_arrays(ensemble, orders_arr)
        clock.lap("allocation")
        busy_tabs = busy.tables(now, instance.num_cores)
        ((schedules, ccts_e),) = schedule_batch_arrays(
            ensemble, alloc_batch,
            discipline=circuit.discipline, engine=circuit.engine, busy=busy_tabs,
        )
        clock.lap("calendar")
        if validate:
            validate_schedule(inst_e, schedules)

        calendar = _Calendar.from_schedules(schedules, act)
        ccts_e = np.asarray(ccts_e, dtype=np.float64)
        last_ccts[act] = ccts_e
        _record(
            now, act, admitted, orders_arr[0, :Me].cpu().numpy(),
            alloc_batch.materialize(ensemble)[0], ccts_e, lp_sol, is_warm,
            iters_used, lp_wall, busy_tabs, t_epoch,
            float(lp_sol.objective) if lp_sol is not None else None, clock.seconds,
        )

    def _epoch_resident(now: float, admitted: list[int], dirty: np.ndarray) -> None:
        """Resident epoch: write into the slot pool, solve at fixed padded
        shapes on the device, read the calendar back in slot space."""
        nonlocal calendar
        t_epoch = time.perf_counter()
        clock = _StageClock(t_epoch)
        actives = pool.active_ids()
        if not actives:
            return
        act = np.asarray(actives, dtype=np.int64)
        Me = act.shape[0]
        slots = pool.slots_of(actives)  # aligned with ascending-id order
        rel_clamped = np.maximum(result.arrival[act], now)

        # In-place slot writes: residuals that changed since the last epoch
        # (settled or preempted) plus fresh admissions; every active slot
        # gets the epoch's release clamp.
        upd = np.union1d(np.asarray(admitted, dtype=np.int64), dirty)
        if upd.size:
            upd_slots = pool.slots_of(upd)
            update_slots(
                rpool, upd_slots, residual[upd], result.weights[upd],
                np.maximum(result.arrival[upd], now),
            )
            slot_to_global[upd_slots] = upd
        set_slot_releases(rpool, slots, rel_clamped)
        b = rpool.batch
        st = torch.from_numpy(slots).to(dev)
        mask = torch.zeros((1, S), dtype=torch.bool, device=dev)
        mask[0, :Me] = True
        clock.lap("slots")

        def dense(a: torch.Tensor) -> torch.Tensor:
            """Member 0's slot rows gathered to dense positions 0..Me-1,
            zero beyond (the rebuild mode's padded layout)."""
            out = torch.zeros_like(a)
            out[0, :Me] = a[0, st]
            return out

        lp_objective = None
        is_warm = False
        iters_used = 0
        lp_wall = 0.0
        comp = None
        if needs_lp:
            t_lp = time.perf_counter()
            # The gathered inputs equal `pack_lp_arrays([inst_e],
            # pad_coflows=S, pad_ports=2N)`'s: the f32 rows were cast from
            # the same f64 values when the slots were written.
            Y0 = torch.zeros((S, S), dtype=torch.float32, device=dev)
            Y0[:Me, :Me] = lp.warm_start_Y0_dense(b.weights[0, st], b.glb[0, st])
            slots_padded = torch.full((S,), S, dtype=torch.int64, device=dev)
            slots_padded[:Me] = st
            if warm_start:
                Y0, is_warm = warm.gather_device(slots_padded, Y0)
            arrays = dict(
                Y0=Y0[None], p_rho=dense(b.lp_rho), p_tau=dense(b.lp_tau),
                weights=dense(b.lp_weights), releases=dense(b.lp_releases),
                inv_R=b.inv_R, delta_over_K=b.delta_over_K,
                coflow_mask=mask, port_mask=b.port_mask,
            )
            iters_used = lp_iters_warm if is_warm else lp_iters
            sol = lp.solve_subgradient_batch_arrays(arrays, iters=iters_used)
            comp = torch.where(mask, sol.completion.to(torch.float64), 0.0)
            lp_objective = float(sol.objective[0])
            warm.scatter_device(slots_padded, slots, sol.y[0])
            lp_wall = time.perf_counter() - t_lp
            result.lp_time_s += lp_wall
        clock.lap("lp")

        # Dense order view over the resident vectors, gathered on the
        # device to the ascending-global-id convention with the padding
        # masked at the tail: the rebuild mode's keys, masks and sort.
        view = order_view(dense(b.weights), dense(b.glb), dense(b.releases), mask)
        orders = order_stage.order_batch(view, comp) if needs_lp else order_stage.order_batch(view)
        order_dense = orders[0, :Me].cpu().numpy()
        clock.lap("order")

        # Slot-space order: active slots by dense priority, free slots at the
        # tail (their flows are invalid: exact no-op scan steps).
        order_slots = np.empty(S, dtype=np.int64)
        order_slots[:Me] = slots[order_dense]
        order_slots[Me:] = np.setdiff1d(np.arange(S, dtype=np.int64), slots, assume_unique=True)
        alloc_batch = pipe.allocate_stage.allocate_batch_arrays(
            b, torch.from_numpy(order_slots[None, :]).to(dev)
        )
        clock.lap("allocation")
        busy_tabs = busy.tables(now, instance.num_cores)
        ((schedules, ccts_slot),) = schedule_batch_arrays(
            b, alloc_batch,
            discipline=circuit.discipline, engine=circuit.engine, busy=busy_tabs,
        )
        clock.lap("calendar")
        ccts_dense = np.asarray(ccts_slot, dtype=np.float64)[slots]
        if validate:
            dense_of_slot = np.full(S, -1, dtype=np.int64)
            dense_of_slot[slots] = np.arange(Me, dtype=np.int64)
            validate_schedule(
                _epoch_instance(act, rel_clamped),
                [dataclasses.replace(cs, coflow=dense_of_slot[cs.coflow]) for cs in schedules],
            )

        calendar = _Calendar.from_schedules(schedules, slot_to_global)
        last_ccts[act] = ccts_dense
        _record(
            now, act, admitted, order_dense, None, ccts_dense, None, is_warm,
            iters_used, lp_wall, busy_tabs, t_epoch, lp_objective, clock.seconds,
            slots_written=int(upd.size),
        )

    def _epoch(now: float, admitted: list[int], dirty: np.ndarray) -> None:
        if resident:
            _epoch_resident(now, admitted, dirty)
        else:
            _epoch_rebuild(now, admitted)

    # --- event loop -------------------------------------------------------
    for now, ids in _arrival_batches(result.arrival, n_batches, batch_window):
        dirty = _advance(now)
        pool.push(ids)
        admitted = _admit(now)
        _epoch(now, admitted, dirty)

    while pool.queue:  # pool-bound overflow: admit as slots drain
        act = pool.active_array()
        if act.size == 0:
            raise RuntimeError("admission queue stuck with an empty pool")
        now = float(last_ccts[act].min())
        dirty = _advance(now)
        admitted = _admit(now)
        if not admitted:
            raise RuntimeError("drain epoch freed no slot -- non-increasing calendar?")
        _epoch(now, admitted, dirty)

    # The final calendar runs to completion undisturbed.
    if calendar.m.size:
        residual[calendar.m, calendar.i, calendar.j] -= calendar.size
        np.maximum.at(result.finish, calendar.m, calendar.comp)
        calendar = _Calendar.empty()
    np.maximum(residual, 0.0, out=residual)
    act = pool.active_array()
    for m in act:
        if residual[m].any():
            raise RuntimeError(f"coflow {m} left {residual[m].sum():g} undelivered demand")
    if act.size:
        finished[act] = True
        slots = pool.release_many(act)
        warm.forget_slots(slots)
        if resident:
            free_slots(rpool, slots)
            slot_to_global[slots] = -1
    if not finished.all():
        missing = np.nonzero(~finished)[0]
        raise RuntimeError(f"coflows never completed: {missing.tolist()}")

    result.wall_time_s = time.perf_counter() - t_start
    return result
