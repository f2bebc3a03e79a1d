"""Ensemble-batched intra-core circuit scheduling (Alg. 1 Lines 16-30).

Port of the reference's three calendar executors
(`repro.pipeline.batch_circuit`), selected by ``engine=``.  Two run the
event calendar for the whole flattened (instance x core) member axis at
once, on the device, one resolution round at a time:

  * ``"kernel"`` -- the pair-space calendar.  Flows of one
    (ingress, egress) pair share both ports and execute sequentially, so
    only each pair's head (its first waiting flow) can claim or start.
    Every round recomputes the heads statelessly as an exclusive
    segment-min of waiting flow ids over the pair-sorted flow axis (an
    int32 `cummin` with descending per-segment offsets, `_port_segments`
    on the host), reduces the (G, N, N) claim matrix with the
    `pair_resolve` kernel (idle & row-first & column-first), and frees
    ports through row/column maxima.
  * ``"jax"`` -- the flow-space calendar (the reference's `_run_calendar`).
    Every round hands the (G, F) flows to the `event_resolve` kernel,
    which finds each port's first claimer (an `atomicMin` per port, in
    place of the reference's presorted `cummin`) and the idle flows that
    are first on both their ports; ports free through (G, N) gathers of
    their first claimers.

Both then write establish/complete times and advance each member's clock
to its next event unless another round at the same instant is possible.
Under reserving the two engines advance on the same condition (a
zero-duration start) and run the same rounds.  Under greedy the flow
engine also holds the clock for an idle later flow of a pair whose head
just started, so it may run more rounds; the schedule is the same.

The third, ``"wide"``, is the reference's host NumPy pair engine
(`_run_calendar_wide`): lockstep over the members, with per-pair head
pointers that rewind when a release lands before them.  It launches no
kernel and ignores the ensemble's device.  ``"auto"`` resolves from the
device the ensemble lives on (`resolve_engine`): ``"kernel"`` on a card,
``"wide"`` on the host, unless ``REPRO_CIRCUIT_ENGINE`` names an engine.

The JAX package runs the device rounds in a ``lax.while_loop``; here a
Python loop runs them, testing on the host every `_CHECK_EVERY` rounds
whether any member still has pending, unstalled flows, and never passing
`event_bound` rounds.  That is exact because a round in which a member has
nothing waiting changes none of its state: nothing starts or frees, and
its clock and stall flag are left alone.  All times are f64 and every
per-round operation is a selection, a min/max or ``t + dur`` with ``dur``
computed exactly as the oracle's ``delta + size / rate``, so establish and
complete times are bit-identical to `repro.core.circuit.schedule_core` on
both disciplines, under every engine.

The member tables (partition, padding and segment metadata) are built on
the host in NumPy: they are static per call.  `cct_batch_arrays` is the
lean form refinement evaluates through: the same calendar, only the CCTs.

Under a sharded ensemble (``ensemble.sharding``) the card engines round the
calendar's (instance x core) member axis up to the shard count and run one
calendar a shard on its device, the shards' runs of rounds issued in turns
(`repro_torch.launch.mesh.drive`).  A calendar member's rounds depend on
that member alone, so its times are the unsharded run's bit for bit; each
shard stops when its own members are done.  ``"wide"`` is host NumPy and
ignores the sharding.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.allocation import Allocation
from repro_torch.core.circuit import NOT_SCHEDULED, CoreSchedule
from repro_torch.core.coflow import CoflowInstance
from repro_torch.core.scheduler import _flow_priorities
from repro_torch.core.validate import ccts_from_schedules
from repro_torch.kernels.event_resolve import event_resolve
from repro_torch.kernels.pair_resolve import pair_resolve
from repro_torch.launch.mesh import NamedSharding, drive
from repro_torch.pipeline.ensemble_batch import AllocationBatch, EnsembleBatch

__all__ = [
    "schedule_batch", "schedule_batch_arrays", "cct_batch_arrays", "member_tables", "event_bound",
    "resolve_engine", "ENGINES", "ROUNDS",
]

# Bucket quanta of the reference: flows, ports and members round up.
_F_QUANTUM = 16
_N_QUANTUM = 4
_G_QUANTUM = 8

#: Rounds between host checks for live members.
_CHECK_EVERY = 16

#: Calendar executors: pair space on `pair_resolve`, flow space on
#: `event_resolve`, and the host NumPy pair engine (plus ``"auto"``).
ENGINES = ("kernel", "jax", "wide")

#: Calendar rounds run so far by each device engine; every round calls its
#: kernel's wrapper (`pair_resolve` or `event_resolve`) once.
ROUNDS = dict.fromkeys(("kernel", "jax"), 0)


def event_bound(num_flows: int) -> int:
    """Round bound of the padded event calendar: at most F rounds start
    flows, and every other round moves the clock to one of <= 2F distinct
    release or port-free values."""
    return 3 * num_flows + 4


def _round_up(n: int, q: int) -> int:
    return -(-max(n, 1) // q) * q


def member_tables(
    instance: CoflowInstance, alloc: Allocation, order: np.ndarray
) -> list[dict]:
    """Per-core flow tables of one instance, in scheduling priority order:
    the (F_k,) arrays `schedule_core` would sort internally plus the
    derived ``rel`` and ``dur`` vectors."""
    M, K = instance.num_coflows, instance.num_cores
    prio = _flow_priorities(alloc, order, M)
    out = []
    for k in range(K):
        sel = alloc.core == k
        o = np.argsort(prio[sel], kind="stable")
        coflow = alloc.coflow[sel][o]
        size = alloc.size[sel][o]
        rate = float(instance.rates[k])
        out.append(
            dict(
                coflow=coflow,
                src=alloc.src[sel][o],
                dst=alloc.dst[sel][o],
                size=size,
                rel=instance.releases[coflow],
                dur=instance.delta + size / rate,
                rate=rate,
            )
        )
    return out


def _port_segments(keys: np.ndarray, n_pad: int):
    """Sort metadata for the exclusive segment-min over one key axis.

    ``keys`` (G, Fmax) holds each flow's segment key (``n_pad`` for padded
    flows).  Returns ``perm`` (G, Fmax) -- stable sort of flows by key;
    ``offs`` (G, Fmax) -- per-sorted-position offsets
    ``(n_pad - key) * (Fmax + 1)``, strictly decreasing across segments so
    a running `cummin` never leaks across a boundary; ``segend`` /
    ``segempty`` (G, n_pad) -- the last sorted position of each segment
    (clamped) and whether it is empty.
    """
    G, F = keys.shape
    perm = np.argsort(keys, axis=1, kind="stable")
    sorted_keys = np.take_along_axis(keys, perm, axis=1)
    offs = ((n_pad - sorted_keys) * (F + 1)).astype(np.int32)
    ports = np.arange(n_pad)
    segend = np.empty((G, n_pad), dtype=np.int64)
    segempty = np.empty((G, n_pad), dtype=bool)
    for g in range(G):
        right = np.searchsorted(sorted_keys[g], ports, side="right")
        left = np.searchsorted(sorted_keys[g], ports, side="left")
        segempty[g] = left == right
        segend[g] = np.clip(right - 1, 0, F - 1)
    return perm, offs, segend, segempty


def _pad_members(tabs: Sequence[dict], num_ports_max: int, g_multiple: int = 1) -> dict:
    """Pad per-member flow tables (each with F_k > 0) into one
    (G, Fmax) / (G, Nmax) bucket, G also a multiple of ``g_multiple`` (a
    shard count); padded flows and members never pend."""
    G = _round_up(_round_up(len(tabs), _G_QUANTUM), g_multiple)
    Fmax = _round_up(max(t["src"].shape[0] for t in tabs), _F_QUANTUM)
    Nmax = _round_up(num_ports_max, _N_QUANTUM)
    src = np.zeros((G, Fmax), dtype=np.int64)
    dst = np.zeros((G, Fmax), dtype=np.int64)
    rel = np.zeros((G, Fmax), dtype=np.float64)
    dur = np.zeros((G, Fmax), dtype=np.float64)
    pending = np.zeros((G, Fmax), dtype=bool)
    for g, tab in enumerate(tabs):
        F = tab["src"].shape[0]
        src[g, :F] = tab["src"]
        dst[g, :F] = tab["dst"]
        rel[g, :F] = tab["rel"]
        dur[g, :F] = tab["dur"]
        pending[g, :F] = True
    return dict(
        src=src, dst=dst, rel=rel, dur=dur, pending=pending,
        G=G, Fmax=Fmax, Nmax=Nmax,
    )


class _Calendar:
    """Padded event calendar of one bucket, as device tensors.

    The static tables are fields; `state` holds the carried arrays
    (free_in, free_out, establish, complete, pending, t, stalled), and a
    subclass's `round` advances it by one resolution round of its engine:
    `_PairCalendar` in pair space through `pair_resolve`, `_FlowCalendar`
    in flow space through `event_resolve`.
    """

    engine = ""

    def __init__(self, pad: dict, reserving: bool, device: torch.device):
        G, F, N = pad["G"], pad["Fmax"], pad["Nmax"]
        self.G, self.F, self.N = G, F, N
        self.reserving = reserving
        self.src, self.dst, self.rel, self.dur, pending = (
            self._dev(pad[k], device) for k in ("src", "dst", "rel", "dur", "pending")
        )
        f64 = dict(dtype=torch.float64, device=device)
        self.state = dict(
            free_in=torch.zeros((G, N), **f64),
            free_out=torch.zeros((G, N), **f64),
            est=torch.full((G, F), NOT_SCHEDULED, **f64),
            comp=torch.full((G, F), NOT_SCHEDULED, **f64),
            pending=pending,
            t=torch.where(pending, self.rel, torch.inf).amin(dim=1),
            stalled=torch.zeros(G, dtype=torch.bool, device=device),
        )

    @staticmethod
    def _dev(a: np.ndarray, device: torch.device) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    def live(self) -> bool:
        """Whether any member has a pending flow and is not stalled."""
        s = self.state
        return bool((s["pending"] & ~s["stalled"][:, None]).any())

    def round(self) -> None:
        """One resolution round."""
        raise NotImplementedError

    def _advance(self, advance, pending, free_in, free_out) -> None:
        """Store the round's ports and pending flows; move each advancing,
        unstalled member's clock to its next event, or mark it stalled if
        it has pending flows and none can ever start."""
        s = self.state
        t, stalled = s["t"], s["stalled"]
        times = torch.where(
            pending,
            torch.maximum(
                self.rel,
                torch.maximum(
                    torch.gather(free_in, 1, self.src),
                    torch.gather(free_out, 1, self.dst),
                ),
            ),
            torch.inf,
        )
        t_next = torch.where(times > t[:, None], times, torch.inf).amin(dim=1)
        alive = pending.any(dim=1)
        stall = advance & alive & torch.isinf(t_next) & ~stalled
        s["t"] = torch.where(advance & torch.isfinite(t_next) & ~stalled, t_next, t)
        s["free_in"], s["free_out"] = free_in, free_out
        s["pending"], s["stalled"] = pending, stalled | stall

    def steps(self, check_every: int = _CHECK_EVERY):
        """Rounds until no member is live, never past `event_bound`: a
        generator that yields after each run of ``check_every`` rounds."""
        bound = event_bound(self.F)
        it = 0
        while it < bound and self.live():
            n = min(check_every, bound - it)
            for _ in range(n):
                self.round()
            it += n
            ROUNDS[self.engine] += n
            yield

    def run(self, check_every: int = _CHECK_EVERY) -> None:
        """`steps` run to their end."""
        drive([self.steps(check_every)])


class _PairCalendar(_Calendar):
    """The ``"kernel"`` engine: rounds in pair space on `pair_resolve`."""

    engine = "kernel"

    def __init__(self, pad: dict, reserving: bool, device: torch.device):
        super().__init__(pad, reserving, device)
        F, N = self.F, self.N
        P = self.P = N * N
        if (P + 1) * (F + 1) >= 2**31:
            raise ValueError(
                f"calendar bucket too large for int32 segment keys "
                f"(Fmax={F}, Nmax={N})"
            )
        # Pair-sorted segment metadata.
        pairkey = np.where(pad["pending"], pad["src"] * N + pad["dst"], P)
        pperm, poffs, psend, psempty = _port_segments(pairkey, P)
        self.pperm = self._dev(pperm, device)
        self.pperm32 = self._dev(pperm.astype(np.int32), device)
        self.poffs = self._dev(poffs, device)
        self.psend, self.psempty = self._dev(psend, device), self._dev(psempty, device)
        self.pairc = self._dev(np.clip(pairkey, 0, P - 1), device)
        self.ar = torch.arange(F, dtype=torch.int32, device=device)
        arp = torch.arange(P, dtype=torch.int32, device=device)
        self.pair_off = (P - arp) * (F + 1)
        self.PI = (arp // N).long()  # static pair -> ingress port
        self.PJ = (arp % N).long()  # static pair -> egress port

    def round(self) -> None:
        """One claim -> `pair_resolve` -> start -> advance round over pairs."""
        s = self.state
        G, F, N, P = self.G, self.F, self.N, self.P
        free_in, free_out = s["free_in"], s["free_out"]
        pending, t, stalled = s["pending"], s["t"], s["stalled"]
        t_ = t[:, None]
        waiting = pending & (self.rel <= t_) & ~stalled[:, None]
        # Pair heads: exclusive segment-min of waiting flow ids over the
        # pair-sorted flow axis.
        w = torch.where(
            torch.gather(waiting, 1, self.pperm), self.pperm32, F
        ) + self.poffs
        cm = torch.cummin(w, dim=1).values
        cand = torch.where(
            self.psempty, F, torch.gather(cm, 1, self.psend) - self.pair_off
        )
        candc = torch.clamp(cand, 0, F - 1).long()
        has = cand < F
        idle = (
            has
            & (free_in[:, self.PI] <= t_)
            & (free_out[:, self.PJ] <= t_)
        )
        claim = has if self.reserving else idle
        claim_ids = torch.where(claim, cand, F)
        startp = pair_resolve(
            claim_ids.view(G, N, N), idle.view(G, N, N)
        ).view(G, P)
        # Back to flow space: a flow starts iff its pair started and it is
        # that pair's head this round.
        sflow = torch.gather(startp, 1, self.pairc) & (
            torch.gather(cand, 1, self.pairc) == self.ar
        )
        s["est"] = torch.where(sflow, t_, s["est"])
        s["comp"] = torch.where(sflow, t_ + self.dur, s["comp"])
        pending = pending & ~sflow
        # Port frees via row/column maxima: at most one pair per row and
        # column starts, so the max picks its completion.
        dur_p = torch.gather(self.dur, 1, candc)
        ev = torch.where(startp, t_ + dur_p, -torch.inf).view(G, N, N)
        sm = startp.view(G, N, N)
        free_in = torch.where(sm.any(dim=2), ev.amax(dim=2), free_in)
        free_out = torch.where(sm.any(dim=1), ev.amax(dim=1), free_out)
        # Advance unless another round at this t is possible: a
        # zero-duration start chains its pair's next flow, and (greedy) an
        # idle-but-blocked pair may start once its blocker started.
        more = (startp & (dur_p == 0.0)).any(dim=1)
        if not self.reserving:
            more = more | (idle & ~startp).any(dim=1)
        self._advance(~more, pending, free_in, free_out)


class _FlowCalendar(_Calendar):
    """The ``"jax"`` engine: rounds in flow space on `event_resolve`."""

    engine = "jax"

    def __init__(self, pad: dict, reserving: bool, device: torch.device):
        super().__init__(pad, reserving, device)
        self.src32 = self.src.to(torch.int32)
        self.dst32 = self.dst.to(torch.int32)
        self.zero_dur = self.dur == 0.0

    def flow_args(self) -> tuple:
        """The `event_resolve` operands of the current state; a stalled
        member pends nothing."""
        s = self.state
        return (
            self.src32, self.dst32, self.rel, s["free_in"], s["free_out"],
            s["pending"] & ~s["stalled"][:, None], s["t"],
        )

    def round(self) -> None:
        """One `event_resolve` -> start -> free -> advance round over flows."""
        s = self.state
        F = self.F
        t_ = s["t"][:, None]
        start, first_in, first_out, blocked = event_resolve(
            *self.flow_args(), "reserving" if self.reserving else "greedy"
        )
        s["est"] = torch.where(start, t_, s["est"])
        s["comp"] = torch.where(start, t_ + self.dur, s["comp"])

        # Only a port's first claimer can have started; if it did, the port
        # frees at that flow's completion: (G, N) gathers, no scatter.
        def freed(first, free):
            fc = torch.clamp(first, 0, F - 1).long()
            hit = (first < F) & torch.gather(start, 1, fc)
            return torch.where(hit, t_ + torch.gather(self.dur, 1, fc), free)

        # Advance unless another round at this t is possible: a
        # zero-duration start chains its port's next waiting flow, and
        # (greedy) an idle flow that did not start may start once its
        # blocker started.
        if self.reserving:
            more = (start & self.zero_dur).any(dim=1)
        else:
            more = blocked
        self._advance(
            ~more, s["pending"] & ~start,
            freed(first_in, s["free_in"]), freed(first_out, s["free_out"]),
        )


#: Calendar class of each device engine.
_CALENDARS = {c.engine: c for c in (_PairCalendar, _FlowCalendar)}


def _run_calendar_wide(
    src, dst, rel, dur, valid, num_ports, reserving, bound, labels=None
):
    """The ``"wide"`` engine: the padded event calendar, lockstep in host
    NumPy (the reference's `_run_calendar_wide`).

    The same round/advance semantics as the device engines, around
    per-(ingress, egress)-pair head pointers: one round evaluates the
    (G, N, N) candidate matrix (row/column minima reproduce
    `resolve_event`'s first claimer per port), heads advance past started
    and not-yet-released flows and rewind when a release lands before
    them.  The clock may also stop at release instants whose flows then
    turn out blocked -- no-op rounds -- so ``bound`` carries one extra F of
    slack over `event_bound`.  Members drop out of the batch as they
    finish.  The same f64 selections as `schedule_core`: bit-exact.
    """
    G, F = src.shape
    N = int(num_ports)
    P = N * N
    NOT = NOT_SCHEDULED
    out_est = np.full((G, F), NOT)
    out_comp = np.full((G, F), NOT)
    if G == 0 or F == 0:
        return out_est, out_comp

    pairid = np.where(valid, src.astype(np.int64) * N + dst, P)
    psort = np.argsort(pairid, axis=1, kind="stable")
    keys = np.take_along_axis(pairid, psort, 1)
    pos = np.empty((G, F), dtype=np.int64)
    np.put_along_axis(pos, psort, np.broadcast_to(np.arange(F), (G, F)), 1)
    pairstart = np.empty((G, P), dtype=np.int64)
    pairend = np.empty((G, P), dtype=np.int64)
    ports = np.arange(P)
    for g in range(G):
        pairstart[g] = np.searchsorted(keys[g], ports, side="left")
        pairend[g] = np.searchsorted(keys[g], ports, side="right")
    # Release calendar per member: flows grouped by release instant; the
    # t0 group needs no rewind (heads start at the segment fronts).
    groups: list[list] = []
    t0 = np.empty(G)
    for g in range(G):
        fids = np.nonzero(valid[g])[0]
        if fids.size == 0:  # quantum-padded member: drops out at entry
            groups.append([])
            t0[g] = np.inf
            continue
        o = np.argsort(rel[g, fids], kind="stable")
        fs = fids[o]
        uniq, starts = np.unique(rel[g, fs], return_index=True)
        bounds = list(starts) + [fs.size]
        groups.append(
            [(uniq[i], fs[bounds[i]:bounds[i + 1]]) for i in range(len(uniq))]
        )
        t0[g] = uniq[0]
    ptr = np.ones(G, dtype=np.int64)
    next_rel = np.array([g[1][0] if len(g) > 1 else np.inf for g in groups])

    PI = ports // N  # static pair -> ingress port
    PJ = ports % N  # static pair -> egress port
    h = pairstart.copy()
    free_in = np.zeros((G, N))
    free_out = np.zeros((G, N))
    est = np.full((G, F), NOT)
    comp = np.full((G, F), NOT)
    pending = valid.copy()
    remaining = valid.sum(1)
    t = t0
    orig = np.arange(G)
    it = 0

    def keep(mask, arrays):
        return tuple(a[mask] for a in arrays)

    live = remaining > 0
    if not live.all():
        (orig, h, pairstart, pairend, psort, pos, pairid, rel, dur, pending,
         est, comp, free_in, free_out, remaining, t, ptr, next_rel) = keep(
            live, (orig, h, pairstart, pairend, psort, pos, pairid, rel, dur,
                   pending, est, comp, free_in, free_out, remaining, t, ptr,
                   next_rel))
        groups = [grp for g, grp in enumerate(groups) if live[g]]

    while orig.size:
        it += 1
        if it > bound:  # pragma: no cover - bound is provably large
            who = ", ".join(
                labels[g] if labels and g < len(labels) else f"member {g}"
                for g in sorted(set(orig.tolist()))
            )
            raise RuntimeError(f"batched scheduler exceeded the event bound ({who})")
        Ga = orig.size
        t_ = t[:, None]
        base = (np.arange(Ga) * F)[:, None]
        # Head maintenance: skip started and not-yet-released flows (a
        # release rewind restores the latter when their instant arrives).
        while True:
            hv = h < pairend
            hc = np.minimum(h, F - 1)
            c = psort.ravel()[hc + base]
            cf = c + base
            pend_c = pending.ravel()[cf]
            rel_c = rel.ravel()[cf]
            skip = hv & (~pend_c | (rel_c > t_))
            if not skip.any():
                break
            h = h + skip
        waitc = hv & (rel_c <= t_)
        FI = free_in[:, PI]
        FO = free_out[:, PJ]
        idlec = waitc & (FI <= t_) & (FO <= t_)
        claim = waitc if reserving else idlec
        # resolve_event in pair space: claimed head ids, first claimer per
        # ingress (row min) and egress (column min).
        cl = np.where(claim, c, F)
        clm = cl.reshape(Ga, N, N)
        rowfirst = clm.min(2)
        colfirst = clm.min(1)
        start = idlec & (cl == rowfirst[:, PI]) & (cl == colfirst[:, PJ])

        dur_c = dur.ravel()[cf]
        end_c = t_ + dur_c
        sm = start.reshape(Ga, N, N)
        ev = np.where(start, end_c, -np.inf).reshape(Ga, N, N)
        free_in = np.where(sm.any(2), ev.max(2), free_in)
        free_out = np.where(sm.any(1), ev.max(1), free_out)
        gs, ps = np.nonzero(start)
        if gs.size:
            fstart = c[gs, ps]
            est[gs, fstart] = t[gs]
            comp[gs, fstart] = end_c[gs, ps]
            pending[gs, fstart] = False
            h[gs, ps] += 1
            remaining -= np.bincount(gs, minlength=Ga)
        # Another round at this instant is possible only if an idle
        # candidate was left blocked (greedy backfill) or a zero-duration
        # start chained its pair's next flow at the same t.
        chained = (start & (dur_c == 0.0)).any(1)
        more = chained if reserving else chained | (idlec & ~start).any(1)
        # Next event per pair: its ports' post-round free times (the new
        # head's own release, if later, surfaces as a release stop).
        hv2 = h < pairend
        pt = np.where(hv2, np.maximum(free_in[:, PI], free_out[:, PJ]), np.inf)
        times = np.where(pt > t_, pt, np.inf).min(1)
        tn = np.minimum(times, np.where(next_rel > t, next_rel, np.inf))
        adv = ~more
        alive = remaining > 0
        stall = adv & alive & ~np.isfinite(tn)
        if stall.any():
            bad = int(orig[stall][0])
            who = labels[bad] if labels and bad < len(labels) else f"member {bad}"
            raise RuntimeError(f"batched scheduler stalled ({who})")
        t = np.where(adv & alive, tn, t)
        # Release crossings: rewind heads of pairs whose newly released
        # flows land before the current head.
        for gi in np.nonzero(adv & alive & (next_rel <= t))[0]:
            grp = groups[gi]
            while ptr[gi] < len(grp) and grp[ptr[gi]][0] <= t[gi]:
                _, flows = grp[ptr[gi]]
                np.minimum.at(h[gi], pairid[gi, flows], pos[gi, flows])
                ptr[gi] += 1
            next_rel[gi] = grp[ptr[gi]][0] if ptr[gi] < len(grp) else np.inf
        # Finished members no-op harmlessly inside the lockstep batch, so
        # compact (array copies) only once enough of them accumulate.
        ndone = Ga - int(alive.sum())
        if ndone and (4 * ndone >= Ga or ndone == Ga):
            done = ~alive
            out_est[orig[done]] = est[done]
            out_comp[orig[done]] = comp[done]
            (orig, h, pairstart, pairend, psort, pos, pairid, rel, dur, pending,
             est, comp, free_in, free_out, remaining, t, ptr, next_rel) = keep(
                alive, (orig, h, pairstart, pairend, psort, pos, pairid, rel,
                        dur, pending, est, comp, free_in, free_out, remaining,
                        t, ptr, next_rel))
            groups = [grp for g, grp in enumerate(groups) if alive[g]]
    return out_est, out_comp


def resolve_engine(engine: str, device: str | torch.device) -> str:
    """The calendar executor that ``engine`` names for data on ``device``.

    ``"auto"`` resolves as the reference's `_check_engine` does, with the
    device standing in for its backend: a non-empty
    ``REPRO_CIRCUIT_ENGINE`` names the engine (it overrides ``"auto"``
    only, never an explicit engine), otherwise ``"kernel"`` on a CUDA
    device and ``"wide"`` on the host.  An unknown name raises.
    """
    if engine not in ("auto",) + ENGINES:
        raise ValueError(
            f"unknown circuit engine {engine!r}; expected 'auto' or one of "
            f"{', '.join(ENGINES)}"
        )
    if engine != "auto":
        return engine
    env = os.environ.get("REPRO_CIRCUIT_ENGINE", "").strip().lower()
    if env:
        if env not in ENGINES:
            raise ValueError(
                f"unknown circuit engine {env!r} (from REPRO_CIRCUIT_ENGINE; "
                f"expected one of {', '.join(ENGINES)})"
            )
        return env
    return "kernel" if torch.device(device).type == "cuda" else "wide"


def _execute_members(
    tabs: Sequence[dict],
    num_ports_max: int,
    discipline: str,
    device: torch.device,
    labels: Sequence[str],
    engine: str = "kernel",
    check_every: int = _CHECK_EVERY,
    sharding: NamedSharding | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Pad member tables and run the ``engine`` calendar (on ``device``,
    or on the host for ``"wide"``); return the (G, Fmax) establish /
    complete arrays on the host.  Under ``sharding`` the card engines
    round G up to the shard count and run a calendar a shard, each on its
    device."""
    if discipline not in ("reserving", "greedy"):
        raise ValueError(f"unknown discipline {discipline!r}")
    engine = resolve_engine(engine, device)
    if engine == "wide":
        sharding = None
    g_multiple = 1 if sharding is None else sharding.num_shards
    pad = _pad_members(tabs, num_ports_max, g_multiple)
    reserving = discipline == "reserving"
    if engine == "wide":
        return _run_calendar_wide(
            pad["src"], pad["dst"], pad["rel"], pad["dur"], pad["pending"],
            pad["Nmax"], reserving, bound=event_bound(pad["Fmax"]) + pad["Fmax"],
            labels=list(labels),
        )
    if sharding is None:
        cals = [_CALENDARS[engine](pad, reserving, device)]
    else:
        rows = pad["G"] // g_multiple
        cals = [
            _CALENDARS[engine](_pad_rows(pad, i * rows, (i + 1) * rows), reserving, dev)
            for i, dev in enumerate(sharding.devices())
        ]
    drive([cal.steps(check_every) for cal in cals])

    def host(key: str) -> np.ndarray:
        return np.concatenate([cal.state[key].cpu().numpy() for cal in cals])

    unfinished = np.concatenate([c.state["pending"].any(dim=1).cpu().numpy() for c in cals])
    stalled = host("stalled")
    for g, label in enumerate(labels):
        if stalled[g]:
            raise RuntimeError(f"batched scheduler stalled ({label})")
        if unfinished[g]:
            raise RuntimeError(
                f"batched scheduler exceeded the event bound ({label})"
            )
    return host("est"), host("comp")


def _pad_rows(pad: dict, lo: int, hi: int) -> dict:
    """Rows ``[lo, hi)`` of a padded bucket: one shard's calendar."""
    out = {k: pad[k][lo:hi] for k in ("src", "dst", "rel", "dur", "pending")}
    return dict(out, G=hi - lo, Fmax=pad["Fmax"], Nmax=pad["Nmax"])


def _run_members(
    ensemble: EnsembleBatch,
    alloc: AllocationBatch,
    discipline: str,
    engine: str,
    busy: dict | None = None,
):
    """The calendar over every (instance, core) member with flows.

    ``busy`` (see `schedule_batch_arrays`) puts each member's phantom rows
    at the head of its table.  Returns the host copies of ``alloc``'s flow
    fields, the per-core rates and deltas, the ``(b, k, flow rows, phantom
    count)`` members and the calendar's (G, Fmax) establish / complete
    arrays (None without members), phantom rows first.
    """
    if discipline not in ("reserving", "greedy"):
        raise ValueError(f"unknown discipline {discipline!r}")
    engine = resolve_engine(engine, ensemble.device)
    if ensemble.num_instances == 0:
        return {}, None, None, [], None, None
    h = {f: getattr(alloc, f).cpu().numpy()
         for f in ("core", "valid", "src", "dst", "coflow", "size")}
    releases = ensemble.releases.cpu().numpy()
    rates = ensemble.rates.cpu().numpy()
    delta = ensemble.delta.cpu().numpy()
    members = []  # (b, k, flow-row indices into the ordered flow axis, phantoms)
    for b in range(ensemble.num_instances):
        for k in range(ensemble.num_cores[b]):
            idx = np.nonzero(h["valid"][b] & (h["core"][b] == k))[0]
            if idx.size:
                nb = 0
                if busy is not None and (b, k) in busy:
                    nb = int(np.asarray(busy[b, k]["src"]).shape[0])
                members.append((b, k, idx, nb))
    est = comp = None
    if members:
        tabs = []
        for b, k, idx, nb in members:
            tab = dict(
                src=h["src"][b, idx],
                dst=h["dst"][b, idx],
                rel=releases[b, h["coflow"][b, idx]],
                dur=delta[b] + h["size"][b, idx] / rates[b, k],
            )
            if nb:
                # Committed circuits outrank every real flow of the member.
                ph = busy[b, k]
                tab = {
                    key: np.concatenate([np.asarray(ph[key], tab[key].dtype), tab[key]])
                    for key in ("src", "dst", "rel", "dur")
                }
            tabs.append(tab)
        est, comp = _execute_members(
            tabs,
            max(ensemble.num_ports),
            discipline,
            ensemble.device,
            labels=[f"instance {b}, core {k}" for b, k, _, _ in members],
            engine=engine,
            sharding=ensemble.sharding,
        )
        for g, (b, k, _, nb) in enumerate(members):
            if nb and not np.array_equal(est[g, :nb], tabs[g]["rel"][:nb]):
                raise AssertionError(
                    f"instance {b}, core {k}: committed phantom circuits did not "
                    "establish at their release; busy tables must be "
                    "port-exclusive with rel at the epoch time"
                )
    return h, rates, delta, members, est, comp


def cct_batch_arrays(
    ensemble: EnsembleBatch,
    alloc: AllocationBatch,
    discipline: str = "reserving",
    engine: str = "kernel",
) -> np.ndarray:
    """The (B, Mp) realized CCTs straight off the padded tensors -- lean.

    The evaluation path of candidate-search refinement
    (`repro_torch.pipeline.refine`): the member tables and calendar of
    `schedule_batch_arrays`, but no `CoreSchedule` is built.  Row ``b``'s
    first ``num_coflows[b]`` entries equal `ccts_from_schedules` of the
    full stage bit for bit (a max over the same completions); padded
    entries are 0.
    """
    h, _, _, members, _, comp = _run_members(ensemble, alloc, discipline, engine)
    cct = np.zeros((ensemble.num_instances, ensemble.pad_coflows))
    for g, (b, _k, idx, _nb) in enumerate(members):
        np.maximum.at(cct[b], h["coflow"][b, idx], comp[g, : idx.shape[0]])
    return cct


def schedule_batch_arrays(
    ensemble: EnsembleBatch,
    alloc: AllocationBatch,
    discipline: str = "reserving",
    engine: str = "kernel",
    busy: dict[tuple[int, int], dict[str, np.ndarray]] | None = None,
) -> list[tuple[list[CoreSchedule], np.ndarray]]:
    """Circuit-schedule straight off the padded tensors with the
    ``engine`` calendar (``"kernel"``, ``"jax"``, ``"wide"`` or
    ``"auto"``, see `resolve_engine`).

    The `AllocationBatch` flow axis is already in scheduling priority
    order, so each (instance, core) member table is a stable partition of
    it.  Returns one ``(core_schedules, ccts)`` pair per instance.

    ``busy`` (the streaming service's committed circuits) maps ``(b, k)``
    to phantom tables ``dict(src=, dst=, rel=, dur=)``: circuits already
    running on core ``k`` of instance ``b``.  They go at the head of the
    member's table, so they claim their port pairs first; being
    port-exclusive, each establishes exactly at its ``rel`` (asserted) and
    blocks its ports for ``dur``.  Their rows are cut off before the
    `CoreSchedule`s are built, and an entry whose member has no real flows
    is ignored.  They count in the pair calendar's int32 keys.
    ``busy=None`` leaves every result as it was.
    """
    h, rates, delta, members, est, comp = _run_members(
        ensemble, alloc, discipline, engine, busy
    )
    by_member = {(b, k): g for g, (b, k, _, _) in enumerate(members)}
    out = []
    for b in range(ensemble.num_instances):
        schedules = []
        for k in range(ensemble.num_cores[b]):
            rate, dl = float(rates[b, k]), float(delta[b])
            g = by_member.get((b, k))
            if g is None:
                z = np.zeros(0)
                zi = np.zeros(0, dtype=np.int64)
                schedules.append(CoreSchedule(zi, zi, zi, z, z, z, rate, dl))
                continue
            _, _, idx, nb = members[g]
            F = idx.shape[0]
            schedules.append(
                CoreSchedule(
                    coflow=h["coflow"][b, idx],
                    src=h["src"][b, idx],
                    dst=h["dst"][b, idx],
                    size=h["size"][b, idx],
                    establish=est[g, nb:nb + F].copy(),
                    complete=comp[g, nb:nb + F].copy(),
                    rate=rate,
                    delta=dl,
                )
            )
        out.append(
            (schedules, ccts_from_schedules(ensemble.num_coflows[b], schedules))
        )
    return out


def schedule_batch(
    instances: Sequence[CoflowInstance],
    allocs: Sequence[Allocation],
    orders: Sequence[np.ndarray],
    discipline: str = "reserving",
    engine: str = "auto",
    device: str | torch.device = "cuda",
) -> list[tuple[list[CoreSchedule], np.ndarray]]:
    """Circuit-schedule a whole ensemble from per-instance allocations (the
    reference's list-of-`Allocation` oracle API): each (instance, core)
    member table (`member_tables`) runs through the ``engine`` calendar on
    ``device`` (``"auto"``: `resolve_engine`), and empty cores become
    empty `CoreSchedule`s.  Returns one ``(core_schedules, ccts)`` pair
    per instance, bit-identical to `repro_torch.core.scheduler.
    _schedule_all_cores` and `ccts_from_schedules` per instance.  The
    production path is `schedule_batch_arrays`, which reads the padded
    `EnsembleBatch` / `AllocationBatch` tensors instead."""
    instances = list(instances)
    if not (len(instances) == len(allocs) == len(orders)):
        raise ValueError("instances/allocs/orders length mismatch")
    if not instances:
        return []
    dev = torch.device(device)
    tables = [member_tables(inst, alloc, order)
              for inst, alloc, order in zip(instances, allocs, orders)]
    members = [(b, k, tab) for b, cores in enumerate(tables)
               for k, tab in enumerate(cores) if tab["coflow"].shape[0]]
    if members:
        est, comp = _execute_members(
            [tab for _, _, tab in members], max(inst.num_ports for inst in instances),
            discipline, dev, [f"instance {b}, core {k}" for b, k, _ in members],
            engine=engine,
        )
    by_member = {(b, k): g for g, (b, k, _) in enumerate(members)}
    out = []
    for b, (inst, cores) in enumerate(zip(instances, tables)):
        schedules = []
        for k, tab in enumerate(cores):
            F = tab["coflow"].shape[0]
            if F == 0:
                z = np.zeros(0)
                zi = np.zeros(0, dtype=np.int64)
                schedules.append(CoreSchedule(zi, zi, zi, z, z, z, tab["rate"], inst.delta))
                continue
            g = by_member[b, k]
            schedules.append(CoreSchedule(
                coflow=tab["coflow"], src=tab["src"], dst=tab["dst"], size=tab["size"],
                establish=est[g, :F].copy(), complete=comp[g, :F].copy(),
                rate=tab["rate"], delta=inst.delta,
            ))
        out.append((schedules, ccts_from_schedules(inst.num_coflows, schedules)))
    return out
