"""Ensemble-batched intra-core circuit scheduling (Alg. 1 Lines 16-30).

Port of two of the reference's calendar executors
(`repro.pipeline.batch_circuit`), selected by ``engine=``.  Both run the
event calendar for the whole flattened (instance x core) member axis at
once, on the device, one resolution round at a time:

  * ``"kernel"`` (the default) -- the pair-space calendar.  Flows of one
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

The JAX package runs these rounds in a ``lax.while_loop``; here a Python
loop runs them, testing on the host every `_CHECK_EVERY` rounds whether
any member still has pending, unstalled flows, and never passing
`event_bound` rounds.  That is exact because a round in which a member has
nothing waiting changes none of its state: nothing starts or frees, and
its clock and stall flag are left alone.  All times are f64 and every
per-round operation is a selection, a min/max or ``t + dur`` with ``dur``
computed exactly as the oracle's ``delta + size / rate``, so establish and
complete times are bit-identical to `repro.core.circuit.schedule_core` on
both disciplines, under either engine.

The member tables (partition, padding and segment metadata) are built on
the host in NumPy: they are static per call.  The reference's ``"wide"``
host engine is not ported, and neither is ``"auto"`` (`check_engine`).
"""

from __future__ import annotations

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
from repro_torch.pipeline.ensemble_batch import AllocationBatch, EnsembleBatch

__all__ = [
    "schedule_batch_arrays", "member_tables", "event_bound", "check_engine",
    "ENGINES", "ROUNDS",
]

# Bucket quanta of the reference: flows, ports and members round up.
_F_QUANTUM = 16
_N_QUANTUM = 4
_G_QUANTUM = 8

#: Rounds between host checks for live members.
_CHECK_EVERY = 16

#: Calendar executors of the port: pair space on `pair_resolve`, flow
#: space on `event_resolve`.
ENGINES = ("kernel", "jax")

#: Calendar rounds run so far, per engine; every round calls its kernel's
#: wrapper (`pair_resolve` or `event_resolve`) once.
ROUNDS = dict.fromkeys(ENGINES, 0)


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


def _pad_members(tabs: Sequence[dict], num_ports_max: int) -> dict:
    """Pad per-member flow tables (each with F_k > 0) into one
    (G, Fmax) / (G, Nmax) bucket; padded flows and members never pend."""
    G = _round_up(len(tabs), _G_QUANTUM)
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

    def run(self, check_every: int = _CHECK_EVERY) -> None:
        """Rounds until no member is live, never past `event_bound`."""
        bound = event_bound(self.F)
        it = 0
        while it < bound and self.live():
            n = min(check_every, bound - it)
            for _ in range(n):
                self.round()
            it += n
            ROUNDS[self.engine] += n


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


#: Calendar class of each engine.
_CALENDARS = {c.engine: c for c in (_PairCalendar, _FlowCalendar)}


def check_engine(engine: str) -> str:
    """``engine`` if the port runs that calendar executor, else raise."""
    if engine in ENGINES:
        return engine
    if engine == "wide":
        raise ValueError(
            "circuit engine 'wide' (the reference's host NumPy calendar) is "
            "not ported yet; the port runs 'kernel' or 'jax'"
        )
    if engine == "auto":
        raise ValueError(
            "circuit engine 'auto' is not ported: name 'kernel' or 'jax'"
        )
    raise ValueError(
        f"unknown circuit engine {engine!r}; the port runs 'kernel' or 'jax'"
    )


def _execute_members(
    tabs: Sequence[dict],
    num_ports_max: int,
    discipline: str,
    device: torch.device,
    labels: Sequence[str],
    engine: str = "kernel",
    check_every: int = _CHECK_EVERY,
) -> tuple[np.ndarray, np.ndarray]:
    """Pad member tables, run the ``engine`` calendar on ``device``,
    return the (G, Fmax) establish / complete arrays on the host."""
    if discipline not in ("reserving", "greedy"):
        raise ValueError(f"unknown discipline {discipline!r}")
    cal = _CALENDARS[check_engine(engine)](
        _pad_members(tabs, num_ports_max), discipline == "reserving", device
    )
    cal.run(check_every)
    s = cal.state
    unfinished = s["pending"].any(dim=1).cpu().numpy()
    stalled = s["stalled"].cpu().numpy()
    for g, label in enumerate(labels):
        if stalled[g]:
            raise RuntimeError(f"batched scheduler stalled ({label})")
        if unfinished[g]:
            raise RuntimeError(
                f"batched scheduler exceeded the event bound ({label})"
            )
    return s["est"].cpu().numpy(), s["comp"].cpu().numpy()


def schedule_batch_arrays(
    ensemble: EnsembleBatch,
    alloc: AllocationBatch,
    discipline: str = "reserving",
    engine: str = "kernel",
) -> list[tuple[list[CoreSchedule], np.ndarray]]:
    """Circuit-schedule straight off the padded tensors with the
    ``engine`` calendar (``"kernel"`` or ``"jax"``).

    The `AllocationBatch` flow axis is already in scheduling priority
    order, so each (instance, core) member table is a stable partition of
    it.  Returns one ``(core_schedules, ccts)`` pair per instance.
    """
    if discipline not in ("reserving", "greedy"):
        raise ValueError(f"unknown discipline {discipline!r}")
    check_engine(engine)
    B = ensemble.num_instances
    if B == 0:
        return []
    core = alloc.core.cpu().numpy()
    valid = alloc.valid.cpu().numpy()
    a_src = alloc.src.cpu().numpy()
    a_dst = alloc.dst.cpu().numpy()
    a_coflow = alloc.coflow.cpu().numpy()
    a_size = alloc.size.cpu().numpy()
    releases = ensemble.releases.cpu().numpy()
    rates = ensemble.rates.cpu().numpy()
    delta = ensemble.delta.cpu().numpy()

    members = []  # (b, k, flow-row indices into the ordered flow axis)
    for b in range(B):
        for k in range(ensemble.num_cores[b]):
            idx = np.nonzero(valid[b] & (core[b] == k))[0]
            if idx.size:
                members.append((b, k, idx))
    if members:
        tabs = [
            dict(
                src=a_src[b, idx],
                dst=a_dst[b, idx],
                rel=releases[b, a_coflow[b, idx]],
                dur=delta[b] + a_size[b, idx] / rates[b, k],
            )
            for b, k, idx in members
        ]
        est, comp = _execute_members(
            tabs,
            max(ensemble.num_ports),
            discipline,
            ensemble.device,
            labels=[f"instance {b}, core {k}" for b, k, _ in members],
            engine=engine,
        )

    by_member = {(b, k): g for g, (b, k, _) in enumerate(members)}
    out = []
    for b in range(B):
        schedules = []
        for k in range(ensemble.num_cores[b]):
            rate, dl = float(rates[b, k]), float(delta[b])
            g = by_member.get((b, k))
            if g is None:
                z = np.zeros(0)
                zi = np.zeros(0, dtype=np.int64)
                schedules.append(CoreSchedule(zi, zi, zi, z, z, z, rate, dl))
                continue
            idx = members[g][2]
            F = idx.shape[0]
            schedules.append(
                CoreSchedule(
                    coflow=a_coflow[b, idx],
                    src=a_src[b, idx],
                    dst=a_dst[b, idx],
                    size=a_size[b, idx],
                    establish=est[g, :F].copy(),
                    complete=comp[g, :F].copy(),
                    rate=rate,
                    delta=dl,
                )
            )
        out.append(
            (schedules, ccts_from_schedules(ensemble.num_coflows[b], schedules))
        )
    return out
