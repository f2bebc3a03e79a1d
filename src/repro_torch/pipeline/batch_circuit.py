"""Ensemble-batched intra-core circuit scheduling (Alg. 1 Lines 16-30).

Port of the ``engine="kernel"`` path of `repro.pipeline.batch_circuit`:
the pair-space event calendar for the whole flattened (instance x core)
member axis at once, on the device.  Flows of one (ingress, egress) pair
share both ports and execute sequentially, so only each pair's head (its
first waiting flow) can claim or start; every round

  * recomputes the heads statelessly as an exclusive segment-min of
    waiting flow ids over the pair-sorted flow axis (an int32 `cummin`
    with descending per-segment offsets, `_port_segments` on the host);
  * reduces the (G, N, N) claim matrix with the `pair_resolve` kernel
    (idle & row-first & column-first);
  * writes establish/complete times, frees ports through row/column maxima
    and advances each member's clock to its next event unless another
    round at the same instant is possible.

The JAX package runs this round in a ``lax.while_loop``; here a Python
loop runs it, testing on the host every `_CHECK_EVERY` rounds whether any
member still has pending, unstalled flows, and never passing
`event_bound` rounds.  That is exact because a round in which a member has
nothing waiting changes none of its state: no head exists, nothing starts
or frees, and its clock and stall flag are left alone.  All times are f64
and every per-round operation is a selection, a min/max or ``t + dur``
with ``dur`` computed exactly as the oracle's ``delta + size / rate``, so
establish and complete times are bit-identical to
`repro.core.circuit.schedule_core` on both disciplines.

The member tables (partition, padding and segment metadata) are built on
the host in NumPy: they are static per call.  The ``"wide"`` and ``"jax"``
engines of the reference are not ported.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.core.allocation import Allocation
from repro_torch.core.circuit import NOT_SCHEDULED, CoreSchedule
from repro_torch.core.coflow import CoflowInstance
from repro_torch.core.validate import ccts_from_schedules
from repro_torch.kernels.pair_resolve import pair_resolve
from repro_torch.pipeline.ensemble_batch import AllocationBatch, EnsembleBatch

__all__ = ["schedule_batch_arrays", "member_tables", "event_bound", "ROUNDS"]

# Bucket quanta of the reference: flows, ports and members round up.
_F_QUANTUM = 16
_N_QUANTUM = 4
_G_QUANTUM = 8

#: Rounds between host checks for live members.
_CHECK_EVERY = 16

#: Calendar rounds run so far; every round calls `pair_resolve` once.
ROUNDS = 0


def event_bound(num_flows: int) -> int:
    """Round bound of the padded event calendar: at most F rounds start
    flows, and every other round moves the clock to one of <= 2F distinct
    release or port-free values."""
    return 3 * num_flows + 4


def _round_up(n: int, q: int) -> int:
    return -(-max(n, 1) // q) * q


def _flow_priorities(alloc: Allocation, order: np.ndarray, M: int) -> np.ndarray:
    """Priority per flow: coflow global rank, intra-coflow allocation order."""
    pos = np.empty(M, dtype=np.int64)
    pos[order] = np.arange(M)
    F = alloc.num_flows()
    return pos[alloc.coflow].astype(np.float64) * (F + 1) + np.arange(F)


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
    """Padded pair-space calendar of one bucket, as device tensors.

    The static tables are fields; `state` holds the carried arrays
    (free_in, free_out, establish, complete, pending, t, stalled) and
    `round` advances it by one resolution round.
    """

    def __init__(self, pad: dict, reserving: bool, device: torch.device):
        G, F, N = pad["G"], pad["Fmax"], pad["Nmax"]
        P = N * N
        if (P + 1) * (F + 1) >= 2**31:
            raise ValueError(
                f"calendar bucket too large for int32 segment keys "
                f"(Fmax={F}, Nmax={N})"
            )
        pairkey = np.where(pad["pending"], pad["src"] * N + pad["dst"], P)
        pperm, poffs, psend, psempty = _port_segments(pairkey, P)

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        self.G, self.F, self.N, self.P = G, F, N, P
        self.reserving = reserving
        self.src, self.dst = dev(pad["src"]), dev(pad["dst"])
        self.rel, self.dur = dev(pad["rel"]), dev(pad["dur"])
        self.pperm = dev(pperm)
        self.pperm32 = dev(pperm.astype(np.int32))
        self.poffs = dev(poffs)
        self.psend, self.psempty = dev(psend), dev(psempty)
        self.pairc = dev(np.clip(pairkey, 0, P - 1))
        self.ar = torch.arange(F, dtype=torch.int32, device=device)
        arp = torch.arange(P, dtype=torch.int32, device=device)
        self.pair_off = (P - arp) * (F + 1)
        self.PI = (arp // N).long()  # static pair -> ingress port
        self.PJ = (arp % N).long()  # static pair -> egress port
        pending = dev(pad["pending"])
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

    def live(self) -> bool:
        """Whether any member has a pending flow and is not stalled."""
        s = self.state
        return bool((s["pending"] & ~s["stalled"][:, None]).any())

    def round(self) -> None:
        """One claim -> `pair_resolve` -> start -> advance round."""
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
        advance = ~more
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
        t_next = torch.where(times > t_, times, torch.inf).amin(dim=1)
        alive = pending.any(dim=1)
        stall = advance & alive & torch.isinf(t_next) & ~stalled
        s["t"] = torch.where(advance & torch.isfinite(t_next) & ~stalled, t_next, t)
        s["free_in"], s["free_out"] = free_in, free_out
        s["pending"], s["stalled"] = pending, stalled | stall

    def run(self, check_every: int = _CHECK_EVERY) -> None:
        """Rounds until no member is live, never past `event_bound`."""
        global ROUNDS
        bound = event_bound(self.F)
        it = 0
        while it < bound and self.live():
            n = min(check_every, bound - it)
            for _ in range(n):
                self.round()
            it += n
            ROUNDS += n


def _execute_members(
    tabs: Sequence[dict],
    num_ports_max: int,
    discipline: str,
    device: torch.device,
    labels: Sequence[str],
    check_every: int = _CHECK_EVERY,
) -> tuple[np.ndarray, np.ndarray]:
    """Pad member tables, run the calendar on ``device``, return the
    (G, Fmax) establish / complete arrays on the host."""
    if discipline not in ("reserving", "greedy"):
        raise ValueError(f"unknown discipline {discipline!r}")
    cal = _Calendar(
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
) -> list[tuple[list[CoreSchedule], np.ndarray]]:
    """Circuit-schedule straight off the padded tensors.

    The `AllocationBatch` flow axis is already in scheduling priority
    order, so each (instance, core) member table is a stable partition of
    it.  Returns one ``(core_schedules, ccts)`` pair per instance.
    """
    if discipline not in ("reserving", "greedy"):
        raise ValueError(f"unknown discipline {discipline!r}")
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
