"""Intra-core circuit scheduling (Algorithm 1 Lines 16-30).

Port of `repro.core.circuit`, in host NumPy: the per-core result type, the
event-resolution primitives (`resolve_event`, `pair_heads`,
`resolve_event_pairs`) and the per-core schedulers `schedule_core` (the
list scheduler, the oracle of the batched calendars in
`repro_torch.pipeline.batch_circuit`) and `schedule_core_sequential`
(SUNFLOW-S), bit for bit in f64.

Per-core greedy earliest-feasible port-matching list scheduler under the
not-all-stop model:

  * port-exclusive — each ingress/egress port joins at most one circuit;
  * non-preemptive — a subflow occupies its ports from circuit establishment
    (paying delta) through transmission end  t + delta + d / r^k;
  * work-conserving *with port reservation* — at every decision instant the
    scheduler scans released subflows in global priority order and starts
    every one whose two ports are idle and not reserved; a released-but-
    blocked subflow reserves its two ports so that lower-priority subflows
    cannot grab them (the paper's property, which Lemma 5's busy-time
    accounting needs).  `discipline="greedy"` gives the fully
    work-conserving variant (no reservations).

Event-driven: decision instants are release times and port free times;
between events the port state is constant, so scanning only at events is
exact.  `resolve_event` is one round's start set as masked array ops over
full-length flow arrays, the shape the batched calendars and the
`event_resolve` kernel execute per event.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "CoreSchedule",
    "schedule_core",
    "resolve_event",
    "resolve_event_pairs",
    "pair_heads",
    "schedule_core_sequential",
    "NOT_SCHEDULED",
]

NOT_SCHEDULED = -1.0


def resolve_event(
    src: np.ndarray,
    dst: np.ndarray,
    free_in: np.ndarray,
    free_out: np.ndarray,
    waiting: np.ndarray,
    t: float,
    discipline: str = "reserving",
) -> np.ndarray:
    """One resolution round at decision instant ``t``: the start mask.

    Args:
      src/dst: (F,) port endpoints of all flows, priority order.
      free_in/free_out: (N,) port free times.
      waiting: (F,) bool — pending flows already released at ``t``.
      t: the decision instant.
      discipline: "reserving" or "greedy".

    Returns (F,) bool mask of flows that establish at ``t`` this round.

    Both disciplines are one first-occurrence (segment-min over ports)
    pass; they differ only in who claims ports:

      * reserving — every *waiting* flow claims its two ports whether it
        can start or not, so a flow starts iff its ports are idle AND it
        is the first waiting flow on both of them;
      * greedy — only *idle* flows claim (non-starters reserve nothing),
        so the round starts every idle flow that is first-among-idle on
        both its ports.  Iterating rounds to a fixpoint at fixed ``t``
        yields exactly the schedule of the sequential highest-priority-
        first backfill scan: ports never get freer within an instant, so
        a flow blocked by an earlier idle claimer either starts in a
        later round (the claimer started and, with dur = 0, left the port
        free — as the sequential rescan would) or stays blocked (the port
        went busy) — asserted against a literal sequential scan by
        a literal sequential scan in the JAX package's tests.
    """
    idle = waiting & (free_in[src] <= t) & (free_out[dst] <= t)
    claim = waiting if discipline == "reserving" else idle
    F = src.shape[0]
    ar = np.arange(F)
    claim_idx = np.where(claim, ar, F)
    first_in = np.full(free_in.shape[0], F, dtype=np.int64)
    np.minimum.at(first_in, src, claim_idx)
    first_out = np.full(free_out.shape[0], F, dtype=np.int64)
    np.minimum.at(first_out, dst, claim_idx)
    return idle & (ar == first_in[src]) & (ar == first_out[dst])


def pair_heads(
    src: np.ndarray,
    dst: np.ndarray,
    waiting: np.ndarray,
    num_ports: int,
) -> np.ndarray:
    """First waiting flow per (ingress, egress) pair — the pair-space claim.

    Flows sharing one (src, dst) pair contend for *both* ports, so they
    execute strictly sequentially and only each pair's head (its first
    waiting flow in priority order) can ever claim or start.  Returns the
    (N, N) matrix of head flow indices, with ``F`` as the empty-pair
    sentinel — the claim input of `resolve_event_pairs`, and the state the
    pair-space calendar (``engine="kernel"``) maintains instead of
    per-flow claims.
    """
    F = src.shape[0]
    heads = np.full((num_ports, num_ports), F, dtype=np.int64)
    idx = np.nonzero(waiting)[0]
    np.minimum.at(heads, (src[idx], dst[idx]), idx)
    return heads


def resolve_event_pairs(
    claim: np.ndarray, idle: np.ndarray
) -> np.ndarray:
    """One resolution round in pair space: the (N, N) start mask.

    ``claim[i, j]`` is pair (i, j)'s claiming head flow id (``F``-or-more
    where no head claims — reserving rounds claim every waiting head,
    greedy rounds only idle ones); ``idle[i, j]`` whether the pair may
    start now (head waiting, both ports free — port freeness is uniform
    across a pair's flows, so idleness is a per-pair property).  A pair
    starts iff it is idle and its claim is minimal along its row (the
    first claimer on ingress i) and its column (the first claimer on
    egress j).

    This is `resolve_event`'s first-claimer-per-port pass exactly — the
    per-port minimum over flows equals the minimum over that port's pair
    heads — reduced from O(F) flows to O(N^2) pairs per round: the round
    the `pair_resolve` kernel computes for the ``engine="kernel"``
    calendar.
    """
    rowmin = claim.min(axis=1, keepdims=True)
    colmin = claim.min(axis=0, keepdims=True)
    return idle & (claim == rowmin) & (claim == colmin)


@dataclasses.dataclass
class CoreSchedule:
    """Circuit schedule for one core: parallel arrays over that core's flows."""

    coflow: np.ndarray  # (F_k,) original coflow ids
    src: np.ndarray
    dst: np.ndarray
    size: np.ndarray
    establish: np.ndarray  # (F_k,) circuit establishment times t^k_m(i,j)
    complete: np.ndarray  # (F_k,) establish + delta + size / r^k
    rate: float
    delta: float

    def cct_per_coflow(self, num_coflows: int) -> np.ndarray:
        """Max completion per coflow on this core (0 where absent).

        Every flow must be scheduled: a `NOT_SCHEDULED` completion (-1)
        would be silently absorbed by the max against the 0 baseline and
        report a finished coflow that never ran.
        """
        if (self.complete == NOT_SCHEDULED).any():
            raise ValueError(
                "cct_per_coflow on a schedule with NOT_SCHEDULED flows: "
                f"{int((self.complete == NOT_SCHEDULED).sum())} of "
                f"{self.complete.shape[0]} flows never established"
            )
        out = np.zeros(num_coflows)
        np.maximum.at(out, self.coflow, self.complete)
        return out


def schedule_core(
    coflow: np.ndarray,
    src: np.ndarray,
    dst: np.ndarray,
    size: np.ndarray,
    priority: np.ndarray,
    releases: np.ndarray,
    num_ports: int,
    rate: float,
    delta: float,
    discipline: str = "reserving",
) -> CoreSchedule:
    """Schedule one core's subflows.

    Args:
      coflow/src/dst/size: (F,) parallel arrays of this core's subflows.
      priority: (F,) total order — smaller scheduled first (global coflow
        order with intra-coflow tie-break).
      releases: (M,) coflow release times (original indexing).
      num_ports: N.
      rate: r^k.
      delta: reconfiguration delay.
      discipline: "reserving" (default; waiting higher-priority subflows
        reserve their ports — the paper's property, required by Lemma 5) or
        "greedy" (fully work-conserving ablation).
    """
    if discipline not in ("reserving", "greedy"):
        raise ValueError(f"unknown discipline {discipline!r}")
    F = int(coflow.shape[0])
    if F == 0:
        z = np.zeros(0)
        zi = np.zeros(0, dtype=np.int64)
        return CoreSchedule(zi, zi, zi, z, z, z, rate, delta)

    order = np.argsort(priority, kind="stable")
    coflow = coflow[order]
    src = src[order]
    dst = dst[order]
    size = size[order]
    rel = releases[coflow]
    dur = delta + size / rate

    free_in = np.zeros(num_ports)
    free_out = np.zeros(num_ports)
    establish = np.full(F, NOT_SCHEDULED)
    complete = np.full(F, NOT_SCHEDULED)
    pending = np.ones(F, dtype=bool)
    reserving = discipline == "reserving"

    t = float(rel.min())
    remaining = F
    while remaining:
        # Flows waiting at time t (pending + released), in priority order:
        # start those whose two ports are idle (and unreserved); a blocked
        # waiting flow reserves its ports under the reserving discipline.
        # Both disciplines resolve an event without a per-flow Python scan;
        # the per-round start set is `resolve_event`, the array-form
        # primitive the batched calendars and the kernel share:
        #
        #   * reserving — first-occurrence pass per round.  Rounds repeat
        #     until a pass starts nothing — with positive durations the
        #     second pass is always empty (started ports are busy past t,
        #     blocked flows still outrank their successors), and zero-
        #     duration flows chain same-port starts at one t exactly like
        #     the sequential scan did.
        #   * greedy — every first-among-idle flow starts per round;
        #     re-rounding to a fixpoint reproduces the sequential backfill
        #     scan exactly (ports only get busier, so earlier
        #     non-candidates stay non-candidates).
        waiting = pending & (rel <= t)
        while waiting.any():
            start = resolve_event(
                src, dst, free_in, free_out, waiting, t,
                "reserving" if reserving else "greedy",
            )
            if not start.any():
                break
            end = t + dur[start]
            establish[start] = t
            complete[start] = end
            free_in[src[start]] = end
            free_out[dst[start]] = end
            pending[start] = False
            remaining -= int(start.sum())
            waiting &= ~start
        if remaining == 0:
            break
        # Advance to the next event: earliest pending release or port-free
        # time strictly after t that could unblock some pending flow.  A
        # reservation-blocked flow has all its own constraint times <= t;
        # the flow reserving it contributes the (> t) time that matters.
        idx = np.nonzero(pending)[0]
        times = np.maximum.reduce(
            [rel[idx], free_in[src[idx]], free_out[dst[idx]]]
        )
        times = times[times > t]
        if times.size == 0:  # pragma: no cover - guard against stalls
            raise RuntimeError(f"scheduler stalled at t={t}")
        t = float(times.min())

    return CoreSchedule(
        coflow=coflow,
        src=src,
        dst=dst,
        size=size,
        establish=establish,
        complete=complete,
        rate=rate,
        delta=delta,
    )


def schedule_core_sequential(
    coflow: np.ndarray,
    src: np.ndarray,
    dst: np.ndarray,
    size: np.ndarray,
    priority: np.ndarray,
    coflow_rank: np.ndarray,
    releases: np.ndarray,
    num_ports: int,
    rate: float,
    delta: float,
) -> CoreSchedule:
    """Sunflow-style one-coflow-at-a-time variant (SUNFLOW-S baseline).

    Coflows are served strictly sequentially in global order on each core:
    coflow c's subflows may establish only after every subflow of the
    previous coflow on this core has completed (Sunflow schedules a single
    coflow at a time; its single-coflow inner policy is the same greedy
    port-matching).  `coflow_rank` maps original coflow id -> global order
    position.
    """
    F = int(coflow.shape[0])
    if F == 0:
        z = np.zeros(0)
        zi = np.zeros(0, dtype=np.int64)
        return CoreSchedule(zi, zi, zi, z, z, z, rate, delta)

    order = np.argsort(priority, kind="stable")
    coflow = coflow[order]
    src = src[order]
    dst = dst[order]
    size = size[order]

    establish = np.full(F, NOT_SCHEDULED)
    complete = np.full(F, NOT_SCHEDULED)
    barrier = 0.0  # completion of the previously served coflow on this core
    ranks = coflow_rank[coflow]
    for r in np.unique(ranks):  # unique is sorted -> global order
        sel = np.nonzero(ranks == r)[0]
        m = coflow[sel[0]]
        sub = schedule_core(
            coflow=coflow[sel],
            src=src[sel],
            dst=dst[sel],
            size=size[sel],
            priority=np.arange(sel.size, dtype=np.float64),
            releases=np.maximum(releases, barrier),
            num_ports=num_ports,
            rate=rate,
            delta=delta,
        )
        # schedule_core sorts by priority; priorities here are already the
        # original relative order, so positions map 1:1.
        establish[sel] = sub.establish
        complete[sel] = sub.complete
        barrier = float(sub.complete.max())

    return CoreSchedule(
        coflow=coflow,
        src=src,
        dst=dst,
        size=size,
        establish=establish,
        complete=complete,
        rate=rate,
        delta=delta,
    )
