"""`event_resolve`: one flow-space resolution round of the circuit calendar.

Port of `repro.kernels.event_resolve.event_resolve` (the Pallas kernel
`event_resolve_pallas`, which knows the reserving discipline only and
compares times in f32), for both disciplines and with f64 times.  Per
member g, at its instant ``t[g]``, over its flows in priority order:

  * a flow *waits* if it is pending and released (``rel <= t``), and is
    *idle* if it waits and both its ports are free (``free_in[src] <= t``
    and ``free_out[dst] <= t``);
  * the claimers are the waiting flows (``"reserving"``) or the idle flows
    (``"greedy"``); a port's first claimer is the least claiming flow id on
    it, or ``F`` where none claims;
  * a flow starts iff it is idle and the first claimer on both its ports.

This is `repro.core.circuit.resolve_event` for a batch of members.  Greedy
is the reserving round with ``pending := idle``.  Ports of waiting flows
must lie in ``[0, N)``; other flows' ports are never read by the kernel
(the twin gathers them, so they must be valid indices too).

The call returns ``(start, first_in, first_out, blocked)``: the (G, F)
bool start mask; the (G, N) int32 first claimers per ingress and egress
port, which the calendar's free-time update reads; and a (G,) bool flag,
whether some idle flow did not start (the greedy calendar's test for
another round at the same instant).

`plan` picks the kernel's route from (G, F, N) and the card's SM count
(the source note of ``csrc/event_resolve.cu`` says why): up to
`BLOCK_FLOWS` flows the ``block`` route, one block a member over all its
flows; past them the ``cluster`` route, each member over a thread block
cluster of blocks that each take their own range of flows and combine
their first claimers (a minimum: order-free, so every route gives the same
bits).  `tiling` builds any other choice, which `event_resolve` takes as
``plan``.

CUDA tensors launch the hand-written kernel (``csrc/event_resolve.cu``) or
raise; CPU tensors take `event_resolve_plain`.  `LAUNCHES` counts calls
that launched the kernel.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from repro_torch.kernels.common import launch, refuse_grad, sm_count, stream_of

__all__ = [
    "event_resolve", "event_resolve_plain", "plan", "tiling", "tilings", "Plan",
    "LAUNCHES", "BLOCK_FLOWS", "MAX_CLUSTER", "SPAN_QUANTUM",
]

#: Kernel launches in this process (CPU calls are not counted).
LAUNCHES = 0

#: Up to this many flows a member takes one block (the block route).
BLOCK_FLOWS = 4096
#: Most blocks a member's cluster takes: the portable cluster size.
MAX_CLUSTER = 8
#: A cluster-route block's flows are a multiple of this: 32 lanes of 4.
SPAN_QUANTUM = 128
# The cluster route stays within the default 48 KB of shared memory (about
# 2.99 million flows at 152 ports over 8 blocks); the block route may take
# the 227 KB (232,448 bytes) of a Hopper block: 2N first claimers and one
# idle bit per flow in 32-bit words (about 1.85 million flows at 152 ports).
_CLUSTER_SMEM = 48 * 1024
_MAX_SHARED_BYTES = 232_448

_DISCIPLINES = ("reserving", "greedy")


@dataclass(frozen=True)
class Plan:
    """A call's launch: ``route`` "block" (``cluster`` = 1) or "cluster"
    (``cluster`` blocks a member); block r of a member takes flows
    [r span, min(F, (r + 1) span)), a lane ``vector`` consecutive flows a
    step; ``grid`` blocks of ``threads``, ``smem`` bytes of shared memory
    each.  The C entry takes `word`, (cluster, span, threads, vector)
    packed in one 64-bit argument, and derives the rest itself (4-flow
    loads only where the pointers are aligned); its ``event_resolve_dims``
    reports the grid, threads and shared memory it derives, which the cuda
    tests hold equal to these."""

    route: str
    cluster: int
    span: int
    grid: int
    threads: int
    smem: int
    vector: int
    word: int


def tiling(G: int, F: int, N: int, cluster: int, threads: int | None = None,
           vector: int | None = None) -> Plan:
    """The plan with up to ``cluster`` blocks a member (1: the block
    route; past 1 only as many as the flows fill).  Defaults: a lane takes
    one flow a step where a block's flows fit one a thread (more warps:
    latency), else 4 where F % 4 == 0 (more bytes in flight); threads
    enough for one step (32 to 1024)."""
    if cluster == 1:
        span, words = F, -(-F // 32)
        smem = 4 * (2 * N + words)
    else:
        span = max(SPAN_QUANTUM, -(-F // (cluster * SPAN_QUANTUM)) * SPAN_QUANTUM)
        cluster = max(2, -(-F // span))
        smem = 4 * (4 * N + span // 32)
    if vector is None:
        vector = 4 if F % 4 == 0 and span > 1024 else 1
    if threads is None:
        threads = min(1024, max(32, -(-span // (vector * 32)) * 32))
    return Plan("block" if cluster == 1 else "cluster", cluster, span, G * cluster,
                threads, smem, vector,
                span | threads << 32 | cluster << 43 | vector << 47)


def tilings(G: int, F: int, N: int) -> list[Plan]:
    """Every plan the kernel takes at (G, F, N) with its default threads
    and vector: the block route within a block's shared memory, and the
    cluster route at 2, 4 and 8 blocks a member within 48 KB."""
    out = [p for p in [tiling(G, F, N, 1)] if p.smem <= _MAX_SHARED_BYTES]
    cluster = 2
    while cluster <= MAX_CLUSTER:
        p = tiling(G, F, N, cluster)
        if p.smem <= _CLUSTER_SMEM and p not in out:
            out.append(p)
        cluster *= 2
    return out


@functools.lru_cache(maxsize=None)
def plan(G: int, F: int, N: int, num_sms: int) -> Plan:
    """The launch of a call on a card with ``num_sms`` SMs (module doc).

    Up to `BLOCK_FLOWS` flows, or where no cluster fits 48 KB, the block
    route.  Past them the cluster route, with the largest power of two up
    to `MAX_CLUSTER` blocks a member that the card holds at once
    (``num_sms // G``), at least 2, and more where a block's idle bits
    would pass 48 KB."""
    if F > BLOCK_FLOWS:
        cluster = 2
        while cluster * 2 <= min(MAX_CLUSTER, num_sms // max(G, 1)):
            cluster *= 2
        while cluster <= MAX_CLUSTER:
            p = tiling(G, F, N, cluster)
            if p.smem <= _CLUSTER_SMEM:
                return p
            cluster *= 2
    return tiling(G, F, N, 1)


# `event_resolve`'s ``plan`` parameter shadows the function.
_plan = plan


def event_resolve_plain(
    src: torch.Tensor,
    dst: torch.Tensor,
    rel: torch.Tensor,
    free_in: torch.Tensor,
    free_out: torch.Tensor,
    pending: torch.Tensor,
    t: torch.Tensor,
    discipline: str = "reserving",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of the kernel (and of ``event_resolve_ref``)."""
    G, F = src.shape
    t_ = t[:, None]
    s, d = src.long(), dst.long()
    waiting = pending & (rel <= t_)
    idle = (
        waiting
        & (torch.gather(free_in, 1, s) <= t_)
        & (torch.gather(free_out, 1, d) <= t_)
    )
    claim = waiting if discipline == "reserving" else idle
    ar = torch.arange(F, dtype=torch.int32, device=src.device).expand(G, F)
    ids = torch.where(claim, ar, F)
    none = torch.full(tuple(free_in.shape), F, dtype=torch.int32, device=src.device)
    first_in = none.scatter_reduce(1, s, ids, reduce="amin")
    first_out = none.scatter_reduce(1, d, ids, reduce="amin")
    start = (
        idle
        & (torch.gather(first_in, 1, s) == ar)
        & (torch.gather(first_out, 1, d) == ar)
    )
    return start, first_in, first_out, (idle & ~start).any(dim=1)


def _validate(src, dst, rel, free_in, free_out, pending, t, discipline):
    """Shapes, dtypes and devices up front, each error naming its operand."""
    if discipline not in _DISCIPLINES:
        raise ValueError(f"event_resolve: unknown discipline {discipline!r}")
    ops = dict(src=src, dst=dst, rel=rel, free_in=free_in, free_out=free_out,
               pending=pending, t=t)
    for name, x in ops.items():
        if not isinstance(x, torch.Tensor):
            raise TypeError(
                f"event_resolve: operand {name!r} must be a tensor, got "
                f"{type(x).__name__}"
            )
    if src.dim() != 2:
        raise ValueError(
            f"event_resolve: operand 'src' must be (G, F), got {tuple(src.shape)}"
        )
    G, F = src.shape
    if free_in.dim() != 2 or free_in.shape[0] != G or free_in.shape[1] < 1:
        raise ValueError(
            f"event_resolve: operand 'free_in' must be (G, N) with G = {G} and "
            f"N >= 1, got {tuple(free_in.shape)}"
        )
    N = free_in.shape[1]
    want = dict(
        src=((G, F), torch.int32), dst=((G, F), torch.int32),
        rel=((G, F), torch.float64), free_in=((G, N), torch.float64),
        free_out=((G, N), torch.float64), pending=((G, F), torch.bool),
        t=((G,), torch.float64),
    )
    for name, (shape, dtype) in want.items():
        x = ops[name]
        if x.dtype != dtype:
            raise TypeError(
                f"event_resolve: operand {name!r} must be {dtype}, got {x.dtype}"
            )
        if tuple(x.shape) != shape:
            raise ValueError(
                f"event_resolve: operand {name!r} has shape {tuple(x.shape)}, "
                f"expected {shape}"
            )
        if x.device != src.device:
            raise ValueError(
                f"event_resolve: operand {name!r} is on {x.device}, 'src' on "
                f"{src.device}"
            )
    return G, F, N


def event_resolve(
    src: torch.Tensor,
    dst: torch.Tensor,
    rel: torch.Tensor,
    free_in: torch.Tensor,
    free_out: torch.Tensor,
    pending: torch.Tensor,
    t: torch.Tensor,
    discipline: str = "reserving",
    *,
    plan: Plan | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(G, F) int32 ports, f64 releases and bool pending + (G, N) f64 port
    free times + (G,) f64 instants -> (start, first_in, first_out,
    blocked).

    ``plan`` (a `tiling` result) replaces the `plan` function's choice on
    the card; the C entry refuses one that does not fit the shape."""
    global LAUNCHES
    G, F, N = _validate(src, dst, rel, free_in, free_out, pending, t, discipline)
    if src.device.type == "cpu":
        return event_resolve_plain(src, dst, rel, free_in, free_out, pending, t, discipline)
    if src.device.type != "cuda":
        raise ValueError(f"event_resolve: unsupported device {src.device}")
    ops = (src, dst, rel, free_in, free_out, pending, t)
    refuse_grad("event_resolve", *ops)
    if not all(x.is_contiguous() for x in ops):
        raise ValueError("event_resolve: every operand must be contiguous")
    if plan is None:
        plan = _plan(G, F, N, sm_count(src.device))
    if plan.smem > _MAX_SHARED_BYTES:
        raise ValueError(
            f"event_resolve: {F} flows and {N} ports need {plan.smem} bytes of "
            f"shared memory on the {plan.route} route, more than a block's "
            f"{_MAX_SHARED_BYTES}"
        )
    start = torch.empty_like(pending)
    first_in = torch.empty((G, N), dtype=torch.int32, device=src.device)
    first_out = torch.empty_like(first_in)
    blocked = torch.empty((G,), dtype=torch.bool, device=src.device)
    if G:
        launch(
            "event_resolve", *(x.data_ptr() for x in ops), start.data_ptr(),
            first_in.data_ptr(), first_out.data_ptr(), blocked.data_ptr(),
            G, F, N, int(discipline == "reserving"), plan.word, stream_of(src),
            device=src.device,
        )
        LAUNCHES += 1
    return start, first_in, first_out, blocked
