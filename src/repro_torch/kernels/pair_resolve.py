"""`pair_resolve`: one pair-space resolution round of the circuit calendar.

Port of `repro.kernels.event_resolve.pair_resolve` (the Pallas kernel
`pair_resolve_pallas`).  ``claim[g, i, j]`` is the claiming head flow id of
pair (ingress i, egress j) of member g, or any value >= the member's flow
count where no head claims; ``idle[g, i, j]`` whether the pair may start
now.  A pair starts iff it is idle and its claim is the minimum along its
row (first claimer on the ingress port) and its column (first claimer on
the egress port).  Claims are int32: exact, with no f32 id guard.

`plan` picks the kernel's route from (G, N) and the card's SM count (the
source note of ``csrc/pair_resolve.cu`` says why): up to `BLOCK_PORTS`
ports the ``block`` route, one thread per pair and whole members in a
block; past them the ``cluster`` route, each member over a thread block
cluster of blocks that each hold a slab of rows.  `tiling` builds any other
choice, which `pair_resolve` takes as ``plan``.  The minimum is order-free,
so every route gives the same bits.

CUDA tensors launch the hand-written kernel (``csrc/pair_resolve.cu``) or
raise; CPU tensors take `pair_resolve_plain`.  `LAUNCHES` counts calls
that launched the kernel.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from repro_torch.kernels.common import launch, refuse_grad, sm_count, stream_of

__all__ = [
    "pair_resolve", "pair_resolve_plain", "plan", "tiling", "tilings", "Plan",
    "LAUNCHES", "BLOCK_PORTS", "MAX_CLUSTER",
]

#: Kernel launches in this process (CPU calls are not counted).
LAUNCHES = 0

#: Up to this many ports the block route (at most 1024 pairs a block).
BLOCK_PORTS = 32
#: Most blocks a member's cluster takes: the portable cluster size.
MAX_CLUSTER = 8
# The claims a block-route block holds, one thread each.
_BLOCK_PAIRS = 1024
# Threads of a cluster-route block (``pair_resolve_dims`` reports the source's).
_CLUSTER_THREADS = 256
# Both routes stay within the default 48 KB of shared memory a block.
_SMEM = 48 * 1024
# The calendar's widest bucket is 152 ports (150 + its quantum of 4); a
# cluster of 8 holds 240 in slabs of 30 rows (30.8 KB a block).
_MAX_PORTS = 240


@dataclass(frozen=True)
class Plan:
    """A call's launch: ``route`` "block" (``per_block`` members a block)
    or "cluster" (``cluster`` blocks a member, ``rows`` rows each);
    ``grid`` blocks of ``threads``, ``smem`` bytes of shared memory each.
    The C entry takes `width` (``cluster``, or -``per_block``) and derives
    the rest itself; its ``pair_resolve_dims`` reports the grid, threads and
    shared memory it derives, which the cuda tests hold equal to these."""

    route: str
    per_block: int
    cluster: int
    rows: int
    grid: int
    threads: int
    smem: int
    width: int


def tiling(G: int, N: int, route: str, width: int) -> Plan:
    """The plan of ``route`` with ``width`` members a block ("block") or
    up to ``width`` blocks a member ("cluster": ceil(N / width) rows a
    block, and only as many blocks as that needs)."""
    if route == "block":
        pairs = width * N * N
        return Plan("block", width, 0, N, -(-G // width), -(-pairs // 32) * 32, 4 * pairs,
                    -width)
    if route != "cluster":
        raise ValueError(f"pair_resolve: unknown route {route!r}")
    rows = -(-N // width)
    cluster = -(-N // rows)
    return Plan("cluster", 0, cluster, rows, G * cluster, _CLUSTER_THREADS,
                4 * (rows * N + 2 * N + rows), cluster)


def tilings(G: int, N: int) -> list[Plan]:
    """Every plan the kernel takes at (G, N): the block route at 1, 2, 4,
    ... members a block, the cluster route at 1, 2, 4 and 8 blocks a
    member (at most N), each within 48 KB of shared memory."""
    out = []
    width = 1
    while width <= G and width * N * N <= _BLOCK_PAIRS:
        out.append(tiling(G, N, "block", width))
        width *= 2
    width = 1
    while width <= min(MAX_CLUSTER, N):
        p = tiling(G, N, "cluster", width)
        if p.smem <= _SMEM and p not in out:
            out.append(p)
        width *= 2
    return out


@functools.lru_cache(maxsize=None)
def plan(G: int, N: int, num_sms: int) -> Plan:
    """The launch of a call on a card with ``num_sms`` SMs (module doc).

    Block route: the fewest members a block that keep every block on its
    own SM (one, while G <= ``num_sms``).  Cluster route: the largest power
    of two up to `MAX_CLUSTER` blocks a member that the card holds at once
    (``num_sms // G``), at least 2, and 8 where a slab would pass 48 KB
    (at 240 ports a slab of 8 fits)."""
    if N <= BLOCK_PORTS:
        per_block = min(-(-G // num_sms), _BLOCK_PAIRS // (N * N))
        return tiling(G, N, "block", max(1, per_block))
    width = 2
    while width * 2 <= min(MAX_CLUSTER, num_sms // max(G, 1)):
        width *= 2
    p = tiling(G, N, "cluster", width)
    return p if p.smem <= _SMEM else tiling(G, N, "cluster", MAX_CLUSTER)


# `pair_resolve`'s ``plan`` parameter shadows the function.
_plan = plan


def pair_resolve_plain(claim: torch.Tensor, idle: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin of the kernel (and of ``pair_resolve_ref``)."""
    rowmin = claim.amin(dim=2, keepdim=True)
    colmin = claim.amin(dim=1, keepdim=True)
    return idle & (claim == rowmin) & (claim == colmin)


def pair_resolve(
    claim: torch.Tensor, idle: torch.Tensor, *, plan: Plan | None = None
) -> torch.Tensor:
    """(G, N, N) int32 claims + (G, N, N) bool idle -> (G, N, N) bool starts.

    ``plan`` (a `tiling` result) replaces the `plan` function's choice on
    the card; the C entry refuses one that does not fit the shape."""
    global LAUNCHES
    if claim.dim() != 3 or claim.shape[1] != claim.shape[2]:
        raise ValueError(f"pair_resolve: claim must be (G, N, N), got {tuple(claim.shape)}")
    if claim.dtype != torch.int32 or idle.dtype != torch.bool:
        raise TypeError(
            f"pair_resolve: claim must be int32 and idle bool, got "
            f"{claim.dtype} and {idle.dtype}"
        )
    if idle.shape != claim.shape or idle.device != claim.device:
        raise ValueError("pair_resolve: idle must match claim's shape and device")
    if claim.device.type == "cpu":
        return pair_resolve_plain(claim, idle)
    if claim.device.type != "cuda":
        raise ValueError(f"pair_resolve: unsupported device {claim.device}")
    if not (claim.is_contiguous() and idle.is_contiguous()):
        raise ValueError("pair_resolve: claim and idle must be contiguous")
    refuse_grad("pair_resolve", claim, idle)
    G, N, _ = claim.shape
    if N > _MAX_PORTS:
        raise ValueError(f"pair_resolve: at most {_MAX_PORTS} ports, got {N}")
    start = torch.empty_like(idle)
    if G and N:
        p = plan if plan is not None else _plan(G, N, sm_count(claim.device))
        launch(
            "pair_resolve", claim.data_ptr(), idle.data_ptr(), start.data_ptr(),
            G, N, p.width, stream_of(claim), device=claim.device,
        )
        LAUNCHES += 1
    return start
