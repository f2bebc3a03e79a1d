"""`port_stats`: per-port load and nonzero counts of demand matrices.

Port of `repro.kernels.port_stats.port_stats` (the Pallas kernel
`port_stats_pallas`), held to the reference's main path rather than to the
Pallas kernel: the reference packs its LP from host f64 sums
(`repro.core.coflow.port_stats`), so both the kernel and its plain twin
read f64 demands and sum in f64 in NumPy's own order -- pairwise over a
row (NumPy's full recursion, added to the reduction's identity 0.0), a
running sum down a column.  ``rho`` is therefore bit-identical to the host
NumPy value in f64 (0 ulp), and so in f32 after the cast the LP arrays
take; ``tau`` counts are exact.

Returns ``rho`` (M, 2N) f64 -- row sums (ingress ports 0..N-1), then
column sums (egress ports N..2N-1) -- and ``tau`` (M, 2N) int32.

`plan` picks the kernel's route from (M, N) and the card's SM count (the
source note of ``csrc/port_stats.cu`` says why): up to `SMALL_PORTS` ports
the ``small`` route, a run of matrices a block staged whole in shared
memory; past them the ``stream`` route, one block a matrix with its rows
streamed through a ring of slabs, which takes any N up to `MAX_PORTS`.
`tiling` builds any other choice and `tilings` lists the ones the sweep
runs, which `port_stats` takes as ``plan``.

CUDA tensors launch the hand-written kernel (``csrc/port_stats.cu``) or
raise; CPU tensors take `port_stats_plain`.  `LAUNCHES` counts calls that
launched the kernel.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import torch

from repro_torch.kernels.common import launch, refuse_grad, sm_count, stream_of

__all__ = [
    "port_stats", "port_stats_plain", "plan", "tiling", "tilings", "Plan",
    "LAUNCHES", "MAX_PORTS", "SMALL_PORTS",
]

#: Kernel launches in this process (CPU calls are not counted).
LAUNCHES = 0

#: Up to this many ports the small route (a run of matrices a block; the
#: sweep put the switch between 104 and 128 even ports, 119 and 127 odd).
SMALL_PORTS = 120
# The small route sums a row as one leaf of NumPy's recursion (its kernel
# is built without the recursion's calls), so it takes no more ports.
_SMALL_LIMIT = 128
#: The widest N the kernel takes: a stream-route thread owns at most 16
#: columns, of 512 column owners.
MAX_PORTS = 8192
# A small-route grid aims at this many blocks an SM, of at least this many
# threads (one an output).
_SMALL_BLOCKS_PER_SM = 4
_SMALL_MIN_THREADS = 128
# The default shared memory of a block, the 227 KB (232,448 bytes) a
# Hopper block can opt into, an SM's 228 KB, and the 1 KB it keeps a block.
_DEFAULT_SMEM = 48 * 1024
_MAX_SHARED_BYTES = 232_448
_SM_SHARED_BYTES = 233_472
_BLOCK_RESERVED_BYTES = 1024


@dataclass(frozen=True)
class Plan:
    """A call's launch: ``route`` "small" (``per_block`` matrices a block,
    ``stages`` 0) or "stream" (one block a matrix, ``rows`` rows a slab,
    ``stages`` slabs in the ring); ``grid`` blocks of ``threads``, ``smem``
    bytes of shared memory each.  The C entry takes `word` (per, threads,
    stages packed in one 64-bit argument) and derives the rest itself;
    ``port_stats_dims`` reports the grid, threads and shared memory it
    derives, which the cuda tests hold equal to these."""

    route: str
    per_block: int
    rows: int
    stages: int
    grid: int
    threads: int
    smem: int
    word: int


def _round32(x: int, cap: int) -> int:
    return min(cap, max(32, -(-x // 32) * 32))


def _small_stride(N: int) -> int:
    """The small route's row stride in doubles: odd (as the source)."""
    return N | 1


def _stream_stride(N: int) -> int:
    """A slab's row stride in doubles: >= N + 1, 8 mod 16 (as the source)."""
    return N + 1 + (8 - (N + 1)) % 16


def tiling(M: int, N: int, route: str, per: int, stages: int = 2,
           threads: int | None = None) -> Plan:
    """The plan of ``route`` with ``per`` matrices a block ("small"; at
    most M) or ``per`` rows a slab and ``stages`` slabs ("stream"; at most
    N and 32 rows).  ``threads``: the block's (small; default one an
    output of its run, at most 512) or the column owners' (stream; default
    one a column, at most 512, to which the block adds a row warp per 4
    rows of a slab and the warp that issues the copies)."""
    if route == "small":
        if N > _SMALL_LIMIT:
            raise ValueError(f"port_stats: the small route takes at most {_SMALL_LIMIT} "
                             f"ports, got {N}")
        G = max(1, min(per, M))
        threads = threads or _round32(G * 2 * N, 512)
        return Plan("small", G, 0, 0, -(-M // G), threads, 8 * G * N * _small_stride(N),
                    G | threads << 20)
    if route != "stream":
        raise ValueError(f"port_stats: unknown route {route!r}")
    R = max(1, min(per, N, 32))
    threads = threads or _round32(N, 512)
    # The slabs, then two 8-byte mbarriers a slab (full, empty).
    return Plan("stream", 0, R, stages, M, threads + 32 * -(-R // 4) + 32,
                8 * stages * (R * _stream_stride(N) + 2), R | threads << 20 | stages << 31)


def tilings(M: int, N: int) -> list[Plan]:
    """Every plan the sweep runs at (M, N) within a block's shared memory:
    the small route at 1 to 64 matrices a block (up to 128 ports),
    the stream route at 4 to 32 rows a slab in rings of 2 to 4."""
    out = []
    for G in (1, 2, 4, 8, 16, 32, 64) if N <= _SMALL_LIMIT else ():
        p = tiling(M, N, "small", G)
        if p.smem <= _MAX_SHARED_BYTES and p not in out:
            out.append(p)
    for R in (4, 8, 16, 32):
        for S in (2, 3, 4):
            p = tiling(M, N, "stream", R, S)
            if p.smem <= _MAX_SHARED_BYTES and p not in out:
                out.append(p)
    return out


@functools.lru_cache(maxsize=None)
def plan(M: int, N: int, num_sms: int) -> Plan:
    """The launch of a call on a card with ``num_sms`` SMs (module doc).

    Small route: matrices a block enough for about `_SMALL_BLOCKS_PER_SM`
    blocks an SM and `_SMALL_MIN_THREADS` outputs a block, rounded up to
    whole warps of row outputs, within the default 48 KB of shared memory; where the blocks would then need more
    than one wave because shared memory holds them back, one block an SM
    with all its matrices (up to a block's 227 KB).  Stream route: 32 rows a slab (each slab
    has a fixed cost) in a ring of 2 (a deeper ring was no faster and holds
    fewer blocks an SM); fewer rows where a wide N would pass a block's
    shared memory."""
    if N <= SMALL_PORTS:
        per_matrix = 8 * N * _small_stride(N)
        G = max(-(-M // (_SMALL_BLOCKS_PER_SM * num_sms)), -(-_SMALL_MIN_THREADS // (2 * N)))
        # Rows come first: with G N a multiple of 32 no warp takes both
        # branches (the sweep: 16 matrices of 10 ports a block, not 7 or 17).
        whole = 32 // math.gcd(N, 32)
        if -(-G // whole) * whole * per_matrix <= _DEFAULT_SMEM:
            G = -(-G // whole) * whole
        G = max(1, min(G, _DEFAULT_SMEM // per_matrix))
        resident = _SM_SHARED_BYTES // (G * per_matrix + _BLOCK_RESERVED_BYTES)
        if -(-M // G) > num_sms * resident and -(-M // num_sms) * per_matrix <= _MAX_SHARED_BYTES:
            G = -(-M // num_sms)  # one wave, where shared memory holds blocks back
        return tiling(M, N, "small", G)
    R, S = 32, 2
    p = tiling(M, N, "stream", R, S)
    while p.smem > _MAX_SHARED_BYTES and (p.rows > 1 or p.stages > 2):
        if p.rows > 1:
            R = p.rows // 2
        else:
            S = p.stages - 1
        p = tiling(M, N, "stream", R, S)
    return p


# `port_stats`'s ``plan`` parameter shadows the function.
_plan = plan


def _pairwise_last(d: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in NumPy's pairwise order: past 128 terms
    NumPy's recursion (split at n/2 rounded down to a multiple of 8), eight
    interleaved partials at 8 to 128 terms, a plain loop below 8."""
    n = d.shape[-1]
    if n > 128:
        n2 = n // 2
        n2 -= n2 % 8
        return _pairwise_last(d[..., :n2]) + _pairwise_last(d[..., n2:])
    res = torch.zeros(d.shape[:-1], dtype=d.dtype, device=d.device)
    if n < 8:
        for i in range(n):
            res = res + d[..., i]
        return res
    r = d[..., :8]
    tail = n - n % 8
    for i in range(8, tail, 8):
        r = r + d[..., i:i + 8]
    res = ((r[..., 0] + r[..., 1]) + (r[..., 2] + r[..., 3])) + (
        (r[..., 4] + r[..., 5]) + (r[..., 6] + r[..., 7])
    )
    for i in range(tail, n):
        res = res + d[..., i]
    return res


def port_stats_plain(demands: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of the kernel, in the same summation order.  The
    row sums are added to 0.0 as NumPy's reduction adds them to its
    identity (a row of -0.0 sums to +0.0)."""
    cols = torch.zeros(
        (demands.shape[0], demands.shape[2]), dtype=demands.dtype,
        device=demands.device,
    )
    for i in range(demands.shape[1]):
        cols = cols + demands[:, i, :]
    rho = torch.cat([0.0 + _pairwise_last(demands), cols], dim=1)
    nz = demands > 0
    tau = torch.cat([nz.sum(dim=2), nz.sum(dim=1)], dim=1).to(torch.int32)
    return rho, tau


def port_stats(
    demands: torch.Tensor, *, plan: Plan | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """(M, N, N) f64 demands -> (rho (M, 2N) f64, tau (M, 2N) int32).

    ``plan`` (a `tiling` result) replaces the `plan` function's choice on
    the card; the C entry refuses one that does not fit the shape."""
    global LAUNCHES
    if demands.dim() != 3 or demands.shape[1] != demands.shape[2]:
        raise ValueError(
            f"port_stats: demands must be (M, N, N), got {tuple(demands.shape)}"
        )
    if demands.dtype != torch.float64:
        raise TypeError(f"port_stats: demands must be float64, got {demands.dtype}")
    M, N, _ = demands.shape
    dev = demands.device
    if dev.type == "cpu":
        return port_stats_plain(demands)
    if dev.type != "cuda":
        raise ValueError(f"port_stats: unsupported device {dev}")
    if not demands.is_contiguous():
        raise ValueError("port_stats: demands must be contiguous")
    if N > MAX_PORTS:
        raise ValueError(f"port_stats: at most {MAX_PORTS} ports (MAX_PORTS), got {N}")
    refuse_grad("port_stats", demands)
    if plan is None:
        plan = _plan(M, N, sm_count(dev)) if M and N else None
    elif plan.smem > _MAX_SHARED_BYTES:
        raise ValueError(
            f"port_stats: {N} ports need {plan.smem} bytes of shared memory on the "
            f"{plan.route} route, more than a block's {_MAX_SHARED_BYTES}"
        )
    rho = torch.empty((M, 2 * N), dtype=torch.float64, device=dev)
    tau = torch.empty((M, 2 * N), dtype=torch.int32, device=dev)
    if M and N:
        launch(
            "port_stats", demands.data_ptr(), rho.data_ptr(), tau.data_ptr(),
            M, N, plan.word, stream_of(demands), device=demands.device,
        )
        LAUNCHES += 1
    return rho, tau
