"""`lp_terms_batch` and `lp_terms`: the hard-max terms of the ordering LP.

Ports of `repro.kernels.lp_terms.lp_terms_batch` and `lp_terms` (the Pallas
kernels `lp_terms_batch_pallas` and `lp_terms_pallas`).  For every member b
and coflow m::

    t_load[b, m] = max_p (X^T P_rho)[b, m, p] * inv_R[b]
    t_rec[b, m]  = max_p (X^T P_tau)[b, m, p] * delta_over_K[b]

x (B, M, M), p_rho / p_tau (B, M, P), scales (B,), all f32, any P.
`lp_terms` computes the same two terms for one instance: x (M, M),
p_rho / p_tau (M, P) and scalar scales.  The max runs over the whole
(padded) port width: padded ports hold zeros and real loads are >= 0, so
it equals the reference's -inf-masked max whenever a member has a real
port.

The kernel cuts the q axis into chunks of 32, sums each chunk as an
in-order f32 FMA chain from 0 and adds the chunk sums in chunk order, so
its association depends on M alone: `lp_terms` and any member of
`lp_terms_batch` give the same bits, and a call repeats its bits.  The
plain twin sums in PyTorch's order.  Every summand is >= 0 and each sum
passes a summand through at most M roundings, so each is within (M-1) u of
the exact value relative (u = 2**-24), and the two agree to `rtol(M)` =
2 M u + 2 u (the last term covers the scale's rounding).

`plan` picks the kernel's tiles from (B, M, P) and the card's SM count
(the source note of ``csrc/lp_terms.cu`` says why): a grid of (member, m
tile, p tile) blocks; up to `WHOLE_PORTS` ports one p tile holds every
port and the row max and scale are fused (one launch); past it p tiles of
`SPLIT_PORTS` merge their scaled maxima by an atomic max into outputs the
wrapper fills with -inf first.  `tiles` builds any other tiling, which
the wrappers take as ``tiling`` in place of `plan`'s.

CUDA tensors launch the hand-written kernels (``csrc/lp_terms.cu``, f32
FMAs on CUDA cores: no TF32, no library product) or raise; CPU tensors
take `lp_terms_batch_plain` and `lp_terms_plain`.  `LAUNCHES` counts calls
of the batched kernel, `SINGLE_LAUNCHES` those of the single-instance one.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from repro_torch.kernels.common import launch, refuse_grad, sm_count, stream_of

__all__ = [
    "lp_terms_batch", "lp_terms_batch_plain", "lp_terms", "lp_terms_plain",
    "plan", "tiles", "Plan", "rtol", "LAUNCHES", "SINGLE_LAUNCHES",
    "CHUNK", "WHOLE_PORTS", "SPLIT_PORTS",
]

#: `lp_terms_batch` kernel launches in this process (CPU calls are not
#: counted).
LAUNCHES = 0
#: `lp_terms` kernel launches in this process (CPU calls are not counted).
SINGLE_LAUNCHES = 0

#: Contraction rows per chunk: one in-order FMA chain.
CHUNK = 32
#: Up to this many ports one block holds all of a row's ports.
WHOLE_PORTS = 64
#: Ports per block past `WHOLE_PORTS`.
SPLIT_PORTS = 32
# Ports per thread, chunk groups per block, threads per block (the
# kernel's launch bound), as in the source.
_THREAD_PORTS = 4
_MAX_GROUPS = 4
_MAX_THREADS = 512


@dataclass(frozen=True)
class Plan:
    """A call's tiles: blocks of ``rows`` coflows x ``ports`` ports, each
    thread ``rows_per_thread`` (1 or 2) x 4 of them; ``groups`` chunk
    groups per block run the ``rounds`` rounds, each round's q rows staged
    in ``stage_rows`` rows of shared memory (twice, double-buffered, when
    ``rounds > 1``); ``smem`` bytes a block.  The C entries take (rows,
    ports, rows_per_thread, groups) and derive the rest themselves
    (``lp_terms_smem`` reports their shared-memory count)."""

    rows: int
    ports: int
    rows_per_thread: int
    groups: int
    rounds: int
    stage_rows: int
    grid: tuple[int, int, int]
    threads: int
    split: bool
    smem: int


@functools.lru_cache(maxsize=None)
def plan(B: int, M: int, P: int, num_sms: int) -> Plan:
    """The tiles of a call on a card with ``num_sms`` SMs (module doc).

    All q chunks run side by side in one round where there are at most
    4; past that 2 groups walk the rounds, double-buffered.  A block takes
    32, 16 or 8 rows, the most that still give ``num_sms / 2`` blocks (one
    round: each block's load and single chunk are latency, so fewer,
    fuller blocks win) or ``2 num_sms`` (several rounds: throughput, so
    enough blocks to even out the SMs); a thread takes 2 rows, or 1 where
    even 8-row blocks leave half the SMs idle."""
    chunks = -(-M // CHUNK)
    groups = chunks if chunks <= _MAX_GROUPS else 2
    p_tiles = -(-P // _ports(P))
    one_round = chunks <= groups
    want = num_sms // 2 if one_round else 2 * num_sms
    for rows in (32, 16, 8):
        if B * -(-M // rows) * p_tiles >= want:
            break
    rows_per_thread = 2 if B * -(-M // 8) * p_tiles >= num_sms // 2 else 1
    p = tiles(B, M, P, rows, rows_per_thread, groups)
    while p.threads > _MAX_THREADS:
        rows //= 2
        p = tiles(B, M, P, rows, rows_per_thread, groups)
    return p


def _ports(P: int) -> int:
    width = -(-P // _THREAD_PORTS) * _THREAD_PORTS
    return width if width <= WHOLE_PORTS else SPLIT_PORTS


def tiles(B: int, M: int, P: int, rows: int, rows_per_thread: int, groups: int) -> Plan:
    """The plan of blocks of ``rows`` coflows, ``rows_per_thread`` a
    thread, at most ``groups`` chunk groups; the rest follows from the
    shape."""
    chunks = -(-M // CHUNK)
    groups = min(groups, chunks)
    rounds = -(-chunks // groups)
    ports = _ports(P)
    stage_rows = M if rounds == 1 else groups * CHUNK
    stages = 1 if rounds == 1 else 2
    smem = 4 * (stages * stage_rows * (rows + 2 * ports)
                + (groups - 1) * 2 * rows * ports
                + 2 * rows * (ports // _THREAD_PORTS))
    threads = groups * (rows // rows_per_thread) * (ports // _THREAD_PORTS)
    p_tiles = -(-P // ports)
    return Plan(rows, ports, rows_per_thread, groups, rounds, stage_rows,
                (B, -(-M // rows), p_tiles), threads, p_tiles > 1, smem)


def _on_cuda(name: str, operands: tuple[torch.Tensor, ...], P: int) -> bool:
    """Check what both kernels need of their tensor operands; True for
    CUDA tensors (launch the kernel), False for CPU ones (plain twin)."""
    x = operands[0]
    if any(t.dtype != torch.float32 for t in operands):
        raise TypeError(f"{name}: every operand must be float32")
    if any(t.device != x.device for t in operands):
        raise ValueError(f"{name}: operands must share one device")
    if P < 1:
        raise ValueError(f"{name}: need P >= 1 ports, got {P}")
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if not all(t.is_contiguous() for t in operands):
        raise ValueError(f"{name}: operands must be contiguous")
    refuse_grad(name, *operands)
    return True


def rtol(num_coflows: int) -> float:
    """Relative tolerance between kernel and plain twin at M coflows."""
    return (2 * num_coflows + 2) * 2.0**-24


def lp_terms_batch_plain(
    x: torch.Tensor,
    p_rho: torch.Tensor,
    p_tau: torch.Tensor,
    inv_R: torch.Tensor,
    delta_over_K: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin (``lp_terms_batch_ref``'s einsum as a broadcast
    product and sum -- no matrix-product library call)."""
    xq = x.unsqueeze(3)  # (B, q, m, 1)
    load = (xq * p_rho.unsqueeze(2)).sum(dim=1)  # (B, m, P)
    rec = (xq * p_tau.unsqueeze(2)).sum(dim=1)
    return (
        load.amax(dim=2) * inv_R[:, None],
        rec.amax(dim=2) * delta_over_K[:, None],
    )


def lp_terms_batch(
    x: torch.Tensor,
    p_rho: torch.Tensor,
    p_tau: torch.Tensor,
    inv_R: torch.Tensor,
    delta_over_K: torch.Tensor,
    *,
    tiling: Plan | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused batched LP terms: ((B, M) t_load, (B, M) t_rec), f32.

    ``tiling`` (a `tiles` result) replaces `plan`'s tiles on the card; the
    C entry refuses tiles that do not fit the shape.
    """
    global LAUNCHES
    if x.dim() != 3 or x.shape[1] != x.shape[2]:
        raise ValueError(f"lp_terms_batch: x must be (B, M, M), got {tuple(x.shape)}")
    B, M, _ = x.shape
    if p_rho.dim() != 3 or tuple(p_rho.shape[:2]) != (B, M):
        raise ValueError(
            f"lp_terms_batch: p_rho must be (B, M, P) with (B, M) = {(B, M)}, "
            f"got {tuple(p_rho.shape)}"
        )
    P = p_rho.shape[2]
    if p_tau.shape != p_rho.shape:
        raise ValueError("lp_terms_batch: p_tau must match p_rho's shape")
    if inv_R.shape != (B,) or delta_over_K.shape != (B,):
        raise ValueError("lp_terms_batch: scales must be (B,)")
    operands = (x, p_rho, p_tau, inv_R, delta_over_K)
    if not _on_cuda("lp_terms_batch", operands, P):
        return lp_terms_batch_plain(*operands)
    device = x.device
    if P > WHOLE_PORTS:  # p split: the blocks merge by an atomic max
        t_load = torch.full((B, M), -torch.inf, dtype=torch.float32, device=device)
        t_rec = torch.full((B, M), -torch.inf, dtype=torch.float32, device=device)
    else:
        t_load = torch.empty((B, M), dtype=torch.float32, device=device)
        t_rec = torch.empty((B, M), dtype=torch.float32, device=device)
    if B and M:
        p = tiling if tiling is not None else plan(B, M, P, sm_count(device))
        launch(
            "lp_terms_batch", *(t.data_ptr() for t in operands),
            t_load.data_ptr(), t_rec.data_ptr(), B, M, P,
            p.rows, p.ports, p.rows_per_thread, p.groups, stream_of(x),
            device=x.device,
        )
        LAUNCHES += 1
    return t_load, t_rec


def lp_terms_plain(
    x: torch.Tensor,
    p_rho: torch.Tensor,
    p_tau: torch.Tensor,
    inv_R: float,
    delta_over_K: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin (``lp_terms_ref``'s products as a broadcast
    product and sum -- no matrix-product library call)."""
    xq = x.unsqueeze(2)  # (q, m, 1)
    load = (xq * p_rho.unsqueeze(1)).sum(dim=0)  # (m, P)
    rec = (xq * p_tau.unsqueeze(1)).sum(dim=0)
    return load.amax(dim=1) * inv_R, rec.amax(dim=1) * delta_over_K


def lp_terms(
    x: torch.Tensor,
    p_rho: torch.Tensor,
    p_tau: torch.Tensor,
    inv_R: float,
    delta_over_K: float,
    *,
    tiling: Plan | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused LP terms of one instance: ((M,) t_load, (M,) t_rec), f32.

    ``inv_R`` and ``delta_over_K`` are Python floats, rounded to f32 as
    the reference's static scales are.  ``tiling`` as for
    `lp_terms_batch`, with B = 1.
    """
    global SINGLE_LAUNCHES
    if x.dim() != 2 or x.shape[0] != x.shape[1]:
        raise ValueError(f"lp_terms: x must be (M, M), got {tuple(x.shape)}")
    M = x.shape[0]
    if p_rho.dim() != 2 or p_rho.shape[0] != M:
        raise ValueError(
            f"lp_terms: p_rho must be (M, P) with M = {M}, got {tuple(p_rho.shape)}"
        )
    P = p_rho.shape[1]
    if p_tau.shape != p_rho.shape:
        raise ValueError("lp_terms: p_tau must match p_rho's shape")
    operands = (x, p_rho, p_tau)
    if not _on_cuda("lp_terms", operands, P):
        return lp_terms_plain(*operands, inv_R, delta_over_K)
    device = x.device
    if P > WHOLE_PORTS:  # p split: the blocks merge by an atomic max
        t_load = torch.full((M,), -torch.inf, dtype=torch.float32, device=device)
        t_rec = torch.full((M,), -torch.inf, dtype=torch.float32, device=device)
    else:
        t_load = torch.empty(M, dtype=torch.float32, device=device)
        t_rec = torch.empty(M, dtype=torch.float32, device=device)
    if M:
        p = tiling if tiling is not None else plan(1, M, P, sm_count(device))
        launch(
            "lp_terms", *(t.data_ptr() for t in operands), float(inv_R),
            float(delta_over_K), t_load.data_ptr(), t_rec.data_ptr(), M, P,
            p.rows, p.ports, p.rows_per_thread, p.groups, stream_of(x),
            device=x.device,
        )
        SINGLE_LAUNCHES += 1
    return t_load, t_rec
