"""`port_stats`: per-port load and nonzero counts of demand matrices.

Port of `repro.kernels.port_stats.port_stats` (the Pallas kernel
`port_stats_pallas`), held to the reference's main path rather than to the
Pallas kernel: the reference packs its LP from host f64 sums
(`repro.core.coflow.port_stats`), so both the kernel and its plain twin
read f64 demands and sum in f64 in NumPy's own order -- pairwise over a
row, a running sum down a column.  ``rho`` is therefore bit-identical to
the host NumPy value in f64 (0 ulp), and so in f32 after the cast the LP
arrays take; ``tau`` counts are exact.

Returns ``rho`` (M, 2N) f64 -- row sums (ingress ports 0..N-1), then
column sums (egress ports N..2N-1) -- and ``tau`` (M, 2N) int32.

CUDA tensors launch the hand-written kernel (``csrc/port_stats.cu``); CPU
tensors take `port_stats_plain`.  `LAUNCHES` counts kernel launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.common import launch, refuse_grad, stream_of

__all__ = ["port_stats", "port_stats_plain", "LAUNCHES"]

#: Kernel launches in this process (CPU calls are not counted).
LAUNCHES = 0

# One (N, N) f64 matrix per block in shared memory: 168^2 * 8 B fits the
# 227 KB a Hopper block can opt into.
_MAX_PORTS = 168


def _pairwise_last(d: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in NumPy's pairwise order (n <= 256)."""
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
    """Plain PyTorch twin of the kernel, in the same summation order."""
    cols = torch.zeros(
        (demands.shape[0], demands.shape[2]), dtype=demands.dtype,
        device=demands.device,
    )
    for i in range(demands.shape[1]):
        cols = cols + demands[:, i, :]
    rho = torch.cat([_pairwise_last(demands), cols], dim=1)
    nz = demands > 0
    tau = torch.cat([nz.sum(dim=2), nz.sum(dim=1)], dim=1).to(torch.int32)
    return rho, tau


def port_stats(demands: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(M, N, N) f64 demands -> (rho (M, 2N) f64, tau (M, 2N) int32)."""
    global LAUNCHES
    if demands.dim() != 3 or demands.shape[1] != demands.shape[2]:
        raise ValueError(
            f"port_stats: demands must be (M, N, N), got {tuple(demands.shape)}"
        )
    if demands.dtype != torch.float64:
        raise TypeError(f"port_stats: demands must be float64, got {demands.dtype}")
    M, N, _ = demands.shape
    if N > _MAX_PORTS:
        raise ValueError(f"port_stats: at most {_MAX_PORTS} ports, got {N}")
    if demands.device.type == "cpu":
        return port_stats_plain(demands)
    if demands.device.type != "cuda":
        raise ValueError(f"port_stats: unsupported device {demands.device}")
    if not demands.is_contiguous():
        raise ValueError("port_stats: demands must be contiguous")
    refuse_grad("port_stats", demands)
    rho = torch.empty((M, 2 * N), dtype=torch.float64, device=demands.device)
    tau = torch.empty((M, 2 * N), dtype=torch.int32, device=demands.device)
    if M and N:
        launch(
            "port_stats", demands.data_ptr(), rho.data_ptr(), tau.data_ptr(),
            M, N, stream_of(demands),
        )
        LAUNCHES += 1
    return rho, tau
