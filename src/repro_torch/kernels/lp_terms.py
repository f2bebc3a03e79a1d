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

Kernel and plain twin sum the M products in different orders.  Every
summand is >= 0, so each result is within (M-1) u of the exact value
relative (u = 2**-24), and the two agree to `rtol(M)` = 2 M u + 2 u
(the last term covers the scale's rounding).

CUDA tensors launch the hand-written kernels (``csrc/lp_terms.cu``, f32
FMAs on CUDA cores: no TF32, no library product); CPU tensors take
`lp_terms_batch_plain` and `lp_terms_plain`.  `LAUNCHES` counts launches of
the batched kernel, `SINGLE_LAUNCHES` those of the single-instance one.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.common import launch, refuse_grad, stream_of

__all__ = [
    "lp_terms_batch", "lp_terms_batch_plain", "lp_terms", "lp_terms_plain",
    "rtol", "LAUNCHES", "SINGLE_LAUNCHES",
]

#: `lp_terms_batch` kernel launches in this process (CPU calls are not
#: counted).
LAUNCHES = 0
#: `lp_terms` kernel launches in this process (CPU calls are not counted).
SINGLE_LAUNCHES = 0


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
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused batched LP terms: ((B, M) t_load, (B, M) t_rec), f32."""
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
    t_load = torch.empty((B, M), dtype=torch.float32, device=x.device)
    t_rec = torch.empty((B, M), dtype=torch.float32, device=x.device)
    if B and M:
        launch(
            "lp_terms_batch", *(t.data_ptr() for t in operands),
            t_load.data_ptr(), t_rec.data_ptr(), B, M, P, stream_of(x),
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
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused LP terms of one instance: ((M,) t_load, (M,) t_rec), f32.

    ``inv_R`` and ``delta_over_K`` are Python floats, rounded to f32 as
    the reference's static scales are.
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
    t_load = torch.empty(M, dtype=torch.float32, device=x.device)
    t_rec = torch.empty(M, dtype=torch.float32, device=x.device)
    if M:
        launch(
            "lp_terms", *(t.data_ptr() for t in operands), float(inv_R),
            float(delta_over_K), t_load.data_ptr(), t_rec.data_ptr(), M, P,
            stream_of(x),
        )
        SINGLE_LAUNCHES += 1
    return t_load, t_rec
