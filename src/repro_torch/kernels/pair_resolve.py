"""`pair_resolve`: one pair-space resolution round of the circuit calendar.

Port of `repro.kernels.event_resolve.pair_resolve` (the Pallas kernel
`pair_resolve_pallas`).  ``claim[g, i, j]`` is the claiming head flow id of
pair (ingress i, egress j) of member g, or any value >= the member's flow
count where no head claims; ``idle[g, i, j]`` whether the pair may start
now.  A pair starts iff it is idle and its claim is the minimum along its
row (first claimer on the ingress port) and its column (first claimer on
the egress port).  Claims are int32: exact, with no f32 id guard.

CUDA tensors launch the hand-written kernel (``csrc/pair_resolve.cu``);
CPU tensors take `pair_resolve_plain`.  `LAUNCHES` counts kernel launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.common import launch, refuse_grad, stream_of

__all__ = ["pair_resolve", "pair_resolve_plain", "LAUNCHES"]

#: Kernel launches in this process (CPU calls are not counted).
LAUNCHES = 0

# Shared memory holds the (N, N) claims plus two (N,) minima, in int32:
# (N*N + 2N) * 4 bytes within the 227 KB (232,448 bytes) of a Hopper block.
_MAX_PORTS = 240


def pair_resolve_plain(claim: torch.Tensor, idle: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin of the kernel (and of ``pair_resolve_ref``)."""
    rowmin = claim.amin(dim=2, keepdim=True)
    colmin = claim.amin(dim=1, keepdim=True)
    return idle & (claim == rowmin) & (claim == colmin)


def pair_resolve(claim: torch.Tensor, idle: torch.Tensor) -> torch.Tensor:
    """(G, N, N) int32 claims + (G, N, N) bool idle -> (G, N, N) bool starts."""
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
        launch(
            "pair_resolve", claim.data_ptr(), idle.data_ptr(),
            start.data_ptr(), G, N, stream_of(claim),
        )
        LAUNCHES += 1
    return start
