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

CUDA tensors launch the hand-written kernel (``csrc/event_resolve.cu``);
CPU tensors take `event_resolve_plain`.  `LAUNCHES` counts kernel launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.common import launch, refuse_grad, stream_of

__all__ = ["event_resolve", "event_resolve_plain", "LAUNCHES"]

#: Kernel launches in this process (CPU calls are not counted).
LAUNCHES = 0

# Shared memory holds 2N first claimers and one idle bit per flow, in
# 32-bit words, within the 227 KB (232,448 bytes) of a Hopper block.
_MAX_SHARED_BYTES = 232_448

_DISCIPLINES = ("reserving", "greedy")


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
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(G, F) int32 ports, f64 releases and bool pending + (G, N) f64 port
    free times + (G,) f64 instants -> (start, first_in, first_out,
    blocked)."""
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
    shared = (2 * N + -(-F // 32)) * 4
    if shared > _MAX_SHARED_BYTES:
        raise ValueError(
            f"event_resolve: {F} flows and {N} ports need {shared} bytes of "
            f"shared memory, more than a block's {_MAX_SHARED_BYTES}"
        )
    start = torch.empty_like(pending)
    first_in = torch.empty((G, N), dtype=torch.int32, device=src.device)
    first_out = torch.empty_like(first_in)
    blocked = torch.empty((G,), dtype=torch.bool, device=src.device)
    if G:
        launch(
            "event_resolve", *(x.data_ptr() for x in ops), start.data_ptr(),
            first_in.data_ptr(), first_out.data_ptr(), blocked.data_ptr(),
            G, F, N, int(discipline == "reserving"), stream_of(src),
        )
        LAUNCHES += 1
    return start, first_in, first_out, blocked
