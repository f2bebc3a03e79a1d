"""Gradient compression for the gradient exchange: int8 with error feedback.

Port of `repro.runtime.compression`.  Each leaf's gradient plus its
carried error is quantized to int8 in rows of 512 (`repro_torch.kernels.
quant`: the `quantize` kernel on the card), dequantized again (the
`dequantize` kernel) for the residual that becomes the next step's error,
and, on the receiving side, dequantized once more: per compressed step,
one `quantize` and two `dequantize` launches per leaf.

Trees are nested dicts and lists of tensors (`repro_torch.tree`; leaves in
``jax.tree`` order).  The stochastic-rounding noise comes from the caller:
a `torch.Generator` that draws each leaf's (rows, 512) noise in leaf
order, or a list of one noise tensor per leaf.  The port cannot draw
``jax.random``'s numbers, so tests pass the reference's noise in.

`compressed_allreduce` without ``axis_name`` is the quantize / dequantize
round trip (what the reference computes under plain pjit).  With
``axis_name`` (a mesh axis, ``"data"``) it sums the int8 payloads over the
process group `repro_torch.launch.mesh.init_distributed` brought up -- the
world group -- as the reference's ``psum`` over the axis does: the int8
leaves only, in int8, so a sum past 127 wraps (gloo wraps as ``jnp.int8``
does: 100 + 100 = -56), while each rank's scales and ``n`` stay its own and
dequantize the summed codes.  gloo sums host tensors, so a payload on a
card goes through pinned host memory and back.  With no process group up
it raises; it never falls back to one card.  The reference's
``use_kernel=`` flags have no counterpart: the tensors' device decides.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch
import torch.distributed as dist

from repro_torch import tree
from repro_torch.kernels.quant import dequantize_flat, quantize_flat

__all__ = [
    "init_error_feedback", "compress_tree", "decompress_tree", "compressed_allreduce",
]

Noise = torch.Generator | Sequence[torch.Tensor]


def init_error_feedback(params: Any) -> Any:
    """Zero f32 errors shaped like ``params``, on their devices."""
    return tree.map_leaves(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params
    )


def _per_leaf(noise: Noise, count: int) -> list:
    if isinstance(noise, torch.Generator):
        return [noise] * count
    noise = list(noise)
    if len(noise) != count:
        raise ValueError(f"compress_tree: {len(noise)} noise tensors for {count} leaves")
    return noise


def compress_tree(grads: Any, errors: Any, noise: Noise) -> tuple[Any, Any]:
    """Quantize (grads + errors) per leaf; returns (payload, new_errors).

    Payload leaves are (q int8 (rows, 512), scales (rows,), n) triples.
    """
    leaves = tree.leaves(grads)
    payload, new_err = [], []
    for g, e, nz in zip(leaves, tree.leaves(errors), _per_leaf(noise, len(leaves))):
        g32 = g.to(torch.float32) + e
        q, s, n = quantize_flat(g32.reshape(-1), nz)
        deq = dequantize_flat(q, s, n).view(g.shape)
        payload.append((q, s, n))
        new_err.append(g32 - deq)  # residual -> next step
    return tree.unflatten(grads, payload), tree.unflatten(grads, new_err)


def decompress_tree(payload: Any, like: Any) -> Any:
    """Dequantize every payload triple into ``like``'s shapes and dtypes."""
    return tree.map_leaves(
        lambda p, ref: dequantize_flat(*p).view(ref.shape).to(ref.dtype), payload, like
    )


def _allreduce_int8(payload: Any, axis_name: str) -> Any:
    """``payload`` with every int8 code tensor summed over the ranks of
    ``axis_name``'s process group, in int8 (wrapping); scales and ``n``
    untouched.  One collective for the whole tree: the codes go flat into
    one buffer (pinned host memory where they lie on a card)."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            f"compressed_allreduce(axis_name={axis_name!r}): no process group is up; "
            f"call repro_torch.launch.mesh.init_distributed first"
        )
    leaves = tree.leaves(payload)
    codes = [q for q, _, _ in leaves]
    if not codes:
        return payload
    flat = torch.cat([q.reshape(-1) for q in codes])
    wire = flat
    if flat.device.type == "cuda" and dist.get_backend() == "gloo":
        wire = torch.empty(flat.shape, dtype=torch.int8, pin_memory=True)
        wire.copy_(flat)
    dist.all_reduce(wire, op=dist.ReduceOp.SUM)
    if wire is not flat:
        flat.copy_(wire)
    out, start = [], 0
    for q, s, n in leaves:
        out.append((flat[start:start + q.numel()].view(q.shape), s, n))
        start += q.numel()
    return tree.unflatten(payload, out)


def compressed_allreduce(
    grads: Any, errors: Any, noise: Noise, axis_name: str | None = None
) -> tuple[Any, Any]:
    """int8 exchange with error feedback: (restored grads, new errors).
    With ``axis_name`` the int8 payloads are summed over the process group
    first (`_allreduce_int8`); without it, the round trip on one device."""
    payload, new_err = compress_tree(grads, errors, noise)
    if axis_name is not None:
        payload = _allreduce_int8(payload, axis_name)
    return decompress_tree(payload, grads), new_err
