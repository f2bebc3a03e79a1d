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

The port runs on one card, so `compressed_allreduce` is the quantize /
dequantize round trip (what the reference computes under plain pjit) and
takes no ``axis_name``.  The reference's ``use_kernel=`` flags have no
counterpart: the tensors' device decides.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch

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


def compressed_allreduce(
    grads: Any, errors: Any, noise: Noise, axis_name: str | None = None
) -> tuple[Any, Any]:
    """int8 exchange with error feedback on one card: (restored grads,
    new errors)."""
    if axis_name is not None:
        raise NotImplementedError(
            f"compressed_allreduce: axis_name={axis_name!r}: the port runs on one "
            f"card, with no cross-device reduction"
        )
    payload, new_err = compress_tree(grads, errors, noise)
    return decompress_tree(payload, grads), new_err
