"""`flash_attention`: GQA attention forward, causal and/or sliding window.

Port of `repro.kernels.flash_attention` (the Pallas kernel
`flash_attention_pallas`, `src/repro/kernels/flash_attention/kernel.py`).
q is (B, Hq, Sq, D), k and v are (B, Hkv, Skv, D) with Hq a multiple of
Hkv; query head h reads key/value head h // (Hq // Hkv).  Query i sits at
absolute position ``q_offset + i``; key j is visible when ``j <= q_offset +
i`` (causal) and ``q_offset + i - j < window`` (window given).  Softmax
runs in f32 with scale 1/sqrt(D); the output has q's dtype.

CUDA tensors launch the hand-written kernels (``csrc/flash_attention.cu``),
in f32 or bf16 with D in {16, 32, 64, 128, 256}; the kernels take strides,
so views such as ``x.transpose(1, 2)`` of a (B, S, H, D) tensor need no
copy, and the output takes q's layout.  CPU tensors take
`flash_attention_plain`, a copy of the reference's oracle
(``kernels/flash_attention/ref.py``), its result copied into q's layout.
The two differ only on a row that no key is visible to: the kernels write
zeros there (as the Pallas kernel does), the oracle the mean of v.

`plan` picks the route of a call from its shape and dtype alone, over the
R = (Hq // Hkv) * Sq rows of one (batch, kv head):

* ``"split"`` when R <= `SPLIT_ROWS` (decode, either dtype): the tiled
  kernels would run one block per (batch, kv head), B * Hkv blocks (4 of
  132 SMs for gemma3-1b's decode), so the live key band is cut into runs
  of whole `SPLIT_KEYS`-key tiles, enough that B * Hkv * n_split blocks
  fill the SMs; one block per run writes partials to f32 scratch, and a
  second kernel merges them in run order (same inputs, same bits);
* ``"mma"`` for bf16 with R > SPLIT_ROWS (prefill, training): bf16
  tensor-core products, 64 rows a block (the last block of a (batch, kv
  head) may hold fewer);
* ``"simt"`` for f32 with R > SPLIT_ROWS (f32 prefill): f32 products on
  CUDA cores.

`LAUNCHES` counts one per call that reaches a kernel, whatever number of
CUDA kernels the route launches (the split route launches two).

``meta`` tensors (the launch tooling's dry-run) take the meta route: the
kernel's checks, then an empty output of q's shape and dtype, nothing
computed.  `cost` gives the call's operations and bytes; under an active
operation count every route adds it (`kernels.common.kernel_work`).

Where autograd records (training), the call goes through a
`torch.autograd.Function` whose backward recomputes through the twin, as
the reference's custom VJP does; the kernel never returns a result
detached from operands that require grad.

DTensor operands (a model partitioned over a `DeviceMesh`) enter through
`kernels.common.on_local_blocks`: batch split as the operands split it,
heads split where q, k and v split them alike (else replicated: each
device repeats the attention of its batch), anything else -- a sequence-
sharded cache -- gathered first; the call then runs (and `cost` counts)
on each device's blocks.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.kernels.common import (
    is_dtensor, kernel_work, launch, on_local_blocks, refuse_grad, sm_count, stream_of,
)

__all__ = [
    "flash_attention", "flash_attention_plain", "live_band", "live_pairs", "cost", "plan",
    "Plan", "LAUNCHES", "SPLIT_KEYS", "SPLIT_ROWS",
]

#: Calls that reached a kernel in this process (CPU calls are not counted).
LAUNCHES = 0

#: Rows per (batch, kv head) that one split-route block holds.
SPLIT_ROWS = 16
#: Keys of the split route's tile; every run is a whole number of tiles.
SPLIT_KEYS = 32

# Head dimensions the kernels are built for.
_HEAD_DIMS = (16, 32, 64, 128, 256)

NEG_INF = -1e30
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ROUTE_CODES = {"simt": 0, "mma": 1, "split": 2}


@dataclass(frozen=True)
class Plan:
    """A call's route; for ``"split"``, run s covers the keys
    ``[begin + s * length, begin + (s + 1) * length)``, s < n_split."""

    route: str
    n_split: int = 1
    begin: int = 0
    length: int = 0


def live_band(Sq: int, Skv: int, causal: bool, window: int | None,
              q_offset: int) -> tuple[int, int]:
    """The key positions [lo, hi) visible to some query 0 <= i < Sq
    (empty as lo == hi)."""
    lo = 0 if window is None else max(0, q_offset - window + 1)
    hi = min(Skv, q_offset + Sq) if causal else Skv
    return (lo, hi) if hi > lo else (0, 0)


def live_pairs(Sq: int, Skv: int, causal: bool, window: int | None, q_offset: int) -> int:
    """The (query, key) pairs with the key visible to the query, over one
    (batch, query head)."""
    hi = np.full(Sq, Skv)
    pos = q_offset + np.arange(Sq)
    if causal:
        hi = np.minimum(hi, pos + 1)
    lo = np.zeros(Sq, dtype=np.int64) if window is None else np.maximum(0, pos - window + 1)
    return int(np.maximum(hi - lo, 0).sum())


def cost(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
         window: int | None = None, q_offset: int = 0) -> tuple[float, float]:
    """(operations, bytes) of one call: 2 products x 2 flops x D per live
    pair and query head; q read and the output written once, each key and
    value row of the live band (`live_band`) read once per kv head."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    lo, hi = live_band(Sq, Skv, causal, window, q_offset)
    flops = 4 * D * live_pairs(Sq, Skv, causal, window, q_offset) * B * Hq
    nbytes = q.element_size() * (2 * B * Hq * Sq * D + 2 * B * Hkv * (hi - lo) * D)
    return float(flops), float(nbytes)


def plan(dtype: torch.dtype, B: int, Hq: int, Hkv: int, Sq: int, Skv: int,
         causal: bool, window: int | None, q_offset: int, num_sms: int) -> Plan:
    """The route of a call on a card with ``num_sms`` SMs (module doc)."""
    rows = Hq // Hkv * Sq
    if rows <= SPLIT_ROWS:
        lo, hi = live_band(Sq, Skv, causal, window, q_offset)
        tiles = -(-(hi - lo) // SPLIT_KEYS)
        if tiles == 0:
            return Plan("split")
        want = -(-num_sms // (B * Hkv))
        per_run = -(-tiles // min(want, tiles))
        return Plan("split", -(-tiles // per_run), lo, per_run * SPLIT_KEYS)
    return Plan("mma" if dtype == torch.bfloat16 else "simt")


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    window: int | None = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: repeat KV, einsum, mask, softmax in
    f32, cast to q's dtype (the reference's ``attention_ref``)."""
    Sq, D = q.shape[2], q.shape[3]
    Skv = k.shape[2]
    group = q.shape[1] // k.shape[1]
    kk = k.repeat_interleave(group, dim=1)
    vv = v.repeat_interleave(group, dim=1)
    logits = torch.einsum(
        "bhqd,bhkd->bhqk", q.to(torch.float32), kk.to(torch.float32)
    ) / torch.sqrt(torch.tensor(D, dtype=torch.float32))
    qi = q_offset + torch.arange(Sq, device=q.device)[:, None]
    kj = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qi >= kj
    if window is not None:
        mask &= (qi - kj) < window
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    probs = probs / probs.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, vv.to(torch.float32))
    return out.to(q.dtype)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(
            f"flash_attention: q must be (B, Hq, Sq, D) and k, v (B, Hkv, Skv, D), "
            f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    B, Hq, _, D = q.shape
    if k.shape[0] != B or k.shape[3] != D:
        raise ValueError("flash_attention: q and k/v differ in batch or head dim")
    if k.shape[1] == 0 or Hq % k.shape[1]:
        raise ValueError(f"flash_attention: Hq={Hq} not a multiple of Hkv={k.shape[1]}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"flash_attention: dtypes differ ({q.dtype}, {k.dtype}, {v.dtype})")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k and v must share a device")


def _operand(t: torch.Tensor, name: str) -> tuple[int, int, int, int]:
    """Pointer and batch, head and position strides of a kernel operand,
    which must have a contiguous last axis and 16-byte aligned rows."""
    ptr, size, (sb, sh, ss, sd) = t.data_ptr(), t.element_size(), t.stride()
    if sd != 1:
        raise ValueError(f"flash_attention: {name}'s last axis must be contiguous")
    if ptr % 16 or (sb * size) % 16 or (sh * size) % 16 or (ss * size) % 16:
        raise ValueError(f"flash_attention: {name}'s rows must be 16-byte aligned")
    return ptr, sb, sh, ss


class _FlashAttention(torch.autograd.Function):
    """Forward through `_forward` (the kernel on the card, the twin on the
    host); backward by recomputing through `flash_attention_plain` under
    autograd, as the reference's ``_bwd`` recomputes through
    ``attention_ref`` (``kernels/flash_attention/ops.py``).  No backward
    kernel: the reference has none."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset):
        ctx.save_for_backward(q, k, v)
        ctx.mask = (causal, window, q_offset)
        return _forward(q, k, v, causal, window, q_offset)

    @staticmethod
    def backward(ctx, grad):
        with torch.enable_grad():
            q, k, v = (t.detach().requires_grad_() for t in ctx.saved_tensors)
            out = flash_attention_plain(q, k, v, *ctx.mask)
            dq, dk, dv = torch.autograd.grad(out, (q, k, v), grad)
        return dq, dk, dv, None, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    window: int | None = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """q: (B, Hq, Sq, D); k/v: (B, Hkv, Skv, D) -> (B, Hq, Sq, D) in q's
    dtype.  Differentiable where autograd records: the forward as below,
    the backward through the plain twin (`_FlashAttention`); DTensors on
    each device's blocks (module doc)."""
    if is_dtensor(q) or is_dtensor(k) or is_dtensor(v):
        return on_local_blocks(
            lambda q, k, v: flash_attention(q, k, v, causal, window, q_offset),
            (q, k, v), 1, keep=(0, 1))
    _check(q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, window, q_offset)
    return _forward(q, k, v, causal, window, q_offset)


def _forward(q, k, v, causal, window, q_offset) -> torch.Tensor:
    """The twin for CPU tensors, the kernel for CUDA tensors, an empty
    output for meta tensors (no graph); its `cost` added to an active
    count."""
    with kernel_work("flash_attention", cost, q, k, v, causal, window, q_offset):
        return _route(q, k, v, causal, window, q_offset)


def _route(q, k, v, causal, window, q_offset) -> torch.Tensor:
    global LAUNCHES
    if q.device.type == "cpu":
        # In q's layout, as the kernel writes it: the layers after see the
        # same strides (and issue the same copies) on every device.
        out = flash_attention_plain(q, k, v, causal, window, q_offset)
        return torch.empty_like(q).copy_(out)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if q.device.type == "cuda":
        refuse_grad("flash_attention", q, k, v)
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash_attention: float32 or bfloat16, got {q.dtype}")
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if D not in _HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D} not in {_HEAD_DIMS}")
    if window is not None and window < 0:
        raise ValueError(f"flash_attention: window must be >= 0, got {window}")
    out = torch.empty_like(q)  # q's layout (strides) where q is dense
    if B * Hq * Sq == 0 or q.device.type == "meta":
        return out
    ops = [_operand(t, name) for t, name in ((q, "q"), (k, "k"), (v, "v"), (out, "out"))]
    p = plan(q.dtype, B, Hq, Hkv, Sq, Skv, causal, window, q_offset, sm_count(q.device))
    scratch = None  # held until the launch is queued
    if p.route == "split":  # (m, l, acc[D]) in f32 per run and row
        scratch = torch.empty(
            B * Hq * Sq * p.n_split * (D + 2), dtype=torch.float32, device=q.device
        )
    launch(
        "flash_attention", ops[0][0], ops[1][0], ops[2][0], ops[3][0],
        None if scratch is None else scratch.data_ptr(),
        _DTYPE_CODES[q.dtype], B, Hq, Hkv, Sq, Skv, D,
        *(s for op in ops for s in op[1:]), int(causal),
        -1 if window is None else int(window), int(q_offset),
        ctypes.c_float(1.0 / D**0.5), _ROUTE_CODES[p.route],
        p.n_split, p.begin, p.length, stream_of(q), device=q.device,
    )
    LAUNCHES += 1
    return out
