"""`flash_attention`: GQA attention forward, causal and/or sliding window.

Port of `repro.kernels.flash_attention` (the Pallas kernel
`flash_attention_pallas`, `src/repro/kernels/flash_attention/kernel.py`).
q is (B, Hq, Sq, D), k and v are (B, Hkv, Skv, D) with Hq a multiple of
Hkv; query head h reads key/value head h // (Hq // Hkv).  Query i sits at
absolute position ``q_offset + i``; key j is visible when ``j <= q_offset +
i`` (causal) and ``q_offset + i - j < window`` (window given).  Softmax
runs in f32 with scale 1/sqrt(D); the output has q's dtype.

CUDA tensors launch the hand-written kernel (``csrc/flash_attention.cu``),
in f32 or bf16 with D in {16, 32, 64, 128, 256}; the kernel takes strides,
so views such as ``x.transpose(1, 2)`` of a (B, S, H, D) tensor need no
copy, and the output takes q's layout.  CPU tensors take
`flash_attention_plain`, a copy of the reference's oracle
(``kernels/flash_attention/ref.py``).  The two differ only on a row that no
key is visible to: the kernel writes zeros there (as the Pallas kernel
does), the oracle the mean of v.  `LAUNCHES` counts kernel launches.

Where autograd records (training), the call goes through a
`torch.autograd.Function` whose backward recomputes through the twin, as
the reference's custom VJP does; the kernel never returns a result
detached from operands that require grad.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.common import launch, refuse_grad, stream_of

__all__ = ["flash_attention", "flash_attention_plain", "LAUNCHES"]

#: Kernel launches in this process (CPU calls are not counted).
LAUNCHES = 0

# Head dimensions the kernel is built for.
_HEAD_DIMS = (16, 32, 64, 128, 256)

NEG_INF = -1e30
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


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


def _strides(t: torch.Tensor, name: str) -> tuple[int, int, int]:
    """Batch, head and position strides of a kernel operand, which must
    have a contiguous last axis and 16-byte aligned rows."""
    size = t.element_size()
    if t.stride(3) != 1:
        raise ValueError(f"flash_attention: {name}'s last axis must be contiguous")
    if t.data_ptr() % 16 or any((t.stride(i) * size) % 16 for i in range(3)):
        raise ValueError(f"flash_attention: {name}'s rows must be 16-byte aligned")
    return t.stride(0), t.stride(1), t.stride(2)


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
    the backward through the plain twin (`_FlashAttention`)."""
    _check(q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, window, q_offset)
    return _forward(q, k, v, causal, window, q_offset)


def _forward(q, k, v, causal, window, q_offset) -> torch.Tensor:
    """The twin for CPU tensors, the kernel for CUDA tensors (no graph)."""
    global LAUNCHES
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, window, q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
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
    if B * Hq * Sq == 0:
        return out
    strides = [
        s for t, name in ((q, "q"), (k, "k"), (v, "v"), (out, "out"))
        for s in _strides(t, name)
    ]
    launch(
        "flash_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), _DTYPE_CODES[q.dtype], B, Hq, Hkv, Sq, Skv, D,
        *strides, int(causal), -1 if window is None else int(window),
        int(q_offset), ctypes.c_float(1.0 / D**0.5), stream_of(q),
    )
    LAUNCHES += 1
    return out
