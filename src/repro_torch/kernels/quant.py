"""`quantize` / `dequantize`: per-row int8 quantization with stochastic
rounding, and its inverse.

Port of `repro.kernels.quant` (the Pallas kernels `quantize_pallas` and
`dequantize_pallas`, `src/repro/kernels/quant/kernel.py`, and the flat API
of its ``ops.py``).  For x and noise (R, C) f32, noise uniform in [0, 1):

    scale = max(max|x| / 127, 1e-30)                      per row, (R,) f32
    q     = clip(floor(x / scale + noise), -127, 127)     (R, C) int8

and ``dequantize(q, scale) = q * scale[:, None]`` in f32.  Every step is
one IEEE f32 operation, so the kernels, their plain twins, the reference's
``quantize_ref`` / ``dequantize_ref`` and its interpret-mode Pallas kernels
agree bit for bit given the same noise.

CUDA tensors launch the hand-written kernels (``csrc/quant.cu``; the
design and what bounds them are in the source); CPU tensors take
`quantize_plain` / `dequantize_plain`.  `LAUNCHES_QUANTIZE` and
`LAUNCHES_DEQUANTIZE` count kernel launches.  The reference's
``use_kernel=`` switches have no counterpart: the tensor's device decides.

The noise is an argument (or a `torch.Generator` that draws it): the port
cannot reproduce ``jax.random``, so the tests hand both packages the same
numbers.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.common import launch, refuse_grad, stream_of

__all__ = [
    "CHUNK", "LAUNCHES_QUANTIZE", "LAUNCHES_DEQUANTIZE", "quantize", "dequantize",
    "quantize_plain", "dequantize_plain", "quantize_flat", "dequantize_flat", "flat_rows",
]

#: Kernel launches in this process (CPU calls are not counted).
LAUNCHES_QUANTIZE = 0
LAUNCHES_DEQUANTIZE = 0

#: Per-row quantization group of flat buffers (the reference's ``CHUNK``).
CHUNK = 512


def quantize_plain(x: torch.Tensor, noise: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of the quantize kernel (``quantize_ref``)."""
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=1)
    # A tensor divisor: PyTorch's CUDA division by a Python scalar
    # multiplies by the scalar's rounded reciprocal, not IEEE division.
    scale = torch.clamp(amax / torch.full_like(amax, 127.0), min=1e-30)
    q = torch.floor(xf / scale[:, None] + noise.to(torch.float32))
    return torch.clamp(q, -127, 127).to(torch.int8), scale


def dequantize_plain(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin of the dequantize kernel (``dequantize_ref``)."""
    return q.to(torch.float32) * scale.to(torch.float32)[:, None]


def _device_of(name: str, *tensors: torch.Tensor) -> str:
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: operands must share one device")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev.type


def quantize(x: torch.Tensor, noise: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x, noise: (R, C) f32 -> (q int8 (R, C), scale f32 (R,))."""
    global LAUNCHES_QUANTIZE
    if x.dim() != 2 or noise.shape != x.shape:
        raise ValueError(
            f"quantize: x and noise must be (R, C) of one shape, got "
            f"{tuple(x.shape)} and {tuple(noise.shape)}"
        )
    if x.dtype != torch.float32 or noise.dtype != torch.float32:
        raise TypeError(f"quantize: x and noise must be float32, got {x.dtype}, {noise.dtype}")
    if _device_of("quantize", x, noise) == "cpu":
        return quantize_plain(x, noise)
    refuse_grad("quantize", x, noise)
    x, noise = x.contiguous(), noise.contiguous()
    R, C = x.shape
    q = torch.empty((R, C), dtype=torch.int8, device=x.device)
    scale = torch.empty((R,), dtype=torch.float32, device=x.device)
    if R and C:
        launch("quantize", x.data_ptr(), noise.data_ptr(), q.data_ptr(),
               scale.data_ptr(), R, C, stream_of(x), device=x.device)
        LAUNCHES_QUANTIZE += 1
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """q: (R, C) int8, scale: (R,) f32 -> (R, C) f32."""
    global LAUNCHES_DEQUANTIZE
    if q.dim() != 2 or scale.shape != q.shape[:1]:
        raise ValueError(
            f"dequantize: q must be (R, C) and scale (R,), got {tuple(q.shape)} "
            f"and {tuple(scale.shape)}"
        )
    if q.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError(f"dequantize: q int8 and scale float32, got {q.dtype}, {scale.dtype}")
    if _device_of("dequantize", q, scale) == "cpu":
        return dequantize_plain(q, scale)
    refuse_grad("dequantize", scale)
    q, scale = q.contiguous(), scale.contiguous()
    R, C = q.shape
    out = torch.empty((R, C), dtype=torch.float32, device=q.device)
    if R and C:
        launch("dequantize", q.data_ptr(), scale.data_ptr(), out.data_ptr(), R, C,
               stream_of(q), device=q.device)
        LAUNCHES_DEQUANTIZE += 1
    return out


def flat_rows(n: int) -> int:
    """Rows of `CHUNK` that a flat buffer of ``n`` values takes (at least 1)."""
    return max(1, -(-n // CHUNK))


def quantize_flat(
    x: torch.Tensor, noise: torch.Tensor | torch.Generator
) -> tuple[torch.Tensor, torch.Tensor, int]:
    """Quantize a flat (n,) buffer in rows of `CHUNK`, zero-padded.

    ``noise`` is the (rows, CHUNK) f32 rounding noise, or a generator to
    draw it from (uniform in [0, 1), on the generator's device, then moved
    to x's).  Returns (q (rows, CHUNK) int8, scales (rows,), n).
    """
    n = x.shape[0]
    rows = flat_rows(n)
    xp = torch.nn.functional.pad(x.to(torch.float32), (0, rows * CHUNK - n))
    if isinstance(noise, torch.Generator):
        noise = torch.rand((rows, CHUNK), generator=noise, device=noise.device)
    q, s = quantize(xp.view(rows, CHUNK), noise.to(x.device))
    return q, s, n


def dequantize_flat(q: torch.Tensor, scales: torch.Tensor, n: int) -> torch.Tensor:
    """The first ``n`` values of the dequantized rows, flat."""
    return dequantize(q, scales).reshape(-1)[:n]
