"""`mlstm_chunk`: the chunkwise mLSTM forward with a carried state.

Port of `repro.kernels.mlstm_chunk` (the Pallas kernel
`mlstm_chunk_pallas`, `src/repro/kernels/mlstm_chunk/kernel.py`, body
`_mlstm_kernel`).  q, k, v are (BH, S, Dh) in f32 or bf16; log_f and log_i
are (BH, S) f32 log gates (``log_sigmoid`` of the forget logit, the clipped
input logit); ``state`` is ``(S0 (BH, Dh, Dh), n0 (BH, Dh))`` in f32, or
``None`` for zeros.  Chunks of ``C = min(chunk, S)`` rows run in order, all
in f32 (the caller pads S to a multiple of C, as the reference's
`mlstm_apply` does):

    F      = cumsum(log_f)
    inter  = (q e^F) S_prev,  inter_n = (q e^F) . n_prev
    A[t,s] = e^{F_t - F_s + log_i_s} for s <= t, else 0
    scores = (q k^T) o A
    h      = (inter + scores v) / max(|inter_n + sum_s scores|, 1)
    S      = e^{F_C} S_prev + (k w)^T v,   n = e^{F_C} n_prev + sum_s k w,
             w = e^{F_C - F + log_i}

Returns ``(h (BH, S, Dh) in q's dtype, (S (BH, Dh, Dh), n (BH, Dh)) f32)``.
With a zero state it computes what `mlstm_chunk_pallas` computes (which
always starts from zeros); with a state, what the reference model's
`_mlstm_chunk_scan` computes, so serving carries the state from prefill
into every decode step through the kernel.

CUDA tensors launch the hand-written kernels (``csrc/mlstm_chunk.cu``);
CPU tensors take `mlstm_chunk_plain`, the same arithmetic step by step.
`plan` picks the route of a call from its shape and dtype alone:

* ``"stream"`` when C = 1 (decode, either dtype): bound by the state's
  bytes, read once and written once; blocks of 16 value columns hold their
  slice of S in registers with every load issued up front (Dh / 16 x BH
  blocks), positions in order, all in f32;
* ``"mma"`` for bf16 with C >= 2 and Dh a multiple of 64 (prefill): bf16
  tensor-core products with f32 accumulation, each f32 operand split hi +
  lo into two bf16 products; two kernels, a scan that carries the state
  through the chunks in mma accumulators and writes each chunk's starting
  state (split) and normalizer to scratch, then one output block per (64
  rows, 128 columns, chunk, (b, h)), fully parallel over chunks;
* ``"simt"`` otherwise (f32 prefill, bf16 at Dh 16 or 32): f32 products on
  CUDA cores, each block owning some value columns of the state through
  the chunk loop.

The source note gives each route's bound and design.  A CUDA tensor of a
shape no route takes raises.  `LAUNCHES` counts one per call that reaches
a kernel, whatever number of CUDA kernels its route launches (the mma
route launches two).

``meta`` tensors (the launch tooling's dry-run) take the meta route: the
kernel's checks, then empty outputs of the right shapes and dtypes,
nothing computed.  `cost` gives the call's operations and bytes; under an
active operation count every route adds it (`kernels.common.kernel_work`).

Where autograd records (training xLSTM), the call goes through a
`torch.autograd.Function` whose backward recomputes through the twin, as
`flash_attention`'s does; elsewhere (serving) the wrapper launches the
kernel directly.

DTensor operands (a model partitioned over a `DeviceMesh`) enter through
`kernels.common.on_local_blocks`: the (batch x heads) axis split as the
operands split it, anything else (the reference's v-dim state split over
``model``) gathered first; the call then runs, and `cost` counts, on each
device's blocks.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.common import is_dtensor, kernel_work, launch, on_local_blocks, stream_of

__all__ = [
    "mlstm_chunk", "mlstm_chunk_plain", "block_smem", "cost", "plan", "scratch_bytes",
    "LAUNCHES",
]

#: Calls that reached a kernel in this process (CPU calls are not counted).
LAUNCHES = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ROUTE_CODES = {"simt": 0, "mma": 1, "stream": 2}


def plan(dtype: torch.dtype, BH: int, S: int, Dh: int, C: int) -> str:
    """The route of a call (module doc); the operands are already valid."""
    if C == 1:
        return "stream"
    if dtype == torch.bfloat16 and Dh % 64 == 0:
        return "mma"
    return "simt"


def cost(q, k, v, log_f, log_i, state, C: int) -> tuple[float, float]:
    """(operations, bytes) of one call.  Operations per chunk and (b, h): 2
    Dh flops per live pair t >= s for q k^T and again for the scores
    against v, 2 C Dh^2 each for inter and the state update.  Bytes: q, k,
    v read and h written once, the two f32 gates read, the f32 state
    written (and read when carried)."""
    BH, S, Dh = q.shape
    chunks = BH * (S // C)
    pairs = C * (C + 1) // 2
    flops = chunks * (2 * pairs * Dh + 2 * (pairs * Dh + 2 * C * Dh * Dh))
    state_bytes = 4 * BH * (Dh * Dh + Dh)
    nbytes = (4 * BH * S * Dh * q.element_size() + 2 * 4 * BH * S
              + state_bytes * (1 if state is None else 2))
    return float(flops), float(nbytes)


def scratch_bytes(BH: int, S: int, Dh: int, C: int) -> int:
    """Device scratch of the mma route: each chunk's starting state as hi
    and lo bf16 planes, then its normalizer in f32."""
    return S // C * BH * Dh * (4 * Dh + 4)


@functools.lru_cache(maxsize=None)
def block_smem(device: int, route: str, Dh: int, C: int) -> tuple[int, int]:
    """(bytes of shared memory one block of ``route`` takes at (Dh, C), 0
    where the route does not take them; the most a block may take on CUDA
    device ``device``), as the kernels' source computes them."""
    need, limit = ctypes.c_longlong(), ctypes.c_int()
    launch("mlstm_chunk_smem", _ROUTE_CODES[route], Dh, C, ctypes.byref(need),
           ctypes.byref(limit), device=torch.device("cuda", device))
    return need.value, limit.value


def mlstm_chunk_plain(q, k, v, log_f, log_i, state=None, chunk: int = 256):
    """Plain PyTorch twin of the kernel: the chunk loop of the reference's
    `_mlstm_chunk_scan` (and `_mlstm_kernel`) per (b, h), in f32."""
    BH, S, Dh = q.shape
    C = min(chunk, S)
    f32 = torch.float32
    if state is None:
        S_prev = torch.zeros((BH, Dh, Dh), dtype=f32, device=q.device)
        n_prev = torch.zeros((BH, Dh), dtype=f32, device=q.device)
    else:
        S_prev, n_prev = (t.to(f32) for t in state)
    causal = torch.ones((C, C), dtype=torch.bool, device=q.device).tril()
    hs = []
    for c0 in range(0, S, C):
        rows = slice(c0, c0 + C)
        qc, kc, vc = (t[:, rows].to(f32) for t in (q, k, v))
        lf, li = log_f[:, rows].to(f32), log_i[:, rows].to(f32)
        F = torch.cumsum(lf, dim=1)  # (BH, C)
        F_total = F[:, -1]
        q_dec = qc * torch.exp(F)[..., None]
        inter = q_dec @ S_prev
        inter_n = (q_dec @ n_prev[..., None])[..., 0]
        gate = F[:, :, None] - F[:, None, :] + li[:, None, :]
        # Masked before the exponential: a masked gate may overflow, and
        # under autograd exp's backward would multiply its zero cotangent
        # by inf.  The values are the reference's where(causal, exp, 0).
        A = torch.exp(torch.where(causal, gate, -torch.inf))
        scores = (qc @ kc.transpose(1, 2)) * A
        num = inter + scores @ vc
        den = inter_n + scores.sum(dim=2)
        hs.append((num / torch.clamp(den.abs(), min=1.0)[..., None]).to(q.dtype))
        kw = kc * torch.exp(F_total[:, None] - F + li)[..., None]
        S_prev = S_prev * torch.exp(F_total)[:, None, None] + kw.transpose(1, 2) @ vc
        n_prev = n_prev * torch.exp(F_total)[:, None] + kw.sum(dim=1)
    return torch.cat(hs, dim=1), (S_prev, n_prev)


def _check(q, k, v, log_f, log_i, state, chunk) -> int:
    """Validate the operands; return the chunk length C."""
    if q.dim() != 3:
        raise ValueError(f"mlstm_chunk: q must be (BH, S, Dh), got {tuple(q.shape)}")
    BH, S, Dh = q.shape
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape:
            raise ValueError(
                f"mlstm_chunk: {name} must have q's shape {tuple(q.shape)}, got {tuple(t.shape)}"
            )
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"mlstm_chunk: q must be float32 or bfloat16, got {q.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise TypeError(f"mlstm_chunk: {name} is {t.dtype}, q is {q.dtype}")
    operands = [("log_f", log_f, (BH, S)), ("log_i", log_i, (BH, S))]
    if state is not None:
        if len(state) != 2:
            raise ValueError("mlstm_chunk: state must be (S0, n0)")
        operands += [("S0", state[0], (BH, Dh, Dh)), ("n0", state[1], (BH, Dh))]
    for name, t, shape in operands:
        if tuple(t.shape) != shape:
            raise ValueError(f"mlstm_chunk: {name} must be {shape}, got {tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"mlstm_chunk: {name} must be float32, got {t.dtype}")
    for name, t in [("k", k), ("v", v)] + [(n, t) for n, t, _ in operands]:
        if t.device != q.device:
            raise ValueError(f"mlstm_chunk: {name} is on {t.device}, q on {q.device}")
    if S < 1 or chunk < 1:
        raise ValueError(f"mlstm_chunk: need S >= 1 and chunk >= 1, got S={S}, chunk={chunk}")
    C = min(chunk, S)
    if S % C:
        raise ValueError(f"mlstm_chunk: S={S} is not a multiple of chunk={C} (pad upstream)")
    if not (Dh in (16, 32) or (Dh % 64 == 0 and Dh <= 512)):
        raise ValueError(
            f"mlstm_chunk: head dim Dh={Dh} not taken (16, 32 or a multiple of 64 up to 512)"
        )
    if not 1 <= BH <= 65535:
        raise ValueError(f"mlstm_chunk: BH={BH} outside the grid's 1 .. 65535")
    return C


class _MlstmChunk(torch.autograd.Function):
    """Forward through `_forward` (the kernel on the card, the twin on the
    host); backward by recomputing through `mlstm_chunk_plain` under
    autograd, with gradients to q, k, v, the log gates and the initial
    state: the twin is the chunk loop of the reference's
    `_mlstm_chunk_scan`, which the reference trains through.  No backward
    kernel: the reference has none."""

    @staticmethod
    def forward(ctx, q, k, v, log_f, log_i, s0, n0, C):
        ctx.save_for_backward(q, k, v, log_f, log_i, s0, n0)
        ctx.C = C
        h, (s, n) = _forward(q, k, v, log_f, log_i, None if s0 is None else (s0, n0), C)
        return h, s, n

    @staticmethod
    def backward(ctx, dh, ds, dn):
        with torch.enable_grad():
            saved = [None if t is None else t.detach().requires_grad_() for t in ctx.saved_tensors]
            q, k, v, log_f, log_i, s0, n0 = saved
            h, (s, n) = mlstm_chunk_plain(
                q, k, v, log_f, log_i, None if s0 is None else (s0, n0), ctx.C)
            inputs = [t for t in saved if t is not None]
            grads = iter(torch.autograd.grad((h, s, n), inputs, (dh, ds, dn)))
        return (*(None if t is None else next(grads) for t in saved), None)


def mlstm_chunk(q, k, v, log_f, log_i, state=None, chunk: int = 256):
    """q/k/v: (BH, S, Dh); log_f/log_i: (BH, S) f32; state: (S0, n0) f32 or
    None.  Returns (h in q's dtype, (S, n) f32).  Differentiable where
    autograd records: the forward as below, the backward through the plain
    twin (`_MlstmChunk`).  DTensor operands run on each device's blocks
    of the (batch x heads) axis, anything else gathered first
    (`kernels.common.on_local_blocks`)."""
    if any(is_dtensor(t) for t in (q, k, v, log_f, log_i, *(state or ()))):
        def local(q, k, v, log_f, log_i, s0, n0):
            h, (s, n) = mlstm_chunk(q, k, v, log_f, log_i,
                                    None if s0 is None else (s0, n0), chunk)
            return h, s, n

        s0, n0 = (None, None) if state is None else state
        h, s, n = on_local_blocks(local, (q, k, v, log_f, log_i, s0, n0), 3)
        return h, (s, n)
    C = _check(q, k, v, log_f, log_i, state, chunk)
    operands = (q, k, v, log_f, log_i, *(state or ()))
    if torch.is_grad_enabled() and any(t.requires_grad for t in operands):
        s0, n0 = (None, None) if state is None else state
        h, s, n = _MlstmChunk.apply(q, k, v, log_f, log_i, s0, n0, C)
        return h, (s, n)
    return _forward(q, k, v, log_f, log_i, state, C)


def _forward(q, k, v, log_f, log_i, state, C):
    """The twin for CPU tensors, the kernel for CUDA tensors, empty outputs
    for meta tensors (no graph); its `cost` added to an active count."""
    with kernel_work("mlstm_chunk", cost, q, k, v, log_f, log_i, state, C):
        return _route(q, k, v, log_f, log_i, state, C)


def _route(q, k, v, log_f, log_i, state, C):
    global LAUNCHES
    if q.device.type == "cpu":
        return mlstm_chunk_plain(q, k, v, log_f, log_i, state, C)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"mlstm_chunk: unsupported device {q.device}")
    BH, S, Dh = q.shape
    route = plan(q.dtype, BH, S, Dh, C)
    if route == "mma" and S // C > 65535:
        raise ValueError(f"mlstm_chunk: {S // C} chunks, more than the grid's 65535")
    if q.device.type == "meta":
        return torch.empty_like(q), (
            torch.empty((BH, Dh, Dh), dtype=torch.float32, device=q.device),
            torch.empty((BH, Dh), dtype=torch.float32, device=q.device))
    need, limit = block_smem(q.device.index, route, Dh, C)
    if need > limit:
        raise ValueError(
            f"mlstm_chunk: chunk={C} with Dh={Dh} needs {need} bytes of shared "
            f"memory ({route} route), more than a block's {limit} on {q.device}"
        )
    q, k, v, log_f, log_i = (t.contiguous() for t in (q, k, v, log_f, log_i))
    s0, n0 = (None, None) if state is None else (t.contiguous() for t in state)
    for name, t in (("q", q), ("k", k), ("v", v), ("S0", s0)):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"mlstm_chunk: {name} must be 16-byte aligned")
    h = torch.empty_like(q)
    s_out = torch.empty((BH, Dh, Dh), dtype=torch.float32, device=q.device)
    n_out = torch.empty((BH, Dh), dtype=torch.float32, device=q.device)
    scratch = (
        torch.empty(scratch_bytes(BH, S, Dh, C), dtype=torch.uint8, device=q.device)
        if route == "mma" else None
    )
    launch(
        "mlstm_chunk", q.data_ptr(), k.data_ptr(), v.data_ptr(), log_f.data_ptr(),
        log_i.data_ptr(), None if s0 is None else s0.data_ptr(),
        None if n0 is None else n0.data_ptr(), h.data_ptr(), s_out.data_ptr(),
        n_out.data_ptr(), None if scratch is None else scratch.data_ptr(),
        _DTYPE_CODES[q.dtype], BH, S, Dh, C, _ROUTE_CODES[route], stream_of(q),
        device=q.device,
    )
    LAUNCHES += 1
    return h, (s_out, n_out)
