"""xLSTM blocks (port of `repro.models.xlstm`): mLSTM and sLSTM.

mLSTM is linear attention with per-head scalar input/forget gates and a
vector normalizer (arXiv:2405.04517), without the paper's max-stabilizer,
as in the reference:

    S_t = f_t S_{t-1} + i_t k_t v_t^T,   n_t = f_t n_{t-1} + i_t k_t
    h_t = (q_t S_t) / max(|q_t . n_t|, 1)

The reference model runs its chunkwise form in jnp (`_mlstm_chunk_scan`);
the port runs the same arithmetic through the hand-written kernel
(`repro_torch.kernels.mlstm_chunk`), which takes the layer's carried state
``(S (B, H, Dh, Dh), n (B, H, Dh))`` in f32 and returns the new one: prefill
and every decode step go through it, and so does training, whose backward
recomputes through the kernel's plain twin (the reference's scan).

Matrices are cast to the compute dtype at each use, as the reference casts
its f32 masters: a server holds them in the compute dtype (the cast is a
no-op), a trainer in f32, and its gradients flow through the casts.

sLSTM keeps the reference's sequential recurrence (a block-diagonal
per-head recurrent kernel ``r``, f32 state and pre-activations) as a Python
loop over positions, the counterpart of its ``lax.scan``; in training an
autograd Function (`_SlstmScan`) keeps each step's input state and walks
the positions back by hand, as the scan's transpose does.  No Pallas kernel computes it, so none is
ported; ``r`` is held in f32, as the reference reads it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.common import is_dtensor
from repro_torch.kernels.mlstm_chunk import mlstm_chunk
from repro_torch.launch.op_cost import time_loop
from repro_torch.launch.sharding import constrain, fit_reshape, fit_view
from repro_torch.models.layers import dense_init, f32_products, rms_norm

__all__ = [
    "mlstm_init", "mlstm_apply", "mlstm_init_state",
    "slstm_init", "slstm_apply", "slstm_init_state",
]


def _scalar(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``: the reference multiplies by a Python
    float in the compute dtype, which rounds the factor first."""
    return float(torch.tensor(value, dtype=dtype))


def _silu(x: torch.Tensor) -> torch.Tensor:
    """``x * 1 / (1 + e^-x)``, rounded to x's dtype after each step, as
    the reference's ``jax.nn.silu`` computes it (`F.silu` rounds once)."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


# ------------------------------------------------------------------- mLSTM


def mlstm_init(gen: torch.Generator, cfg) -> dict[str, torch.Tensor]:
    D, H, Dh = cfg.d_model, cfg.num_heads, cfg.head_dim
    return {
        "norm": torch.zeros(D, device=gen.device),
        "wq": dense_init(gen, D, H * Dh),
        "wk": dense_init(gen, D, H * Dh),
        "wv": dense_init(gen, D, H * Dh),
        "w_if": dense_init(gen, D, 2 * H),  # input/forget gate logits
        "wo": dense_init(gen, H * Dh, D),
        "skip_gate": dense_init(gen, D, H * Dh),
    }


def mlstm_apply(p, x, cfg, *, state=None, chunk: int = 256):
    """x: (B, S, D).  state: (S, n) or None (zeros).  Returns (out, state).

    Projections, gates and padding as the reference's `mlstm_apply`: k is
    scaled by ``Dh ** -0.5`` in the compute dtype, the gates are the
    compute-dtype product cast to f32, and a prompt that is not a multiple
    of the chunk is padded with zero q/k/v, ``log_i = -30`` and ``log_f =
    0``, so the state after the padded rows is the reference's.
    """
    B, S, _ = x.shape
    H, Dh = cfg.num_heads, cfg.head_dim
    h = rms_norm(x, p["norm"])
    cdt = h.dtype
    q = fit_view(h @ p["wq"].to(cdt), B, S, H, Dh)
    k = fit_view(h @ p["wk"].to(cdt), B, S, H, Dh) * _scalar(Dh**-0.5, cdt)
    v = fit_view(h @ p["wv"].to(cdt), B, S, H, Dh)
    gates = fit_view(h @ p["w_if"].to(cdt), B, S, 2, H).to(torch.float32)
    log_i = torch.clamp(gates[:, :, 0], -10.0, 10.0)
    log_f = F.logsigmoid(gates[:, :, 1])

    if state is None:
        state = mlstm_init_state(cfg, B, x.device)
    # The reference's hints: q/k batch-sharded, v and the state's v dim
    # over 'model' (its v-dim state sharding).
    q = constrain(q, "batch", None, None, None)
    k = constrain(k, "batch", None, None, None)
    v = constrain(v, "batch", None, None, "state")
    state = (constrain(state[0], "batch", None, None, "state"), state[1])
    C = min(chunk, S)
    pad = -S % C
    if pad:
        q, k, v = (_pad_seq(a, pad) for a in (q, k, v))
        log_i = _pad_seq(log_i, pad, -30.0)
        log_f = _pad_seq(log_f, pad)
    Sp = S + pad
    # (B, S, H, Dh) -> the kernel's (B H, S, Dh); gates (B, S, H) -> (B H, S).
    heads = lambda a: fit_reshape(a.transpose(1, 2), B * H, Sp, Dh)  # noqa: E731
    gate = lambda a: fit_reshape(a.transpose(1, 2), B * H, Sp)  # noqa: E731
    S_prev, n_prev = state
    out, (S_new, n_new) = mlstm_chunk(
        heads(q), heads(k), heads(v), gate(log_f), gate(log_i),
        state=(fit_reshape(S_prev, B * H, Dh, Dh), fit_reshape(n_prev, B * H, Dh)), chunk=C,
    )
    out = fit_view(out, B, H, Sp, Dh).transpose(1, 2)[:, :S]
    skip = fit_view(_silu(h @ p["skip_gate"].to(cdt)), B, S, H, Dh)
    out = fit_reshape(out * skip, B, S, H * Dh)
    return (out @ p["wo"].to(cdt)).to(x.dtype), (fit_view(S_new, B, H, Dh, Dh),
                                                 fit_view(n_new, B, H, Dh))


def _pad_seq(a: torch.Tensor, pad: int, value: float = 0.0) -> torch.Tensor:
    """``a`` (B, S, ...) with ``pad`` rows of ``value`` after its last
    position; a DTensor padded on each device's blocks (`local_map`), its
    sequence gathered first where split."""
    spec = (0, 0) * (a.dim() - 2) + (0, pad)
    if not is_dtensor(a):
        return F.pad(a, spec, value=value)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    pl = tuple(Replicate() if p == Shard(1) else p for p in a.placements)
    return local_map(lambda t: F.pad(t, spec, value=value), out_placements=(pl,),
                     in_placements=(pl,), device_mesh=a.device_mesh,
                     redistribute_inputs=True)(a)


def mlstm_init_state(cfg, batch: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    H, Dh = cfg.num_heads, cfg.head_dim
    return (
        torch.zeros((batch, H, Dh, Dh), dtype=torch.float32, device=device),
        torch.zeros((batch, H, Dh), dtype=torch.float32, device=device),
    )


# ------------------------------------------------------------------- sLSTM


def slstm_init(gen: torch.Generator, cfg) -> dict[str, torch.Tensor]:
    D, H, Dh = cfg.d_model, cfg.num_heads, cfg.head_dim
    return {
        "norm": torch.zeros(D, device=gen.device),
        "w_in": dense_init(gen, D, 4 * H * Dh),  # z, i, f, o pre-activations
        "r": torch.randn((H, Dh, 4 * Dh), generator=gen, device=gen.device) * Dh**-0.5,
        "wo": dense_init(gen, H * Dh, D),
    }


def _slstm_step(pre_t, c, n, h, r, Dh: int):
    """One sLSTM time step: pre-activations (B, H, 4 Dh) of position t and
    the recurrence on h; the new (c, n, h)."""
    rec = torch.bmm(h.transpose(0, 1), r).transpose(0, 1)  # (B, H, 4 Dh)
    z, i, f, o = (pre_t + rec).split(Dh, dim=-1)
    z = torch.tanh(z)
    i = torch.exp(torch.clamp(i, -10.0, 10.0))
    f = torch.sigmoid(f)
    o = torch.sigmoid(o)
    c = f * c + i * z
    n = f * n + i
    h = o * c / torch.clamp(n.abs(), min=1.0)
    return c, n, h


def _slstm_step_back(pre_t, c, n, h, r, dh, dc, dn, Dh: int):
    """The backward of `_slstm_step` from its inputs (its gates
    recomputed): the gradients reaching its output (h, c, n) in, those of
    its pre-activations and its input (h, c, n) out."""
    rec = torch.bmm(h.transpose(0, 1), r).transpose(0, 1)
    zt, it, ft, ot = (pre_t + rec).split(Dh, dim=-1)
    z = torch.tanh(zt)
    i = torch.exp(torch.clamp(it, -10.0, 10.0))
    f = torch.sigmoid(ft)
    o = torch.sigmoid(ot)
    c_new = f * c + i * z
    n_new = f * n + i
    a = n_new.abs()
    d = torch.clamp(a, min=1.0)
    h_new = o * c_new / d
    # h_new = o c_new / d,  d = max(|n_new|, 1)
    dq = dh / d
    dc = dc + dq * o
    dd = -dh * h_new / d
    dn = dn + torch.where(a >= 1.0, dd, 0.0) * torch.sign(n_new)
    # c_new = f c + i z,  n_new = f n + i
    df = dc * c + dn * n
    di = dc * z + dn
    dz = dc * i
    dpre = torch.cat([
        dz * (1.0 - z * z),
        torch.where((it >= -10.0) & (it <= 10.0), di * i, 0.0),
        df * f * (1.0 - f),
        dq * c_new * o * (1.0 - o),
    ], dim=-1)
    dh_in = torch.bmm(dpre.transpose(0, 1), r.transpose(1, 2)).transpose(0, 1)
    return dpre, dh_in, dc * f, dn * f


def _slstm_scan(pre, r, c, n, h, Dh: int, history=None):
    """Every position of ``pre`` (B, S, H, 4 Dh) through `_slstm_step`:
    the outputs (B, S, H, Dh) and the last (c, n, h).  With ``history``,
    three buffers of the outputs' shape, each step's input (c, n, h) is
    written there.  Every step issues the same operations into buffers
    made before the loop (`op_cost.time_loop`)."""
    S = pre.shape[1]
    out = torch.empty_like(pre[..., :Dh])
    with time_loop(S, pre) as steps:
        for t in range(steps):
            if history is not None:
                for buf, v in zip(history, (c, n, h)):
                    buf[:, t].copy_(v)
            c, n, h = _slstm_step(pre[:, t], c, n, h, r, Dh)
            out[:, t].copy_(h)
    return out, c, n, h


class _SlstmScan(torch.autograd.Function):
    """`_slstm_scan` differentiated by hand: the forward keeps each step's
    input state, the backward walks the positions in reverse through
    `_slstm_step_back` (the gates recomputed) and takes the recurrent
    kernel's gradient in one product over every position."""

    @staticmethod
    def forward(ctx, pre, r, c, n, h):
        Dh = r.shape[1]
        history = tuple(torch.empty_like(pre[..., :Dh]) for _ in range(3))
        out, c, n, h = _slstm_scan(pre, r, c, n, h, Dh, history)
        ctx.save_for_backward(pre, r, *history)
        return out, c, n, h

    @staticmethod
    def backward(ctx, d_out, dc, dn, dh):
        pre, r, cs, ns, hs = ctx.saved_tensors
        Dh = r.shape[1]
        S = pre.shape[1]
        d_pre = torch.empty_like(pre)
        with time_loop(S, pre) as steps:
            for t in range(S - 1, S - 1 - steps, -1):
                dpre_t, dh, dc, dn = _slstm_step_back(
                    pre[:, t], cs[:, t], ns[:, t], hs[:, t], r, dh + d_out[:, t], dc, dn, Dh)
                d_pre[:, t].copy_(dpre_t)
        d_r = torch.einsum("bshd,bshe->hde", hs, d_pre)
        return tuple(g if need else None
                     for g, need in zip((d_pre, d_r, dc, dn, dh), ctx.needs_input_grad))


def slstm_apply(p, x, cfg, *, state=None):
    """Sequential sLSTM.  x: (B, S, D) -> (out, (c, n, h)), state in f32.
    Where autograd records, the loop runs as `_SlstmScan`."""
    B, S, _ = x.shape
    H, Dh = cfg.num_heads, cfg.head_dim
    hin = rms_norm(x, p["norm"])
    pre = fit_view(hin @ p["w_in"].to(hin.dtype), B, S, H, 4 * Dh).to(torch.float32)
    if state is None:
        state = slstm_init_state(cfg, B, x.device)
    r = p["r"].to(torch.float32)  # (H, Dh, 4 Dh)
    with f32_products():
        if torch.is_grad_enabled() and (pre.requires_grad or r.requires_grad):
            out, c, n, h = _SlstmScan.apply(pre, r, *state)
        else:
            out, c, n, h = _slstm_scan(pre, r, *state, Dh)
    out = fit_reshape(out, B, S, H * Dh).to(x.dtype)
    return (out @ p["wo"].to(x.dtype)).to(x.dtype), (c, n, h)


def slstm_init_state(cfg, batch: int, device) -> tuple[torch.Tensor, ...]:
    H, Dh = cfg.num_heads, cfg.head_dim
    z = torch.zeros((batch, H, Dh), dtype=torch.float32, device=device)
    return (z, z, z)
