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
loop over positions, the counterpart of its ``lax.scan``, which autograd
differentiates as it runs.  No Pallas kernel computes it, so none is
ported; ``r`` is held in f32, as the reference reads it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.mlstm_chunk import mlstm_chunk
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
    q = (h @ p["wq"].to(cdt)).view(B, S, H, Dh)
    k = (h @ p["wk"].to(cdt)).view(B, S, H, Dh) * _scalar(Dh**-0.5, cdt)
    v = (h @ p["wv"].to(cdt)).view(B, S, H, Dh)
    gates = (h @ p["w_if"].to(cdt)).view(B, S, 2, H).to(torch.float32)
    log_i = torch.clamp(gates[:, :, 0], -10.0, 10.0)
    log_f = F.logsigmoid(gates[:, :, 1])

    if state is None:
        state = mlstm_init_state(cfg, B, x.device)
    C = min(chunk, S)
    pad = -S % C
    if pad:
        q, k, v = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (q, k, v))
        log_i = F.pad(log_i, (0, 0, 0, pad), value=-30.0)
        log_f = F.pad(log_f, (0, 0, 0, pad))
    Sp = S + pad
    # (B, S, H, Dh) -> the kernel's (B H, S, Dh); gates (B, S, H) -> (B H, S).
    heads = lambda a: a.transpose(1, 2).reshape(B * H, Sp, Dh)  # noqa: E731
    gate = lambda a: a.transpose(1, 2).reshape(B * H, Sp)  # noqa: E731
    S_prev, n_prev = state
    out, (S_new, n_new) = mlstm_chunk(
        heads(q), heads(k), heads(v), gate(log_f), gate(log_i),
        state=(S_prev.reshape(B * H, Dh, Dh), n_prev.reshape(B * H, Dh)), chunk=C,
    )
    out = out.view(B, H, Sp, Dh).transpose(1, 2)[:, :S]
    skip = _silu(h @ p["skip_gate"].to(cdt)).view(B, S, H, Dh)
    out = (out * skip).reshape(B, S, H * Dh)
    return (out @ p["wo"].to(cdt)).to(x.dtype), (S_new.view(B, H, Dh, Dh), n_new.view(B, H, Dh))


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


def slstm_apply(p, x, cfg, *, state=None):
    """Sequential sLSTM.  x: (B, S, D) -> (out, (c, n, h)), state in f32."""
    B, S, _ = x.shape
    H, Dh = cfg.num_heads, cfg.head_dim
    hin = rms_norm(x, p["norm"])
    pre = (hin @ p["w_in"].to(hin.dtype)).view(B, S, H, 4 * Dh).to(torch.float32)
    if state is None:
        state = slstm_init_state(cfg, B, x.device)
    r = p["r"].to(torch.float32)  # (H, Dh, 4 Dh)
    c, n, h = state
    hs = []
    with f32_products():
        for t in range(S):
            rec = torch.bmm(h.transpose(0, 1), r).transpose(0, 1)  # (B, H, 4 Dh)
            z, i, f, o = (pre[:, t] + rec).split(Dh, dim=-1)
            z = torch.tanh(z)
            i = torch.exp(torch.clamp(i, -10.0, 10.0))
            f = torch.sigmoid(f)
            o = torch.sigmoid(o)
            c = f * c + i * z
            n = f * n + i
            h = o * c / torch.clamp(n.abs(), min=1.0)
            hs.append(h)
    out = torch.stack(hs, dim=1).reshape(B, S, H * Dh).to(x.dtype)
    return (out @ p["wo"].to(x.dtype)).to(x.dtype), (c, n, h)


def slstm_init_state(cfg, batch: int, device) -> tuple[torch.Tensor, ...]:
    H, Dh = cfg.num_heads, cfg.head_dim
    z = torch.zeros((batch, H, Dh), dtype=torch.float32, device=device)
    return (z, z, z)
