"""RG-LRU recurrent block (port of `repro.models.rglru`; Griffin /
RecurrentGemma, arXiv:2402.19427).

    y = W_out [ GeLU(W_gate x)  o  RG-LRU(conv1d_4(W_in x)) ]

RG-LRU, per channel, in f32:

    r_t = sigmoid(W_r u_t),  i_t = sigmoid(W_i u_t)
    a_t = exp(-c softplus(L) r_t)                       (c = 8)
    h_t = a_t h_{t-1} + sqrt(max(1 - a_t^2, 1e-12)) (i_t u_t)

As the reference computes it: the gate's GeLU is the tanh approximation
(``jax.nn.gelu``'s default); u comes out of the depthwise causal conv in
the compute dtype and is widened to f32 before the r and i products, whose
weights are read in f32 (the port holds ``w_r`` and ``w_i`` in f32, as the
reference reads them; TF32 is off around those products on the card).  The
carried state is ``(h (B, W) f32, conv window (B, cw - 1, W))``:
`rglru_init_state` makes the window in f32, and every call returns it in
the compute dtype, as the reference's conv does.

The recurrence is linear, so a prompt runs it as a log-depth scan over the
sequence: the carried h is a virtual step 0, and ``ceil(log2(S + 1))``
rounds of the reference's ``combine`` ((a1, b1), (a2, b2)) -> (a1 a2, a2
b1 + b2) each fold in the prefix ending ``d`` positions earlier (d = 1, 2,
4, ...).  The reference's ``jax.lax.associative_scan`` takes another tree,
so sums round at other places; a decode step (S = 1) is the reference's
single step.  No TPU kernel computes RG-LRU (the reference uses
``associative_scan``), so none is ported: the scan is plain PyTorch on
both devices, and autograd differentiates it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init, f32_products, rms_norm

__all__ = ["rglru_init", "rglru_apply", "rglru_init_state", "F32_WEIGHTS"]

_C = 8.0
#: Matrices the reference reads in f32 (held so for serving too).
F32_WEIGHTS = ("w_r", "w_i")


def rglru_init(gen: torch.Generator, cfg) -> dict[str, torch.Tensor]:
    """The reference's distributions (not its numbers): matrices N(0,
    1/fan_in), the conv kernel N(0, 1/cw), and Lambda such that a = e^{-c
    softplus(L)} is U[0.9, 0.999]."""
    D, W, cw = cfg.d_model, cfg.lru_width, cfg.conv1d_width
    dev = gen.device
    u = 0.9 + 0.099 * torch.rand((W,), generator=gen, device=dev)
    return {
        "norm": torch.zeros(D, device=dev),
        "w_in": dense_init(gen, D, W),
        "w_gate": dense_init(gen, D, W),
        "conv": torch.randn((cw, W), generator=gen, device=dev) * cw**-0.5,
        "w_r": dense_init(gen, W, W),
        "w_i": dense_init(gen, W, W),
        "lambda": torch.log(torch.expm1(-torch.log(u) / _C)),  # softplus^-1(-log u / c)
        "w_out": dense_init(gen, W, D),
    }


def _causal_conv1d(u, kernel, prev):
    """Depthwise causal conv, as the reference's: u (B, S, W), kernel (cw,
    W), prev (B, cw - 1, W) the left context.  Taps are added in order,
    each rounded to u's dtype; the new context is in u's dtype."""
    cw = kernel.shape[0]
    x = torch.cat([prev.to(u.dtype), u], dim=1)
    out = torch.zeros_like(u)
    for t in range(cw):
        out = out + x[:, t : t + u.shape[1]] * kernel[t]
    new_prev = x[:, -(cw - 1):] if cw > 1 else prev
    return out, new_prev


def _scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Inclusive scan of (a, b) under ``combine`` along axis 1, in
    ceil(log2(n)) rounds; returns the b of every prefix."""
    n = a.shape[1]
    d = 1
    while d < n:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def rglru_apply(p, x, cfg, *, state=None):
    """x: (B, S, D) -> (out, state), state = (h, conv window)."""
    B, S, _ = x.shape
    W = cfg.lru_width
    h_in = rms_norm(x, p["norm"])
    cdt = h_in.dtype
    gate = F.gelu(h_in @ p["w_gate"].to(cdt), approximate="tanh")
    u = h_in @ p["w_in"].to(cdt)
    if state is None:
        state = rglru_init_state(cfg, B, x.device)
    h0, conv_prev = state
    u, conv_prev = _causal_conv1d(u, p["conv"].to(cdt), conv_prev)
    uf = u.to(torch.float32)

    with f32_products():
        r = torch.sigmoid(uf @ p["w_r"].to(torch.float32))
        i = torch.sigmoid(uf @ p["w_i"].to(torch.float32))
    log_a = -_C * F.softplus(p["lambda"].to(torch.float32)) * r
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * uf)

    if S == 1:
        new_h = a[:, 0] * h0 + gated[:, 0]
        hs = new_h[:, None]
    else:
        ones = torch.ones((B, 1, W), dtype=torch.float32, device=x.device)
        hs = _scan(torch.cat([ones, a], dim=1), torch.cat([h0[:, None], gated], dim=1))[:, 1:]
        new_h = hs[:, -1]

    out = (hs.to(cdt) * gate) @ p["w_out"].to(cdt)
    return out.to(x.dtype), (new_h, conv_prev)


def rglru_init_state(cfg, batch: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Zero h and a zero conv window, both f32, as the reference's."""
    W = cfg.lru_width
    return (
        torch.zeros((batch, W), dtype=torch.float32, device=device),
        torch.zeros((batch, cfg.conv1d_width - 1, W), dtype=torch.float32, device=device),
    )
