"""Dense model blocks (port of `repro.models.layers`, the dense part).

Conventions, as in the reference:
  * activations are (batch, seq, ...); the residual stream is in
    ``cfg.compute_dtype``;
  * params are plain dicts of tensors.  Each matrix is cast to the compute
    dtype where it is used, as the reference casts its f32 masters: a
    trainer holds f32 parameters and its gradients flow through the casts;
    a server holds the matrices once in the compute dtype
    (`repro_torch.models.model.Model.cast`), where the cast is a no-op and
    a decode step does not reread f32 weights.  Norm weights are read in
    f32;
  * attention runs through the ported flash kernel
    (`repro_torch.kernels.flash_attention`) on the card and its plain twin
    on the host, in training too: its backward recomputes through the twin,
    as the reference's flash route does.  The reference's second jnp
    formulation (``chunked_attention``, with its own custom VJP) is not
    ported; both of its routes compute the same function.

The reference's sharding hints (``launch.sharding.constrain``) have no
counterpart: the port runs on one card.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import flash_attention

__all__ = [
    "dense_init", "embed_init", "rms_norm", "rope", "f32_products",
    "attn_init", "attn_apply", "attn_init_cache", "ffn_init", "ffn_apply",
]


# --------------------------------------------------------------------------
# init / numerics helpers
# --------------------------------------------------------------------------


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int) -> torch.Tensor:
    """N(0, 1/in_dim) f32 on ``gen``'s device (the reference's distribution,
    not its numbers)."""
    return torch.randn(
        (in_dim, out_dim), generator=gen, device=gen.device
    ) * in_dim**-0.5


def embed_init(gen: torch.Generator, vocab: int, dim: int) -> torch.Tensor:
    return torch.randn((vocab, dim), generator=gen, device=gen.device)


@contextlib.contextmanager
def f32_products():
    """TF32 off for the card's products inside: the reference computes
    them in f32 (sLSTM's recurrence, RG-LRU's gates)."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.to(torch.float32)
    var = x32.square().mean(dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * (1.0 + w.to(torch.float32))).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding.  x: (B, S, H, D) (D even); positions: (B, S)."""
    half = x.shape[-1] // 2
    exponent = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freq = torch.pow(torch.tensor(theta, dtype=torch.float32), exponent)
    angles = positions[..., None].to(torch.float32) * freq  # (B, S, half)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.to(torch.float32).split(half, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# standard GQA attention layer (global or sliding-window)
# --------------------------------------------------------------------------


def attn_init(gen: torch.Generator, cfg) -> dict[str, torch.Tensor]:
    """f32 values; `repro_torch.models.model.Model.init` holds them as
    `Model.cast` says."""
    D, H, Hkv, Dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {
        "norm": torch.zeros(D, device=gen.device),
        "wq": dense_init(gen, D, H * Dh),
        "wk": dense_init(gen, D, Hkv * Dh),
        "wv": dense_init(gen, D, Hkv * Dh),
        "wo": dense_init(gen, H * Dh, D),
    }


def attn_apply(p, x, cfg, *, positions, cache=None, pos=0, window=None):
    """x: (B, S, D).  cache: {'k', 'v'} (B, Smax, Hkv, Dh) or None.

    Returns (out, cache).  With a cache, the new K/V are written into it at
    ``pos`` in place -- the port's counterpart of the reference's
    ``dynamic_update_slice``, which returns a new cache -- and attention
    runs over the whole cache, the unwritten positions hidden by causality
    (queries sit at ``pos + i``), as on the reference's flash route.
    """
    B, S, _ = x.shape
    H, Hkv, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    h = rms_norm(x, p["norm"])
    cdt = h.dtype
    q = rope((h @ p["wq"].to(cdt)).view(B, S, H, Dh), positions, cfg.rope_theta)
    k = rope((h @ p["wk"].to(cdt)).view(B, S, Hkv, Dh), positions, cfg.rope_theta)
    v = (h @ p["wv"].to(cdt)).view(B, S, Hkv, Dh)
    if cache is not None:
        cache["k"][:, pos : pos + S] = k
        cache["v"][:, pos : pos + S] = v
        k, v = cache["k"], cache["v"]
    # (B, S, H, D) viewed as the kernel's (B, H, S, D): no copy either way.
    out = flash_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=True, window=window, q_offset=pos,
    ).transpose(1, 2)
    out = out.reshape(B, S, H * Dh) @ p["wo"].to(cdt)
    return out.to(x.dtype), cache


def attn_init_cache(cfg, batch: int, max_len: int, dtype, device) -> dict[str, torch.Tensor]:
    shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


# --------------------------------------------------------------------------
# dense SwiGLU FFN
# --------------------------------------------------------------------------


def ffn_init(gen: torch.Generator, cfg) -> dict[str, torch.Tensor]:
    D, Fd = cfg.d_model, cfg.d_ff
    return {
        "norm": torch.zeros(D, device=gen.device),
        "w_gate": dense_init(gen, D, Fd),
        "w_up": dense_init(gen, D, Fd),
        "w_down": dense_init(gen, Fd, D),
    }


def ffn_apply(p, x, cfg):
    h = rms_norm(x, p["norm"])
    cdt = h.dtype
    g = F.silu(h @ p["w_gate"].to(cdt))
    u = h @ p["w_up"].to(cdt)
    return ((g * u) @ p["w_down"].to(cdt)).to(x.dtype)
