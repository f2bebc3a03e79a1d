"""Model blocks (port of `repro.models.layers`): RMSNorm, RoPE, GQA
attention, multi-head latent attention (MLA), cross-attention, the gated
FFN, and the reference's chunked online-softmax attention.

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
  * GQA attention and cross-attention run through the ported flash kernel
    (`repro_torch.kernels.flash_attention`) on the card and its plain twin
    on the host, in training too: its backward recomputes through the twin,
    as the reference's flash route does.  Cross-attention is non-causal
    over the encoder's keys, none masked, where the reference runs
    ``chunked_attention``: both compute the same function;
  * MLA runs `chunked_attention`, the reference's own jnp formulation
    ported as plain PyTorch (online softmax over KV chunks, with its
    custom VJP as `_ChunkedAttention`): its keys are kv_lora_rank +
    qk_rope_dim wide and its values kv_lora_rank, shapes the flash kernel
    does not take (one head dim in 16..256, v shaped like k).

The reference's sharding hints (`repro_torch.launch.sharding.constrain`)
sit at its sites, `chunked_attention`'s accumulators; head splits and
merges go through `launch.sharding.fit_view` / `fit_reshape` and cache
writes through `launch.sharding.like`.  All of them act on DTensors only
(the dry-run's partition over a mesh) and leave plain tensors as they are.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from repro_torch.kernels.common import is_dtensor
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.launch.sharding import constrain, fit_reshape, fit_view, like

__all__ = [
    "dense_init", "embed_init", "rms_norm", "rope", "f32_products",
    "chunked_attention", "attn_init", "attn_apply", "attn_init_cache",
    "mla_init", "mla_apply", "mla_init_cache", "cross_init", "cross_apply",
    "ffn_init", "ffn_apply",
]

NEG_INF = -1e30


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
# chunked online-softmax attention (GQA, causal, sliding window)
# --------------------------------------------------------------------------


def _chunk_mask(q_positions, kv_valid, c, ck, causal, window):
    """(B, 1, 1, Sq, ck) visibility of kv chunk ``c``: key j < kv_valid,
    j <= query position (causal), position - j < window."""
    kj = (c * ck + torch.arange(ck, device=q_positions.device)).to(torch.float32)
    mask = (kj[None, :] < kv_valid[:, None])[:, None, None, None, :]
    qi = q_positions[:, None, None, :, None]
    kjb = kj[None, None, None, None, :]
    if causal:
        mask = mask & (qi >= kjb)
    if window is not None:
        mask = mask & ((qi - kjb) < window)
    return mask


def _heads(q, k, v, scale):
    """q as (B, Hkv, G * Sq, D) f32 times ``scale``; k and v as (B, Hkv,
    Skv, .) views."""
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    qh = q.reshape(B, Sq, Hkv, Hq // Hkv, D).permute(0, 2, 3, 1, 4)
    qh = qh.to(torch.float32).reshape(B, Hkv, -1, D) * scale
    return qh, k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)


def _carry(x):
    """An accumulator of the online softmax under the reference's hint
    (``_attn_constrain``: batch, kv heads, seq)."""
    return constrain(x, *("batch", "kv_heads", None, "seq", None)[: x.dim()])


def _chunked_fwd(q, k, v, q_positions, kv_valid, causal, window, ck):
    """Online-softmax forward over chunks of ``ck`` keys (Skv a multiple of
    it).  Returns out (B, Sq, Hq, Dv) in q's dtype and lse (B, Hkv, G, Sq),
    the f32 logsumexp of the visible logits (+1e30 where no key is
    visible, so the backward's probabilities vanish there)."""
    B, Sq, Hq, D = q.shape
    Hkv, Dv = v.shape[2], v.shape[3]
    G = Hq // Hkv
    qh, kh, vh = _heads(q, k, v, D**-0.5)
    m = _carry(torch.full((B, Hkv, G, Sq), NEG_INF, device=q.device))
    l = _carry(torch.zeros((B, Hkv, G, Sq), device=q.device))
    acc = _carry(torch.zeros((B, Hkv, G, Sq, Dv), device=q.device))
    with f32_products():
        for c in range(k.shape[1] // ck):
            k_c = kh[:, :, c * ck : (c + 1) * ck].to(torch.float32)
            v_c = vh[:, :, c * ck : (c + 1) * ck].to(torch.float32)
            mask = _chunk_mask(q_positions, kv_valid, c, ck, causal, window)
            s = (qh @ k_c.transpose(-1, -2)).view(B, Hkv, G, Sq, ck)
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
            l = l * alpha + p.sum(dim=-1)
            pv = (p.view(B, Hkv, G * Sq, ck) @ v_c).view(B, Hkv, G, Sq, Dv)
            acc = acc * alpha[..., None] + pv
            m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, Dv)
    lse = torch.where(l > 0, m + torch.log(l.clamp_min(1e-30)), -NEG_INF)
    return out.to(q.dtype), lse


class _ChunkedAttention(torch.autograd.Function):
    """The reference's custom VJP (``_make_chunked_attention``): the
    forward keeps out and lse only, and the backward recomputes each
    chunk's probabilities from lse, so training never holds every chunk's
    (Sq x ck) softmax."""

    @staticmethod
    def forward(ctx, q, k, v, q_positions, kv_valid, causal, window, ck):
        out, lse = _chunked_fwd(q, k, v, q_positions, kv_valid, causal, window, ck)
        ctx.save_for_backward(q, k, v, q_positions, kv_valid, out, lse)
        ctx.mask = (causal, window, ck)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, q_positions, kv_valid, out, lse = ctx.saved_tensors
        causal, window, ck = ctx.mask
        B, Sq, Hq, D = q.shape
        Hkv, Dv = v.shape[2], v.shape[3]
        G = Hq // Hkv
        scale = D**-0.5
        qh, kh, vh = _heads(q, k, v, scale)
        do = dout.reshape(B, Sq, Hkv, G, Dv).permute(0, 2, 3, 1, 4).to(torch.float32)
        o = out.reshape(B, Sq, Hkv, G, Dv).permute(0, 2, 3, 1, 4).to(torch.float32)
        delta = (do * o).sum(dim=-1)  # (B, Hkv, G, Sq)
        do = do.reshape(B, Hkv, G * Sq, Dv)
        dq = _carry(torch.zeros_like(qh))
        dks, dvs = [], []
        with f32_products():
            for c in range(k.shape[1] // ck):
                k_c = kh[:, :, c * ck : (c + 1) * ck].to(torch.float32)
                v_c = vh[:, :, c * ck : (c + 1) * ck].to(torch.float32)
                mask = _chunk_mask(q_positions, kv_valid, c, ck, causal, window)
                s = (qh @ k_c.transpose(-1, -2)).view(B, Hkv, G, Sq, ck)
                s = torch.where(mask, s, NEG_INF)
                p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
                dp = (do @ v_c.transpose(-1, -2)).view(B, Hkv, G, Sq, ck)
                ds = (p * (dp - delta[..., None])).view(B, Hkv, G * Sq, ck)
                p = p.view(B, Hkv, G * Sq, ck)
                dvs.append(p.transpose(-1, -2) @ do)
                # dL/dq = scale * ds @ k; dL/dk = ds^T @ (q * scale).
                dq = dq + (ds @ k_c) * scale
                dks.append(ds.transpose(-1, -2) @ qh)
        dq = dq.view(B, Hkv, G, Sq, D).permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, D)
        dk = torch.cat(dks, dim=2).permute(0, 2, 1, 3)
        dv = torch.cat(dvs, dim=2).permute(0, 2, 1, 3)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None, None, None


def chunked_attention(q, k, v, q_positions, kv_valid_len, causal: bool = True,
                      window: int | None = None, kv_chunk: int = 1024) -> torch.Tensor:
    """The reference's flash-semantic online-softmax attention, plain
    PyTorch.  q: (B, Sq, Hq, D); k: (B, Skv, Hkv, D); v: (B, Skv, Hkv, Dv)
    (Dv may differ from D); q_positions: (B, Sq) absolute positions;
    kv_valid_len: an int or (B,) -- keys at index >= it are masked.
    Returns (B, Sq, Hq, Dv) in q's dtype.  Keys run in chunks of
    ``min(kv_chunk, Skv)``, the last padded to a whole chunk; softmax in
    f32 with scale 1/sqrt(D); a row that sees no key gives zeros.
    Differentiable in q, k and v (`_ChunkedAttention`)."""
    B, Skv = q.shape[0], k.shape[1]
    ck = min(kv_chunk, Skv)
    pad = -(-Skv // ck) * ck - Skv
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    # A Python count becomes a tensor by a fill on the device: a copy from
    # the host would wait for the queue each layer.
    if isinstance(kv_valid_len, torch.Tensor):
        kv_valid = kv_valid_len.to(q.device, torch.float32).expand(B)
    else:
        kv_valid = torch.full((B,), float(kv_valid_len), device=q.device)
    q_positions = q_positions.to(q.device, torch.float32)
    if is_dtensor(q):
        return _chunked_local(q, k, v, q_positions, kv_valid, causal, window, ck)
    return _ChunkedAttention.apply(q, k, v, q_positions, kv_valid, causal, window, ck)


def _chunked_local(q, k, v, q_positions, kv_valid, causal, window, ck):
    """`_ChunkedAttention` on each device's blocks of DTensor operands
    (`local_map`): on each mesh axis, the batch where q and k split it,
    the queries' sequence where q splits it (keys whole: a query block
    sees every key, its mask from its absolute positions, as the
    reference's seq-sharded accumulators), heads where q and k split them
    alike; every other placement replicated first."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = q.device_mesh
    rep = [Replicate()] * mesh.ndim

    def dt(t):
        return t if is_dtensor(t) else DTensor.from_local(t, mesh, rep, run_check=False)

    k, v, q_positions, kv_valid = (dt(t) for t in (k, v, q_positions, kv_valid))
    pq, pk, ppos, pvalid = [], [], [], []
    for i in range(mesh.ndim):
        a, b = q.placements[i], k.placements[i]
        if a == Shard(0) and b == Shard(0) and v.placements[i] == Shard(0):
            pq.append(a), pk.append(a), ppos.append(a), pvalid.append(a)
        elif a == Shard(1):
            pq.append(a), pk.append(Replicate()), ppos.append(a), pvalid.append(Replicate())
        elif a == Shard(2) and b == Shard(2) and v.placements[i] == Shard(2):
            pq.append(a), pk.append(a), ppos.append(Replicate()), pvalid.append(Replicate())
        else:
            pq.append(Replicate()), pk.append(Replicate()), ppos.append(Replicate())
            pvalid.append(Replicate())
    pq, pk = tuple(pq), tuple(pk)

    def local(q, k, v, q_positions, kv_valid):
        return _ChunkedAttention.apply(q, k, v, q_positions, kv_valid, causal, window, ck)

    # Keys and values whole beside a query block: their gradients sum
    # over the query blocks.
    gk = tuple(Partial() if a == Shard(1) else b for a, b in zip(pq, pk))
    return local_map(local, out_placements=(pq,),
                     in_placements=(pq, pk, pk, tuple(ppos), tuple(pvalid)),
                     in_grad_placements=(pq, gk, gk, tuple(ppos), tuple(pvalid)), device_mesh=mesh,
                     redistribute_inputs=True)(q, k, v, q_positions, kv_valid)


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
    q = rope(fit_view(h @ p["wq"].to(cdt), B, S, H, Dh), positions, cfg.rope_theta)
    k = rope(fit_view(h @ p["wk"].to(cdt), B, S, Hkv, Dh), positions, cfg.rope_theta)
    v = fit_view(h @ p["wv"].to(cdt), B, S, Hkv, Dh)
    if cache is not None:
        cache["k"][:, pos : pos + S] = like(k, cache["k"])
        cache["v"][:, pos : pos + S] = like(v, cache["v"])
        k, v = cache["k"], cache["v"]
    # (B, S, H, D) viewed as the kernel's (B, H, S, D): no copy either way.
    out = flash_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=True, window=window, q_offset=pos,
    ).transpose(1, 2)
    out = fit_reshape(out, B, S, H * Dh) @ p["wo"].to(cdt)
    return out.to(x.dtype), cache


def attn_init_cache(cfg, batch: int, max_len: int, dtype, device) -> dict[str, torch.Tensor]:
    shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


# --------------------------------------------------------------------------
# MLA -- multi-head latent attention (MiniCPM3 / DeepSeek style)
# --------------------------------------------------------------------------


def mla_init(gen: torch.Generator, cfg) -> dict[str, torch.Tensor]:
    D, H = cfg.d_model, cfg.num_heads
    qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    return {
        "norm": torch.zeros(D, device=gen.device),
        "q_down": dense_init(gen, D, qr),
        "q_up": dense_init(gen, qr, H * (dn + dr)),
        "kv_down": dense_init(gen, D, kvr + dr),
        "k_up": dense_init(gen, kvr, H * dn),
        "v_up": dense_init(gen, kvr, H * dv),
        "wo": dense_init(gen, H * dv, D),
    }


def mla_apply(p, x, cfg, *, positions, cache=None, pos=0, window=None):
    """Latent attention in the reference's absorption form: queries
    ``[q_nope @ k_up | q_rope]`` against keys ``[c_kv | k_rope]`` of one kv
    head, values the latent ``c_kv``, ``v_up`` applied after attention.
    cache: {'c_kv' (B, Smax, kv_lora_rank), 'k_rope' (B, Smax,
    qk_rope_dim)} or None, written at ``pos`` in place; attention
    (`chunked_attention`) then runs over the whole cache, keys at ``pos +
    S`` and later masked, as the reference's."""
    B, S, _ = x.shape
    H, kvr = cfg.num_heads, cfg.kv_lora_rank
    dn, dv = cfg.qk_nope_dim, cfg.v_head_dim
    h = rms_norm(x, p["norm"])
    cdt = h.dtype
    q = fit_view((h @ p["q_down"].to(cdt)) @ p["q_up"].to(cdt), B, S, H, -1)
    q_nope = q[..., :dn]
    q_rope = rope(q[..., dn:], positions, cfg.rope_theta)
    kv = h @ p["kv_down"].to(cdt)
    c_kv = kv[..., :kvr]
    k_rope = rope(kv[:, :, None, kvr:], positions, cfg.rope_theta)[:, :, 0]
    kv_valid = S
    if cache is not None:
        cache["c_kv"][:, pos : pos + S] = like(c_kv, cache["c_kv"])
        cache["k_rope"][:, pos : pos + S] = like(k_rope, cache["k_rope"])
        c_kv, k_rope = cache["c_kv"], cache["k_rope"]
        kv_valid = pos + S
    q_abs = torch.einsum("bshd,rhd->bshr", q_nope, fit_view(p["k_up"].to(cdt), kvr, H, dn))
    q_cat = torch.cat([q_abs, q_rope], dim=-1)  # (B, S, H, kvr + dr)
    k_cat = torch.cat([c_kv, k_rope], dim=-1)[:, :, None, :]  # one kv head
    o_lat = chunked_attention(
        q_cat, k_cat.to(cdt), c_kv[:, :, None, :].to(cdt), positions, kv_valid,
        True, window, kv_chunk=cfg.kv_chunk,
    )  # (B, S, H, kvr)
    out = torch.einsum("bshr,rhd->bshd", o_lat, fit_view(p["v_up"].to(cdt), kvr, H, dv))
    out = fit_reshape(out, B, S, H * dv) @ p["wo"].to(cdt)
    return out.to(x.dtype), cache


def mla_init_cache(cfg, batch: int, max_len: int, dtype, device) -> dict[str, torch.Tensor]:
    return {
        "c_kv": torch.zeros((batch, max_len, cfg.kv_lora_rank), dtype=dtype, device=device),
        "k_rope": torch.zeros((batch, max_len, cfg.qk_rope_dim), dtype=dtype, device=device),
    }


# --------------------------------------------------------------------------
# cross-attention (VLM / audio conditioning; the encoder is an input)
# --------------------------------------------------------------------------


def cross_init(gen: torch.Generator, cfg) -> dict[str, torch.Tensor]:
    D, H, Dh, E = cfg.d_model, cfg.num_heads, cfg.head_dim, cfg.encoder_dim
    return {
        "norm": torch.zeros(D, device=gen.device),
        "wq": dense_init(gen, D, H * Dh),
        "wk": dense_init(gen, E, H * Dh),
        "wv": dense_init(gen, E, H * Dh),
        "wo": dense_init(gen, H * Dh, D),
    }


def cross_apply(p, x, enc, cfg):
    """x: (B, S, D); enc: (B, T, E) encoder embeddings, cast to the compute
    dtype.  Keys and values are recomputed from ``enc`` at every call, as
    the reference does; attention is the flash kernel, non-causal, every
    key visible."""
    B, S, _ = x.shape
    H, Dh = cfg.num_heads, cfg.head_dim
    h = rms_norm(x, p["norm"])
    cdt = h.dtype
    e = enc.to(cdt)
    q = fit_view(h @ p["wq"].to(cdt), B, S, H, Dh)
    k = fit_view(e @ p["wk"].to(cdt), B, -1, H, Dh)
    v = fit_view(e @ p["wv"].to(cdt), B, -1, H, Dh)
    out = flash_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal=False,
    ).transpose(1, 2)
    out = fit_reshape(out, B, S, H * Dh) @ p["wo"].to(cdt)
    return out.to(x.dtype)


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
