"""Mixture-of-experts FFN with grouped, capacity-based top-k dispatch
(port of `repro.models.moe`, on one card).

Tokens are split into G groups (`_num_groups`), and within each group every
(token, slot) pair gets its rank among the pairs routed to the same expert,
in token-major, slot-minor order.  Pairs ranked below the capacity C
(`moe_capacity`) are scattered into a (G, E x C, D) buffer, the experts'
SwiGLU runs as three batched products, and each pair's output is gathered
back and weighted by its gate.  A pair past capacity is dropped: its token
row is zeroed (and lands, harmlessly, on its expert's last row) and its
gate is zero.

Each step copies the reference's arithmetic, since each decides which token
reaches which expert: router logits in the compute dtype, the softmax in
f32; the top k as ``jax.lax.top_k`` picks them, ties to the lower expert
index (`top_k`; ``torch.topk`` breaks ties otherwise); the weights
normalised by ``max(sum, 1e-9)``; the scatter in the compute dtype, where
at most one nonzero lands in a row, so the order of ``index_add`` leaves
the bits alone; the combine summed over k in the compute dtype.  Autograd
differentiates through the softmax and the gates as ``jax.grad`` does;
ranks and choices carry no gradient.  The reference's sharding hints have
no counterpart on one card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init, rms_norm

__all__ = ["moe_capacity", "moe_init", "moe_apply", "route", "top_k"]


def moe_capacity(tokens_per_group: int, cfg) -> int:
    avg = tokens_per_group * cfg.top_k / cfg.num_experts
    cap = int(avg * cfg.capacity_factor) + 1
    return max(8, -(-cap // 8) * 8)  # round up to a multiple of 8


def moe_init(gen: torch.Generator, cfg, dtype: torch.dtype = torch.float32) -> dict:
    """f32 router and norm; the (E, D, F), (E, D, F), (E, F, D) expert
    stacks drawn in f32 and held in ``dtype`` one at a time, so that a
    server never holds a layer's stacks in f32 at once."""
    D, Fd, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    dev = gen.device

    def stack(shape, fan_in):
        return (torch.randn(shape, generator=gen, device=dev) * fan_in**-0.5).to(dtype)

    return {
        "norm": torch.zeros(D, device=dev),
        "w_router": dense_init(gen, D, E),
        "w_gate": stack((E, D, Fd), D),
        "w_up": stack((E, D, Fd), D),
        "w_down": stack((E, Fd, D), Fd),
    }


def _num_groups(cfg, T: int) -> int:
    G = getattr(cfg, "moe_groups", 16)
    if G > 1 and T % G == 0 and T // G >= 256:
        return G
    return 1


def top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest of the last axis, largest first, equal values in
    index order: ``jax.lax.top_k``'s choice and order."""
    values, index = torch.sort(probs, dim=-1, descending=True, stable=True)
    return values[..., :k], index[..., :k]


def route(h: torch.Tensor, w_router: torch.Tensor, cfg, C: int):
    """h: (G, Tg, D) in the compute dtype.  Returns the gates (G, Tg, K)
    in f32, zero where dropped; the experts (G, Tg, K); each pair's rank
    within its expert and group (G, Tg, K); and whether it was kept."""
    G, Tg, _ = h.shape
    E, K = cfg.num_experts, cfg.top_k
    logits = (h @ w_router.to(h.dtype)).to(torch.float32)
    gate_w, gate_e = top_k(torch.softmax(logits, dim=-1), K)
    gate_w = gate_w / gate_w.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    # Exclusive prefix count per expert over the (Tg x K) pairs of a group.
    # (a comparison, not F.one_hot, whose bounds check waits for the card)
    onehot = (gate_e.reshape(G, Tg * K, 1) == torch.arange(E, device=h.device)).long()
    ranks = onehot.cumsum(dim=1) - onehot
    rank = ranks.gather(-1, gate_e.reshape(G, Tg * K, 1)).reshape(G, Tg, K)
    keep = rank < C
    return torch.where(keep, gate_w, 0.0), gate_e, rank, keep


def moe_apply(p, x: torch.Tensor, cfg) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D).  Static capacity, top-k, grouped."""
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.top_k
    T = B * S
    G = _num_groups(cfg, T)
    Tg = T // G
    C = moe_capacity(Tg, cfg)
    h = rms_norm(x, p["norm"]).reshape(G, Tg, D)
    cdt = h.dtype
    gate_w, gate_e, rank, keep = route(h, p["w_router"], cfg, C)

    # Dispatch: a dropped pair's token is zeroed and its slot clamped into
    # its expert's last row, where adding zeros changes nothing.
    slot = gate_e * C + rank.clamp_max(C - 1)  # (G, Tg, K)
    rows = (slot + E * C * torch.arange(G, device=x.device)[:, None, None]).reshape(-1)
    tok = torch.where(keep[..., None], h[:, :, None, :], 0.0).reshape(G * Tg * K, D)
    buf = torch.zeros((G * E * C, D), dtype=cdt, device=x.device).index_add(0, rows, tok)
    expert_in = buf.view(G, E, C, D)

    g_act = F.silu(torch.einsum("gecd,edf->gecf", expert_in, p["w_gate"].to(cdt)))
    u = torch.einsum("gecd,edf->gecf", expert_in, p["w_up"].to(cdt))
    eo = torch.einsum("gecf,efd->gecd", g_act * u, p["w_down"].to(cdt))

    # Combine: each pair's expert output (a dropped pair reads a real row
    # and weighs it by zero), weighted and summed over k in cdt.
    out_k = eo.reshape(G * E * C, D)[rows].view(G, Tg, K, D)
    out = (out_k * gate_w[..., None].to(cdt)).sum(dim=2)
    return out.reshape(B, S, D).to(x.dtype)
