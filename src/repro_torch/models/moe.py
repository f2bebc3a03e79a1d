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
ranks and choices carry no gradient.

The reference's five sharding hints (`repro_torch.launch.sharding.
constrain`) sit at its sites and act on DTensors only.  DTensor has no
sharding rule for the dispatch's stable sort, cumulative count and
``index_add``, nor for the combine's row gather, so on DTensors those two
regions run on each device's blocks (`local_map`, `_on_groups`): a group
lives on its data shard, as the reference's vmapped per-group scatter
keeps the dispatch local; the expert products between them run as
DTensor operations on the expert stacks sharded over ``model``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.common import is_dtensor
from repro_torch.launch.sharding import constrain, fit_reshape, fit_view
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


def _dispatch(h: torch.Tensor, w_router: torch.Tensor, cfg, C: int):
    """Route and scatter the groups of ``h`` (G, Tg, D): the (G, E, C, D)
    expert inputs, each pair's buffer row within its group (G, Tg, K) and
    its gate (G, Tg, K) f32."""
    G, Tg, D = h.shape
    E, K = cfg.num_experts, cfg.top_k
    gate_w, gate_e, rank, keep = route(h, w_router, cfg, C)

    # Dispatch: a dropped pair's token is zeroed and its slot clamped into
    # its expert's last row, where adding zeros changes nothing.
    slot = gate_e * C + rank.clamp_max(C - 1)  # (G, Tg, K)
    rows = (slot + E * C * torch.arange(G, device=h.device)[:, None, None]).reshape(-1)
    tok = torch.where(keep[..., None], h[:, :, None, :], 0.0).reshape(G * Tg * K, D)
    buf = torch.zeros((G * E * C, D), dtype=h.dtype, device=h.device).index_add(0, rows, tok)
    return buf.view(G, E, C, D), slot, gate_w


def _combine(eo: torch.Tensor, slot: torch.Tensor, gate_w: torch.Tensor) -> torch.Tensor:
    """Each pair's expert output (a dropped pair reads a real row and
    weighs it by zero), weighted and summed over k in eo's dtype: (G, Tg,
    D)."""
    G, E, C, D = eo.shape
    rows = (slot + E * C * torch.arange(G, device=eo.device)[:, None, None]).reshape(-1)
    out_k = eo.reshape(G * E * C, D)[rows].view(*slot.shape, D)
    return (out_k * gate_w[..., None].to(eo.dtype)).sum(dim=2)


def _on_groups(fn, args: tuple, n_out: int, replicated: tuple[int, ...] = ()):
    """``fn`` on each device's groups (`local_map`): every operand but those
    at ``replicated`` (the router), and every result, split on its leading
    (group) axis over the mesh axes that split the first operand's,
    replicated on the others."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = args[0].device_mesh
    groups = tuple(p if p == Shard(0) else Replicate() for p in args[0].placements)
    rep = (Replicate(),) * mesh.ndim
    # A replicated operand's gradient sums over the group blocks.
    rep_grad = tuple(Partial() if p == Shard(0) else Replicate() for p in groups)
    args = tuple(a if isinstance(a, DTensor)
                 else DTensor.from_local(a, mesh, list(rep), run_check=False) for a in args)
    in_pl = tuple(rep if i in replicated else groups for i in range(len(args)))
    in_grad = tuple(rep_grad if i in replicated else groups for i in range(len(args)))
    out_pl = (groups,) * n_out
    return local_map(fn, out_placements=out_pl, in_placements=in_pl, in_grad_placements=in_grad,
                     device_mesh=mesh, redistribute_inputs=True)(*args)


def moe_apply(p, x: torch.Tensor, cfg) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D).  Static capacity, top-k, grouped."""
    B, S, D = x.shape
    T = B * S
    G = _num_groups(cfg, T)
    Tg = T // G
    C = moe_capacity(Tg, cfg)
    h = constrain(fit_reshape(rms_norm(x, p["norm"]), G, Tg, D), "expert_group", None, None)
    cdt = h.dtype
    if is_dtensor(h):
        expert_in, slot, gate_w = _on_groups(
            lambda h, w: _dispatch(h, w, cfg, C), (h, p["w_router"]), 3, replicated=(1,))
    else:
        expert_in, slot, gate_w = _dispatch(h, p["w_router"], cfg, C)
    expert_in = constrain(expert_in, "expert_group", "expert", None, None)

    g_act = F.silu(torch.einsum("gecd,edf->gecf", expert_in, p["w_gate"].to(cdt)))
    u = torch.einsum("gecd,edf->gecf", expert_in, p["w_up"].to(cdt))
    eo = torch.einsum("gecf,efd->gecd", g_act * u, p["w_down"].to(cdt))
    eo = constrain(eo, "expert_group", "expert", None, None)
    if cfg.moe_combine_reshard:
        eo = constrain(eo, "expert_group", None, None, None)

    if is_dtensor(eo):
        out = _on_groups(_combine, (eo, slot, gate_w), 1)
    else:
        out = _combine(eo, slot, gate_w)
    return fit_reshape(out, B, S, D).to(x.dtype)
