"""Roofline terms for the port's dry-run and measured steps (port of
`repro.launch.roofline`), with the H100's constants and no TPU constant.

Three terms per (arch x shape x mesh) cell, per device:

  compute term    = device FLOPs / peak FLOP/s
  memory term     = device bytes accessed / HBM bytes/s
  collective term = device collective bytes / link bytes/s

The counts come from `repro_torch.launch.op_cost` (the reference parses
them from HLO text; its ``collective_bytes`` parser has no input in the
port, and the counter replaces it).
"""

from __future__ import annotations

import dataclasses

from repro_torch import tree

__all__ = ["HW", "Hardware", "roofline_terms", "roofline_fraction", "model_flops"]


@dataclasses.dataclass(frozen=True)
class Hardware:
    """One card's published peaks (NVIDIA's data sheet, H100 SXM, dense)."""

    #: bf16 tensor-core FLOP/s of an NVIDIA H100 80GB HBM3 at 700.00 W.
    peak_flops: float = 989e12
    #: HBM3 bytes/s of an NVIDIA H100 80GB HBM3 at 700.00 W.
    hbm_bw: float = 3.35e12
    #: NVLink 4 bytes/s per direction of an NVIDIA H100 80GB HBM3 (SXM,
    #: 900 GB/s both ways together) at 700.00 W.
    link_bw: float = 450e9
    #: Device memory of an NVIDIA H100 80GB HBM3 (the "80 GB" of its name).
    hbm_bytes: float = 80e9


HW = Hardware()


def roofline_terms(
    device_flops: float,
    device_bytes: float,
    device_collective_bytes: float,
    hw: Hardware = HW,
) -> dict[str, float]:
    compute = device_flops / hw.peak_flops
    memory = device_bytes / hw.hbm_bw
    collective = device_collective_bytes / hw.link_bw
    terms = {"compute_s": compute, "memory_s": memory, "collective_s": collective}
    dominant = max(terms, key=terms.get)
    total = max(terms.values())
    terms["dominant"] = dominant
    terms["bound_s"] = total
    return terms


def roofline_fraction(bound_s: float, measured_s: float) -> float:
    """Achieved fraction of the roofline bound: 1.0 means the measured
    time equals the hardware limit; small values mean the program sits far
    under the roofline (overhead or latency bound).  0.0 when nothing was
    measured."""
    if measured_s <= 0:
        return 0.0
    return bound_s / measured_s


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6*N*D with N = active params (MoE: routed active only),
    D = tokens processed.  Decode steps process global_batch tokens."""
    from repro_torch.models.model import build_model

    shapes = build_model(cfg, "meta").abstract_params()
    leaves = tree.leaves(shapes)
    total = sum(t.numel() for t in leaves)
    if cfg.num_experts:
        # Replace each layer's (E, D, F) expert stacks by the activated
        # fraction.
        expert_params = sum(
            t.numel()
            for path, t in zip(tree.paths(shapes), leaves)
            if t.dim() == 3 and cfg.num_experts in t.shape
            and path.split("/")[-1] in ("w_gate", "w_up", "w_down")
        )
        active = total - expert_params + expert_params * (cfg.top_k / cfg.num_experts)
    else:
        active = total
    if shape.kind == "train":
        return 6.0 * active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * active * shape.global_batch * shape.seq_len
    return 2.0 * active * shape.global_batch  # one new token per sequence
