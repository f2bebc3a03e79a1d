"""Architecture registry of the port: --arch <id> -> exact public config.

Copies of `repro.configs` for the architectures whose layer kinds the
port runs: global and sliding-window GQA attention with a dense gated FFN
(gemma3-1b, stablelm-1.6b, phi3-medium-14b), mLSTM and sLSTM blocks
(xlstm-1.3b), and RG-LRU blocks beside local attention
(recurrentgemma-2b).  The other five come with their layer kinds
(ROADMAP.md, Queue 1).
"""

from repro_torch.configs import (
    gemma3_1b, phi3_medium_14b, recurrentgemma_2b, stablelm_1_6b, xlstm_1_3b,
)
from repro_torch.configs.base import SHAPES, ModelConfig, ShapeSpec

ARCHS: dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (stablelm_1_6b, phi3_medium_14b, gemma3_1b, xlstm_1_3b, recurrentgemma_2b)
}


def get_arch(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


def applicable_shapes(cfg: ModelConfig) -> list[str]:
    """Shapes this arch runs; long_500k only for sub-quadratic archs."""
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.subquadratic:
        out.append("long_500k")
    return out


__all__ = [
    "ARCHS",
    "get_arch",
    "applicable_shapes",
    "SHAPES",
    "ShapeSpec",
    "ModelConfig",
]
