"""Architecture registry of the port: --arch <id> -> exact public config.

Copies of `repro.configs`, every architecture of the reference's
``ARCHS``: GQA attention with a dense gated FFN (gemma3-1b, stablelm-1.6b,
phi3-medium-14b), multi-head latent attention (minicpm3-4b), mixtures of
experts (dbrx-132b, qwen3-moe-235b-a22b), mLSTM and sLSTM blocks
(xlstm-1.3b), RG-LRU blocks beside local attention (recurrentgemma-2b), and
cross-attention over encoder inputs (llama-3.2-vision-11b; musicgen-medium,
with four audio codebooks).
"""

from repro_torch.configs import (
    dbrx_132b,
    gemma3_1b,
    llama_3_2_vision_11b,
    minicpm3_4b,
    musicgen_medium,
    phi3_medium_14b,
    qwen3_moe_235b_a22b,
    recurrentgemma_2b,
    stablelm_1_6b,
    xlstm_1_3b,
)
from repro_torch.configs.base import SHAPES, ModelConfig, ShapeSpec

ARCHS: dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (
        musicgen_medium,
        stablelm_1_6b,
        phi3_medium_14b,
        gemma3_1b,
        minicpm3_4b,
        dbrx_132b,
        qwen3_moe_235b_a22b,
        xlstm_1_3b,
        llama_3_2_vision_11b,
        recurrentgemma_2b,
    )
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
