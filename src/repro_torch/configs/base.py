"""Model/run configuration for the architecture zoo (copy of `repro.configs.base`).

One frozen dataclass describes every assigned architecture; per-arch modules
in this package instantiate it with the exact public dimensions and a
REDUCED smoke variant of the same family for CPU tests.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

__all__ = ["ModelConfig", "SHAPES", "ShapeSpec"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads

    # Layer-kind unit, tiled to num_layers (scan groups by unit).
    # Kinds: "attn" (global), "local" (sliding window), "mla", "mlstm",
    # "slstm", "rglru", "cross" (self+cross-attn layer).
    layer_unit: Sequence[str] = ("attn",)
    window_size: int = 1024  # for "local" layers
    rope_theta: float = 10000.0

    # MoE
    num_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_groups: int = 16  # dispatch groups (aligned to data shards at launch)

    # MLA (MiniCPM3/DeepSeek-style latent attention)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_rope_dim: int = 0
    qk_nope_dim: int = 0
    v_head_dim: int = 0

    # Recurrent blocks
    lru_width: int = 0  # RG-LRU width (0 -> d_model)
    conv1d_width: int = 4
    mlstm_chunk: int = 256  # mLSTM chunkwise-parallel chunk length

    # MoE combine path: reshard expert outputs to token shards before the
    # combine gather (turns the gather backward's full all-reduce into an
    # all-to-all-shaped reshard; perf-iteration knob).
    moe_combine_reshard: bool = False

    # Cross-attention conditioning (vlm / audio)
    encoder_dim: int = 0  # frontend embedding dim (stubbed input)
    encoder_len: int = 0  # number of frontend tokens

    # Audio (EnCodec token streams)
    num_codebooks: int = 0

    # Numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    # Attention implementation of the JAX package: "chunked" (pure jnp,
    # dry-run/CPU) or "flash" (Pallas kernel, TPU runtime).  Kept so that
    # configurations compare equal; the port runs GQA and cross-attention
    # through its flash kernel on the card (its plain twin on the host) and
    # reads neither this nor q_chunk.  MLA runs the port's
    # chunked_attention, in chunks of kv_chunk keys.
    attention_impl: str = "chunked"
    q_chunk: int = 512
    kv_chunk: int = 1024

    # Sub-quadratic? (controls long_500k applicability)
    subquadratic: bool = False

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.lru_width == 0:
            object.__setattr__(self, "lru_width", self.d_model)

    @property
    def layer_kinds(self) -> tuple[str, ...]:
        unit = tuple(self.layer_unit)
        reps = -(-self.num_layers // len(unit))
        return (unit * reps)[: self.num_layers]

    def reduced(self, **overrides) -> "ModelConfig":
        """Smoke-test variant: same family/kinds, tiny dims."""
        unit = tuple(self.layer_unit)
        base = dict(
            num_layers=max(len(unit), 2),
            d_model=64,
            num_heads=4,
            num_kv_heads=max(1, min(self.num_kv_heads, 2)),
            d_ff=128 if self.d_ff else 0,
            vocab_size=256,
            head_dim=16,
            num_experts=4 if self.num_experts else 0,
            top_k=min(2, self.top_k) if self.top_k else 0,
            # No-drop capacity at smoke scale: with tiny token counts,
            # capacity drops depend on the competing token set, which would
            # (correctly, but unhelpfully for tests) make decode differ from
            # teacher-forced forward.
            capacity_factor=4.0 if self.num_experts else self.capacity_factor,
            q_lora_rank=16 if self.q_lora_rank else 0,
            kv_lora_rank=16 if self.kv_lora_rank else 0,
            qk_rope_dim=8 if self.qk_rope_dim else 0,
            qk_nope_dim=8 if self.qk_nope_dim else 0,
            v_head_dim=16 if self.v_head_dim else 0,
            lru_width=64,
            encoder_dim=32 if self.encoder_dim else 0,
            encoder_len=8 if self.encoder_len else 0,
            num_codebooks=self.num_codebooks,
            window_size=min(self.window_size, 16),
            q_chunk=16,
            kv_chunk=32,
            name=self.name + "-smoke",
        )
        base.update(overrides)
        return dataclasses.replace(self, **base)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}
