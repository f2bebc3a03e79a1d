"""qwen3-moe-235b-a22b [moe] — 128 experts top-8, d_ff 1536 per expert
[hf:Qwen/Qwen3-30B-A3B family scaled per assignment]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    d_ff=1536,
    vocab_size=151936,
    head_dim=128,
    layer_unit=("attn",),
    num_experts=128,
    top_k=8,
    subquadratic=False,
)
