"""llama-3.2-vision-11b [vlm] — cross-attn image layers
[hf:meta-llama/Llama-3.2-11B-Vision].  Backbone only: the ViT frontend is a
stub; input_specs() provides precomputed patch embeddings (B, 1601, 7680)."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    head_dim=128,
    # cross-attention layer every 5 layers (8 of 40).
    layer_unit=("cross", "attn", "attn", "attn", "attn"),
    encoder_dim=7680,
    encoder_len=1601,
    rope_theta=500000.0,
    subquadratic=False,
)
