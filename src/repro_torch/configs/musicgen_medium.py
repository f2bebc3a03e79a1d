"""musicgen-medium [audio] — decoder-only over EnCodec tokens with text
cross-attention [arXiv:2306.05284; hf].  Backbone only: the EnCodec audio
frontend and T5 text encoder are stubs — input_specs() provides the token
streams / conditioning embeddings."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    head_dim=64,
    layer_unit=("cross",),  # self-attn + text cross-attn every layer
    encoder_dim=768,  # T5-base conditioning
    encoder_len=64,
    num_codebooks=4,  # EnCodec RVQ streams (delay pattern upstream)
    subquadratic=False,
)
