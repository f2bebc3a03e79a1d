"""minicpm3-4b [dense] — multi-head latent attention (MLA)
[hf:openbmb/MiniCPM3-4B].  The latent cache (kv_lora_rank + rope dims per
token, head-count independent) is the arch's long-context selling point."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b",
    family="dense",
    num_layers=62,
    d_model=2560,
    num_heads=40,
    num_kv_heads=40,
    d_ff=6400,
    vocab_size=73448,
    layer_unit=("mla",),
    q_lora_rank=768,
    kv_lora_rank=256,
    qk_rope_dim=32,
    qk_nope_dim=64,
    v_head_dim=64,
    subquadratic=False,
)
