"""gemma3-1b [dense] — 5:1 local:global attention, 128k context
[hf:google/gemma-3-1b-pt].  Local layers use a 512-token sliding window;
every 6th layer is global.  Runs long_500k: decode cost is O(window) for
5/6 of the layers and O(seq) for the global 1/6 (DESIGN.md §5)."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b",
    family="dense",
    num_layers=26,
    d_model=1152,
    num_heads=4,
    num_kv_heads=1,
    d_ff=6912,
    vocab_size=262144,
    head_dim=256,
    layer_unit=("local", "local", "local", "local", "local", "attn"),
    window_size=512,
    rope_theta=1_000_000.0,
    subquadratic=True,
)
