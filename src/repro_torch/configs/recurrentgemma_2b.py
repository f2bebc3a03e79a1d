"""recurrentgemma-2b [hybrid] -- RG-LRU + local attention, 2 recurrent : 1
attention [arXiv:2402.19427; hf].  Fixed-size recurrent state + 2k-window
KV => runs long_500k.  Copy of `repro.configs.recurrentgemma_2b`."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    d_ff=7680,
    vocab_size=256000,
    head_dim=256,
    layer_unit=("rglru", "rglru", "local"),
    window_size=2048,
    lru_width=2560,
    conv1d_width=4,
    subquadratic=True,
)
