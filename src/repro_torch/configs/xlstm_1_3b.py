"""xlstm-1.3b [ssm] — sLSTM + mLSTM blocks [arXiv:2405.04517].

xLSTM[7:1]: 7 mLSTM (matrix-memory, chunked parallel) per 1 sLSTM
(sequential recurrence).  d_ff = 0: blocks carry their own projections.
Constant-size state => runs long_500k."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    head_dim=512,
    layer_unit=(
        "mlstm", "mlstm", "mlstm", "mlstm", "mlstm", "mlstm", "mlstm", "slstm",
    ),
    subquadratic=True,
)
