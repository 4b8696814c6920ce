"""xlstm-125m [ssm] — sLSTM + mLSTM blocks [arXiv:2405.04517]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    head_dim=192,
    d_ff=0,                      # blocks carry their own projections
    vocab_size=50304,
    block_pattern=("mlstm", "slstm"),
)
