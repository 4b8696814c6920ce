"""starcoder2-7b [dense] — GQA, RoPE [arXiv:2402.19173]. Treated as full attention."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b",
    family="dense",
    n_layers=32,
    d_model=4608,
    n_heads=36,
    n_kv_heads=4,
    head_dim=128,
    d_ff=18432,
    vocab_size=49152,
    block_pattern=("attn",),
    rope_theta=1000000.0,
    act="gelu",
    mlp_gated=False,
)
