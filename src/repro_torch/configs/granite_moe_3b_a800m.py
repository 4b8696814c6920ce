"""granite-moe-3b-a800m [moe] — 40 experts top-8, d_ff=512/expert [hf:ibm-granite]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab_size=49155,
    block_pattern=("moe",),
    n_experts=40,
    moe_top_k=8,
)
