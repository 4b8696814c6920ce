"""recurrentgemma-2b [hybrid]: RG-LRU + local attention, 2:1 pattern
[arXiv:2402.19427]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,                 # 8 (rglru, rglru, attn) groups + 2-layer tail
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,                # MQA
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    block_pattern=("rglru", "rglru", "attn"),
    window=2048,                 # local attention window
    lru_width=2560,
    conv_width=4,
    act="gelu",
)
