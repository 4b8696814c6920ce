"""llama-3.2-vision-11b [vlm] — cross-attn image layers [hf:meta-llama/Llama-3.2-11B-Vision].

The vision frontend is a STUB per the brief: input_specs() provides
precomputed patch embeddings of shape (batch, n_img_tokens, d_model).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=128256,
    block_pattern=("attn",),
    cross_attn_every=5,          # every 5th layer carries a cross-attn sub-block
    n_img_tokens=1600,
    rope_theta=500000.0,
)
