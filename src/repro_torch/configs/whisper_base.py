"""whisper-base [audio] — encoder-decoder; conv frontend STUBBED [arXiv:2212.04356].

input_specs() provides precomputed frame embeddings (batch, encoder_seq, d_model)
in place of the mel-spectrogram conv stack.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="audio",
    n_layers=6,                  # decoder layers
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    head_dim=64,
    d_ff=2048,
    vocab_size=51865,
    block_pattern=("attn",),
    cross_attn_every=1,          # every decoder layer cross-attends the encoder
    n_encoder_layers=6,
    encoder_seq=1500,
    act="gelu",
    mlp_gated=False,
    norm="layernorm",
)
