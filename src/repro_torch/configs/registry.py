"""Architecture registry (copy of ``src/repro/configs/registry.py``).

``recurrentgemma-2b`` has its own module; the other architectures are
copied here as data. The port's model runs all ten (see
:mod:`repro_torch.models.model`).
"""
from repro_torch.configs.base import (
    SHAPES, ModelConfig, ShapeConfig, cell_supported, reduced,
)
from repro_torch.configs.recurrentgemma_2b import CONFIG as _rgemma

_OTHERS = (
    ModelConfig(name="xlstm-125m", family="ssm", n_layers=12, d_model=768,
                n_heads=4, n_kv_heads=4, head_dim=192, d_ff=0,
                vocab_size=50304, block_pattern=("mlstm", "slstm")),
    ModelConfig(name="llama-3.2-vision-11b", family="vlm", n_layers=40,
                d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
                d_ff=14336, vocab_size=128256, cross_attn_every=5,
                n_img_tokens=1600, rope_theta=500000.0),
    ModelConfig(name="qwen2.5-14b", family="dense", n_layers=48,
                d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
                d_ff=13824, vocab_size=152064, qkv_bias=True,
                rope_theta=1000000.0, tie_embeddings=False),
    ModelConfig(name="h2o-danube-1.8b", family="dense", n_layers=24,
                d_model=2560, n_heads=32, n_kv_heads=8, head_dim=80,
                d_ff=6912, vocab_size=32000, window=4096),
    ModelConfig(name="h2o-danube-3-4b", family="dense", n_layers=24,
                d_model=3840, n_heads=32, n_kv_heads=8, head_dim=120,
                d_ff=10240, vocab_size=32000, window=4096),
    ModelConfig(name="starcoder2-7b", family="dense", n_layers=32,
                d_model=4608, n_heads=36, n_kv_heads=4, head_dim=128,
                d_ff=18432, vocab_size=49152, rope_theta=1000000.0,
                act="gelu", mlp_gated=False),
    ModelConfig(name="granite-moe-3b-a800m", family="moe", n_layers=32,
                d_model=1536, n_heads=24, n_kv_heads=8, head_dim=64,
                d_ff=512, vocab_size=49155, block_pattern=("moe",),
                n_experts=40, moe_top_k=8),
    ModelConfig(name="mixtral-8x7b", family="moe", n_layers=32,
                d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
                d_ff=14336, vocab_size=32000, block_pattern=("moe",),
                n_experts=8, moe_top_k=2, window=4096, tie_embeddings=False),
    ModelConfig(name="whisper-base", family="audio", n_layers=6, d_model=512,
                n_heads=8, n_kv_heads=8, head_dim=64, d_ff=2048,
                vocab_size=51865, cross_attn_every=1, n_encoder_layers=6,
                encoder_seq=1500, act="gelu", mlp_gated=False,
                norm="layernorm"),
)

# the reference's registry order (all_cells lists the cells in it)
ARCHS = {c.name: c for c in _OTHERS[:8] + (_rgemma,) + _OTHERS[8:]}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def all_cells():
    """Every (arch, shape) cell with its supported flag and reason."""
    out = []
    for a in ARCHS.values():
        for s in SHAPES.values():
            ok, why = cell_supported(a, s)
            out.append((a, s, ok, why))
    return out


__all__ = [
    "ARCHS", "SHAPES", "ModelConfig", "ShapeConfig",
    "get_config", "all_cells", "cell_supported", "reduced",
]
