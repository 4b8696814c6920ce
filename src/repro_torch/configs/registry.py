"""Architecture registry (copy of ``src/repro/configs/registry.py``):
``--arch <id>`` resolution. Each architecture has its own module, as in
the reference; the port's model runs all ten (see
:mod:`repro_torch.models.model`).
"""
from repro_torch.configs.base import (
    SHAPES, ModelConfig, ShapeConfig, cell_supported, reduced,
)
from repro_torch.configs.granite_moe_3b_a800m import CONFIG as _granite
from repro_torch.configs.h2o_danube_1_8b import CONFIG as _danube18
from repro_torch.configs.h2o_danube_3_4b import CONFIG as _danube34
from repro_torch.configs.llama_3_2_vision_11b import CONFIG as _llama_v
from repro_torch.configs.mixtral_8x7b import CONFIG as _mixtral
from repro_torch.configs.qwen2_5_14b import CONFIG as _qwen
from repro_torch.configs.recurrentgemma_2b import CONFIG as _rgemma
from repro_torch.configs.starcoder2_7b import CONFIG as _starcoder
from repro_torch.configs.whisper_base import CONFIG as _whisper
from repro_torch.configs.xlstm_125m import CONFIG as _xlstm

# the reference's registry order (all_cells lists the cells in it)
ARCHS = {
    c.name: c
    for c in [
        _xlstm, _llama_v, _qwen, _danube18, _danube34,
        _starcoder, _granite, _mixtral, _rgemma, _whisper,
    ]
}


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
