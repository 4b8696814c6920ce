"""Model architectures and workload shapes of the port: plain frozen
dataclasses, no torch."""
from repro_torch.configs.base import (
    SHAPES, ModelConfig, ShapeConfig, cell_supported, reduced,
)
from repro_torch.configs.registry import ARCHS, all_cells, get_config

__all__ = ["ARCHS", "SHAPES", "ModelConfig", "ShapeConfig", "all_cells",
           "cell_supported", "get_config", "reduced"]
