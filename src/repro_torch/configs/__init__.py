"""Model architectures of the port: plain frozen dataclasses, no torch."""
from repro_torch.configs.base import ModelConfig, reduced
from repro_torch.configs.registry import ARCHS, get_config

__all__ = ["ARCHS", "ModelConfig", "get_config", "reduced"]
