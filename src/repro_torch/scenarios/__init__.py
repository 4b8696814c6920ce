"""Named stream workloads of the port (see :mod:`.registry`)."""
from repro_torch.scenarios.registry import (
    get_stream_config, list_stream_configs,
)

__all__ = ["get_stream_config", "list_stream_configs"]
