"""Named workloads of the port (see :mod:`.registry`) and the learning
front door (:func:`.facade.run_learning`)."""
from repro_torch.scenarios.facade import run_learning, spec_dataset
from repro_torch.scenarios.registry import (
    LearningSpec, get_fast_config, get_learning_spec, get_stream_config,
    list_fast_configs, list_stream_configs,
)

__all__ = ["LearningSpec", "get_fast_config", "get_learning_spec",
           "get_stream_config", "list_fast_configs", "list_stream_configs",
           "run_learning", "spec_dataset"]
