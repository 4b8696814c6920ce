"""The reference's stream configuration, built from the plain field values
that a configuration file states (``stream_config``), nested groups
included."""
from __future__ import annotations

from perfbench.reference.stream.arrivals import ArrivalConfig
from perfbench.reference.stream.embed_config import EmbedConfig
from perfbench.reference.stream.policy import PolicyConfig
from perfbench.reference.stream.router import (
    RoutingConfig, ShardingConfig, StreamConfig, StreamLearnerConfig,
    check_supported,
)

_GROUPS = {"arrivals": ArrivalConfig, "policy": PolicyConfig,
           "routing": RoutingConfig, "sharding": ShardingConfig}


def stream_config(fields: dict) -> StreamConfig:
    """A ``StreamConfig`` of ``fields`` (the dict of a configuration
    file's ``stream_config``); raises where it takes a path the reference
    does not run."""
    kw = dict(fields)
    for key, cls in _GROUPS.items():
        kw[key] = cls(**kw[key])
    learner = dict(kw["learner"])
    if learner.get("embed") is not None:
        learner["embed"] = EmbedConfig(**learner["embed"])
    kw["learner"] = StreamLearnerConfig(**learner)
    cfg = StreamConfig(**kw)
    check_supported(cfg)
    return cfg
