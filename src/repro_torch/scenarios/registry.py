"""The port's copies of the reference's registered workloads.

Each stream entry is the ``StreamConfig`` that ``repro.scenarios.compile.
to_stream_config(get_scenario(name))`` lowers the reference's registry
scenario to (``src/repro/scenarios/registry.py``); each batch entry is the
``FastConfig`` that ``to_fast_config`` lowers it to, with the scenario's
dataset and learner fields that ``run_learning`` reads
(:class:`LearningSpec`). This stands in for the reference's declarative
spec layer until that is ported.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.simfast import FastConfig
from repro_torch.labelstream.arrivals import ArrivalConfig
from repro_torch.labelstream.policy import PolicyConfig
from repro_torch.labelstream.router import StreamConfig

# shared stream dimensions: 2 shards x 8 workers, 32-slot windows, poisson
# 0.01 tasks/s, 5 s ticks, 16 s histogram bins
_DIMS = dict(arrivals=ArrivalConfig(kind="poisson", rate=0.01),
             tis_bin_s=16.0)
# task difficulty skew: a quarter of tasks pulled toward chance
_SKEW = dict(p_hard=0.25, hard_scale=0.3)

_CONFIGS = {
    "stream_default": StreamConfig(
        **_DIMS, pm_l=240.0,
        policy=PolicyConfig(adaptive=True, votes_cap=3, conf_threshold=0.95,
                            min_votes=1, max_outstanding=1)),
    # the naive fixed-batch baseline: admission gated until the window
    # drains, no straggler mitigation, fixed 3 votes
    "stream_batch_replay": StreamConfig(
        **_DIMS, batch_replay=True, straggler=False,
        policy=PolicyConfig(adaptive=False, votes_cap=3)),
    "skewed_fixed5": StreamConfig(
        **_DIMS, **_SKEW, pm_l=240.0,
        policy=PolicyConfig(adaptive=False, votes_cap=5)),
    "skewed_adaptive5": StreamConfig(
        **_DIMS, **_SKEW, pm_l=240.0,
        policy=PolicyConfig(adaptive=True, votes_cap=5, conf_threshold=0.98,
                            min_votes=2, max_outstanding=2)),
}


def list_stream_configs() -> list:
    """Sorted names of the ported stream workloads."""
    return sorted(_CONFIGS)


def get_stream_config(name: str, overrides: dict = None) -> StreamConfig:
    """The named workload's ``StreamConfig`` with top-level field
    ``overrides`` applied (e.g. ``{"refresh_every": 40}``)."""
    try:
        cfg = _CONFIGS[name]
    except KeyError:
        raise KeyError(f"unknown stream workload {name!r}; ported: "
                       f"{', '.join(list_stream_configs())}") from None
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


@dataclasses.dataclass(frozen=True)
class LearningSpec:
    """The scenario fields ``run_learning`` reads besides the
    ``FastConfig``: the Gaussian dataset's width and separation, the class
    count, and the learner policy (kind PL/AL/HL, active fraction, decision
    latency). Defaults are the reference's ``ScenarioSpec`` defaults."""
    n_features: int = 8
    class_sep: float = 1.8
    n_classes: int = 2
    kind: str = "HL"
    al_fraction: float = 0.5
    decision_latency_s: float = 15.0


_FAST = {
    "smallR1": FastConfig(pool_size=10, n_tasks=40),
    # the whole 400-task set as one batch, 3-vote QC, PM_l=150 maintenance
    "throughput_v3_pm": FastConfig(pool_size=15, n_tasks=400, batch_size=400,
                                   votes_needed=3, pm_l=150.0,
                                   max_batch_time=2e5),
    # the hybrid-learning acceptance workload: one 10-worker pool labeling
    # learner-selected batches
    "hybrid_small": FastConfig(pool_size=10),
}
_LEARNING = {name: LearningSpec() for name in _FAST}


def list_fast_configs() -> list:
    """Sorted names of the ported batch-engine workloads."""
    return sorted(_FAST)


def get_fast_config(name: str, overrides: dict = None) -> FastConfig:
    """The named workload's ``FastConfig`` with top-level field
    ``overrides`` applied."""
    try:
        cfg = _FAST[name]
    except KeyError:
        raise KeyError(f"unknown batch workload {name!r}; ported: "
                       f"{', '.join(list_fast_configs())}") from None
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def get_learning_spec(name: str) -> LearningSpec:
    """The named workload's dataset and learner fields."""
    get_fast_config(name)
    return _LEARNING[name]
