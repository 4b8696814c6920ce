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
from repro_torch.embed.config import EmbedConfig
from repro_torch.labelstream.arrivals import ArrivalConfig
from repro_torch.labelstream.policy import PolicyConfig
from repro_torch.labelstream.router import (
    ShardingConfig, StreamConfig, StreamLearnerConfig,
)
from repro_torch.labelstream.routing import RoutingConfig

# shared stream dimensions: 2 shards x 8 workers, 32-slot windows, poisson
# 0.01 tasks/s, 5 s ticks, 16 s histogram bins
_DIMS = dict(arrivals=ArrivalConfig(kind="poisson", rate=0.01),
             tis_bin_s=16.0)
# task difficulty skew: a quarter of tasks pulled toward chance
_SKEW = dict(p_hard=0.25, hard_scale=0.3)
# the heterogeneous pool: wide Beta(2, 1) accuracy spread, a weak estimation
# prior, hour-long sessions, drip adaptive redundancy, 8 s histogram bins
_HET = dict(acc_a=2.0, acc_b=1.0, est_prior_n=2.0, session_mean_s=3600.0,
            tis_bin_s=8.0,
            policy=PolicyConfig(adaptive=True, votes_cap=5,
                                conf_threshold=0.95, min_votes=1,
                                max_outstanding=1))
# bursty admission: 8-slot windows under an MMPP burst process
_BURSTY = dict(_HET, window=8,
               arrivals=ArrivalConfig(kind="mmpp", rate=0.01, rate_hi=0.12,
                                      dwell_mean_s=900.0))
_ROUTED = RoutingConfig(enabled=True)

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
    # skewed_adaptive5 with the learner fused into the posterior
    "skewed_learner_fused": StreamConfig(
        **_DIMS, **_SKEW, pm_l=240.0,
        policy=PolicyConfig(adaptive=True, votes_cap=5, conf_threshold=0.98,
                            min_votes=2, max_outstanding=2),
        learner=StreamLearnerConfig(enabled=True)),
    "heterogeneous_pool": StreamConfig(
        **_HET, window=16,
        arrivals=ArrivalConfig(kind="poisson", rate=0.012)),
    "heterogeneous_routed": StreamConfig(
        **_HET, window=16,
        arrivals=ArrivalConfig(kind="poisson", rate=0.012),
        routing=_ROUTED),
    "bursty_admission": StreamConfig(
        **_BURSTY,
        learner=StreamLearnerConfig(enabled=True, class_sep=1.2,
                                    min_votes_known=0),
        routing=_ROUTED),
    "bursty_admission_uncertain": StreamConfig(
        **_BURSTY,
        learner=StreamLearnerConfig(enabled=True, class_sep=1.2,
                                    min_votes_known=0),
        routing=RoutingConfig(enabled=True, admission="uncertain")),
    # a third of tasks at chance for every worker, and visibly so in
    # feature space (their class separation shrunk to a tenth)
    "chance_hard": StreamConfig(
        **_BURSTY, p_hard=0.35, hard_scale=0.0,
        learner=StreamLearnerConfig(enabled=True, class_sep=3.0,
                                    hard_sep_scale=0.1),
        routing=_ROUTED),
    # 8 shards x 16 workers, pressure stealing between shards
    "stream_sharded": StreamConfig(
        n_shards=8, pool_size=16, window=16, pm_l=240.0, tis_bin_s=16.0,
        arrivals=ArrivalConfig(kind="poisson", rate=0.04),
        policy=PolicyConfig(adaptive=True, votes_cap=3, conf_threshold=0.95,
                            min_votes=1, max_outstanding=1),
        sharding=ShardingConfig(steal="pressure", steal_slack=1)),
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
    ``FastConfig``: the dataset's features (``feature_kind`` "gaussian" or
    "lm", width, separation, the hard tasks' separation scale), the class
    count and the share of hard tasks, the LM embedding (``embed``, read
    when ``feature_kind == "lm"``), and the learner policy (kind PL/AL/HL,
    active fraction, decision latency). Defaults are the reference's
    ``ScenarioSpec`` defaults."""
    n_features: int = 8
    class_sep: float = 1.8
    n_classes: int = 2
    kind: str = "HL"
    al_fraction: float = 0.5
    decision_latency_s: float = 15.0
    feature_kind: str = "gaussian"
    hard_sep_scale: float = 1.0
    p_hard: float = 0.0
    embed: EmbedConfig = EmbedConfig()

    def __post_init__(self):
        def fail(field, msg):
            raise ValueError(f"LearningSpec.{field}: {msg}")
        if self.feature_kind not in ("gaussian", "lm"):
            fail("feature_kind", "must be 'gaussian' or 'lm', got "
                 f"{self.feature_kind!r}")
        if not 0.0 < self.hard_sep_scale <= 1.0:
            fail("hard_sep_scale", f"must be in (0, 1], got "
                 f"{self.hard_sep_scale}")
        if not 0.0 <= self.p_hard <= 1.0:
            fail("p_hard", f"must be in [0, 1], got {self.p_hard}")
        if self.embed.bank_size % (2 * self.n_classes) != 0:
            fail("embed.bank_size", f"{self.embed.bank_size} must be a "
                 f"multiple of 2 * n_classes = {2 * self.n_classes}")
        pd = self.embed.projection_dim
        if pd is not None and pd != self.n_features:
            fail("embed.projection_dim", f"{pd} must equal n_features "
                 f"{self.n_features}")


# the reference's dotted override keys that the learning path reads, and
# the LearningSpec field each one sets ("embed.<field>" sets that
# EmbedConfig field)
_OVERRIDE_FIELDS = {
    "features.kind": "feature_kind",
    "features.n_features": "n_features",
    "features.class_sep": "class_sep",
    "features.hard_sep_scale": "hard_sep_scale",
    "difficulty.p_hard": "p_hard",
}


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


def get_learning_spec(name: str, overrides: dict = None) -> LearningSpec:
    """The named workload's dataset and learner fields, with the
    reference's dotted ``overrides`` applied (``"features.kind"``,
    ``"embed.model"``, ``"embed.reduced"``, ``"embed.seq_len"``,
    ``"embed.batch_size"``, ... ; see ``_OVERRIDE_FIELDS``)."""
    get_fast_config(name)
    spec = _LEARNING[name]
    top, embed = {}, {}
    for key, value in (overrides or {}).items():
        if key.startswith("embed."):
            field = key[len("embed."):]
            if field not in {f.name for f in dataclasses.fields(EmbedConfig)}:
                raise KeyError(f"unknown override {key!r}")
            embed[field] = value
        elif key in _OVERRIDE_FIELDS:
            top[_OVERRIDE_FIELDS[key]] = value
        else:
            raise KeyError(f"unknown learning override {key!r}; supported: "
                           f"{sorted(_OVERRIDE_FIELDS)} and embed.<field>")
    if embed:
        top["embed"] = dataclasses.replace(spec.embed, **embed)
    return dataclasses.replace(spec, **top) if top else spec
