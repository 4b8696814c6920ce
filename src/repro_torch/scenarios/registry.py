"""Named scenario registry: the canonical workloads, one name each (port of
``src/repro/scenarios/registry.py``).

``get_scenario(name, {"pool.pool_size": 6})`` applies dotted-path
overrides through :func:`repro_torch.scenarios.spec.override`. The seeded
specs are the reference's, so they lower to the reference's engine configs
field for field.

Below the registry sit the port's older name-keyed helpers, now thin
wrappers over it: :func:`get_stream_config` / :func:`get_fast_config`
(the lowered config, with top-level config-field overrides) and
:func:`get_learning_spec` (the fields ``run_learning`` reads, as a
:class:`LearningSpec`).
"""
from __future__ import annotations

import dataclasses

from repro_torch.embed.config import EmbedConfig
from repro_torch.scenarios.compile import (
    engines, to_embed_config, to_fast_config, to_stream_config,
)
from repro_torch.scenarios.spec import (
    AdmissionSpec, ArrivalSpec, DifficultySpec, EmbedSpec, EngineKnobs,
    FeatureSpec, GridSpec, LearnerSpec, MaintenanceSpec, PolicySpec,
    PoolSpec, RedundancySpec, RoutingSpec, ScenarioSpec, ServeSpec,
    ShardingSpec, StragglerSpec, override,
)

_REGISTRY: dict = {}
_GRIDS: dict = {}


def register_scenario(name: str, spec: ScenarioSpec, *,
                      overwrite: bool = False) -> ScenarioSpec:
    """Register ``spec`` under ``name``. Re-registering an existing name
    without ``overwrite=True`` raises (silent replacement of a canonical
    workload would invalidate committed bench baselines)."""
    if not name:
        raise ValueError("register_scenario: name must be non-empty")
    if name in _REGISTRY and not overwrite:
        raise ValueError(f"scenario {name!r} is already registered "
                         "(pass overwrite=True to replace it)")
    if not isinstance(spec, ScenarioSpec):
        raise TypeError("register_scenario: spec must be a ScenarioSpec, "
                        f"got {type(spec).__name__}")
    spec = spec if spec.name == name else \
        override(spec, {"name": name})
    _REGISTRY[name] = spec
    return spec


def get_scenario(name: str, overrides: dict = None) -> ScenarioSpec:
    """Fetch a registered scenario, optionally applying dotted-path
    ``overrides`` (e.g. ``{"pool.pool_size": 6, "window": 16}``)."""
    try:
        spec = _REGISTRY[name]
    except KeyError:
        known = ", ".join(sorted(_REGISTRY)) or "<empty>"
        raise KeyError(f"unknown scenario {name!r}; registered: {known}") \
            from None
    return override(spec, overrides) if overrides else spec


def list_scenarios() -> list:
    """Sorted registered scenario names."""
    return sorted(_REGISTRY)


def register_grid(name: str, grid: GridSpec, *,
                  overwrite: bool = False) -> GridSpec:
    """Register a :class:`GridSpec` under ``name`` (same replacement rule
    as :func:`register_scenario` — committed GRID artifacts reference
    these names)."""
    if not name:
        raise ValueError("register_grid: name must be non-empty")
    if name in _GRIDS and not overwrite:
        raise ValueError(f"grid {name!r} is already registered "
                         "(pass overwrite=True to replace it)")
    if not isinstance(grid, GridSpec):
        raise TypeError("register_grid: grid must be a GridSpec, got "
                        f"{type(grid).__name__}")
    if grid.name != name:
        grid = dataclasses.replace(grid, name=name)
    _GRIDS[name] = grid
    return grid


def get_grid(name: str) -> GridSpec:
    """Fetch a registered grid by name."""
    try:
        return _GRIDS[name]
    except KeyError:
        known = ", ".join(sorted(_GRIDS)) or "<empty>"
        raise KeyError(f"unknown grid {name!r}; registered: {known}") \
            from None


def list_grids() -> list:
    """Sorted registered grid names."""
    return sorted(_GRIDS)


# ---------------------------------------------------------------------------
# seeded canonical workloads (the bench configs, named)
# ---------------------------------------------------------------------------

def _seed():
    # -- closed-world batch workloads (events + simfast engines) ----------
    register_scenario("smallR1", ScenarioSpec(
        n_tasks=40,
        pool=PoolSpec(pool_size=10),
    ))
    register_scenario("throughput_v3_pm", ScenarioSpec(
        # throughput mode: the whole 400-task set submitted as one batch,
        # 3-vote QC, PM_l=150 maintenance — the regime where the event
        # loop's per-event queue scans go quadratic (bench_simfast headline)
        n_tasks=400, batch_size=400,
        pool=PoolSpec(pool_size=15),
        policy=PolicySpec(
            redundancy=RedundancySpec(votes=3),
            maintenance=MaintenanceSpec(pm_l=150.0),
        ),
        engine=EngineKnobs(max_batch_time=2e5),
    ))
    register_scenario("hybrid_small", ScenarioSpec(
        # the hybrid-learning acceptance workload (bench_hybrid
        # vec-vs-scalar): one 10-worker pool labeling learner-selected
        # batches; run through facade.run_learning
        pool=PoolSpec(pool_size=10),
    ))

    # -- open-world streaming workloads (stream engine) -------------------
    _stream_dims = dict(
        window=32,
        pool=PoolSpec(pool_size=8, n_shards=2),
        arrivals=ArrivalSpec(kind="poisson", rate=0.01),
        engine=EngineKnobs(dt=5.0, tis_bin_s=16.0),
    )
    register_scenario("stream_default", ScenarioSpec(
        **_stream_dims,
        policy=PolicySpec(
            maintenance=MaintenanceSpec(pm_l=240.0),
            redundancy=RedundancySpec(adaptive=True, votes=3,
                                      conf_threshold=0.95, min_votes=1,
                                      max_outstanding=1),
        ),
    ))
    register_scenario("stream_batch_replay", ScenarioSpec(
        # the naive fixed-batch baseline: same machinery, admission gated
        # until the window drains, no straggler mitigation, fixed 3 votes
        **_stream_dims,
        policy=PolicySpec(
            straggler=StragglerSpec(enabled=False),
            redundancy=RedundancySpec(votes=3),
            admission=AdmissionSpec(batch_replay=True),
        ),
    ))

    _skew = DifficultySpec(p_hard=0.25, hard_scale=0.3)
    _adapt5 = RedundancySpec(adaptive=True, votes=5, conf_threshold=0.98,
                             min_votes=2, max_outstanding=2)
    register_scenario("skewed_fixed5", ScenarioSpec(
        **_stream_dims, difficulty=_skew,
        policy=PolicySpec(
            maintenance=MaintenanceSpec(pm_l=240.0),
            redundancy=RedundancySpec(votes=5),
        ),
    ))
    register_scenario("skewed_adaptive5", ScenarioSpec(
        **_stream_dims, difficulty=_skew,
        policy=PolicySpec(
            maintenance=MaintenanceSpec(pm_l=240.0),
            redundancy=_adapt5,
        ),
    ))
    register_scenario("skewed_learner_fused", ScenarioSpec(
        **_stream_dims, difficulty=_skew,
        policy=PolicySpec(
            maintenance=MaintenanceSpec(pm_l=240.0),
            redundancy=_adapt5,
            learner=LearnerSpec(enabled=True, min_votes_known=1),
        ),
    ))

    # the canonical heterogeneous-pool workload (wide Beta(2, 1) accuracy
    # spread, weak estimation prior, hour sessions, drip redundancy) —
    # previously labelstream.heterogeneous_stream_config
    _het = dict(
        window=16,
        pool=PoolSpec(pool_size=8, n_shards=2, acc_a=2.0, acc_b=1.0,
                      est_prior_n=2.0, session_mean_s=3600.0),
        arrivals=ArrivalSpec(kind="poisson", rate=0.012),
        engine=EngineKnobs(dt=5.0, tis_bin_s=8.0),
    )
    _drip = RedundancySpec(adaptive=True, votes=5, conf_threshold=0.95,
                           min_votes=1, max_outstanding=1)
    register_scenario("heterogeneous_pool", ScenarioSpec(
        **_het, policy=PolicySpec(redundancy=_drip),
    ))
    register_scenario("heterogeneous_routed", ScenarioSpec(
        **_het, policy=PolicySpec(redundancy=_drip,
                                  routing=RoutingSpec(kind="scored")),
    ))

    # bursty congestion where the backlog actually queues: the admission-
    # discipline comparison workload (learnable tasks)
    _burst = dict(
        window=8,
        pool=_het["pool"],
        arrivals=ArrivalSpec(kind="mmpp", rate=0.01, rate_hi=0.12,
                             dwell_mean_s=900.0),
        engine=EngineKnobs(dt=5.0, tis_bin_s=8.0),
        features=FeatureSpec(class_sep=1.2),
    )
    _burst_learner = LearnerSpec(enabled=True, min_votes_known=0)
    register_scenario("bursty_admission", ScenarioSpec(
        **_burst,
        policy=PolicySpec(redundancy=_drip, routing=RoutingSpec(kind="scored"),
                          learner=_burst_learner),
    ))
    register_scenario("bursty_admission_uncertain", ScenarioSpec(
        **_burst,
        policy=PolicySpec(redundancy=_drip, routing=RoutingSpec(kind="scored"),
                          learner=_burst_learner,
                          admission=AdmissionSpec(kind="uncertain")),
    ))

    # chance-level hard tasks (hard_scale=0: the crowd is pure noise on
    # them) with difficulty VISIBLE in feature space (hard_sep_scale):
    # the workload where plain uncertainty admission chases noise and the
    # difficulty-aware uncertainty x learnability score (AdmissionSpec(
    # kind="uncertain_learnable")) should not. Variants via override on
    # policy.admission.
    register_scenario("chance_hard", ScenarioSpec(
        window=8,
        pool=_het["pool"],
        arrivals=ArrivalSpec(kind="mmpp", rate=0.01, rate_hi=0.12,
                             dwell_mean_s=900.0),
        engine=EngineKnobs(dt=5.0, tis_bin_s=8.0),
        difficulty=DifficultySpec(p_hard=0.35, hard_scale=0.0),
        # wide separation on easy tasks + strongly shrunk separation on
        # hard ones: difficulty is visible in feature space (a linear
        # head over [x, x^2] separates the two ~0.9), which is what the
        # learnability-aware admission score needs to stop re-admitting
        # tasks the crowd can never resolve
        features=FeatureSpec(class_sep=3.0, hard_sep_scale=0.1),
        policy=PolicySpec(redundancy=_drip, routing=RoutingSpec(kind="scored"),
                          learner=LearnerSpec(enabled=True,
                                              min_votes_known=1)),
    ))

    # the live-serving workload (repro_torch.serving.server): a
    # FAST high-accuracy crowd (6 s median worker latency, 2 s ticks) so
    # submissions finalize within a handful of ticks — the regime where
    # wall-clock answer latency is dominated by the serving loop itself,
    # which is what the SLO bench must measure. The arrival process is
    # nominal only: serve mode injects real submissions instead.
    register_scenario("serve_default", ScenarioSpec(
        window=32,
        pool=PoolSpec(pool_size=16, n_shards=2, median_mu=6.0,
                      sigma_ln=0.6, latency_floor=0.5,
                      session_mean_s=3600.0),
        arrivals=ArrivalSpec(kind="poisson", rate=0.5),
        engine=EngineKnobs(dt=2.0, tis_bin_s=4.0),
        policy=PolicySpec(
            redundancy=RedundancySpec(adaptive=True, votes=3,
                                      conf_threshold=0.9, min_votes=1,
                                      max_outstanding=2),
        ),
        serve=ServeSpec(tick_interval_s=0.0),
    ))

    # the device-scaling workload: 8 pool shards so the shard groups
    # divide evenly across 1/2/4/8 devices, cross-shard pressure stealing
    # on. Defaults to n_devices=1 (single-device hosts run it unsharded
    # and bit-identically); the bench scaling section overrides
    # ``sharding.n_devices`` per probe point.
    register_scenario("stream_sharded", ScenarioSpec(
        window=16,
        pool=PoolSpec(pool_size=16, n_shards=8),
        arrivals=ArrivalSpec(kind="poisson", rate=0.04),
        engine=EngineKnobs(dt=5.0, tis_bin_s=16.0),
        policy=PolicySpec(
            maintenance=MaintenanceSpec(pm_l=240.0),
            redundancy=RedundancySpec(adaptive=True, votes=3,
                                      conf_threshold=0.95, min_votes=1,
                                      max_outstanding=1),
        ),
        sharding=ShardingSpec(n_devices=1, steal="pressure",
                              steal_max=4, steal_slack=1),
    ))

    # LM-embedding task features (repro_torch.embed): the streaming workloads
    # where the learner consumes real model representations of synthetic
    # text tasks instead of Gaussian draws. A tiny reduced encoder +
    # 64-entry bank keeps these runnable in the registry smoke (the bank
    # builds once per config and is reused across every run/sweep/grid).
    _lm_embed = EmbedSpec(seq_len=16, bank_size=64, batch_size=32)
    register_scenario("lm_stream", ScenarioSpec(
        window=8,
        pool=PoolSpec(pool_size=8, n_shards=2),
        arrivals=ArrivalSpec(kind="poisson", rate=0.01),
        engine=EngineKnobs(dt=5.0, tis_bin_s=16.0),
        features=FeatureSpec(kind="lm", n_features=8, class_sep=3.0),
        embed=_lm_embed,
        policy=PolicySpec(
            redundancy=RedundancySpec(adaptive=True, votes=3,
                                      conf_threshold=0.95, min_votes=1,
                                      max_outstanding=1),
            learner=LearnerSpec(enabled=True, min_votes_known=1),
        ),
    ))
    # chance_hard with LM features: same crowd/difficulty workload as
    # chance_hard (chance-level hard tasks, mmpp bursts), but difficulty
    # lives in EMBEDDING space — hard tasks' class-signal token rate is
    # shrunk, so their embeddings collapse toward the background-text
    # manifold and the learnability head must find that structure in real
    # representations (the bench_embed recovery comparison row)
    register_scenario("lm_chance_hard", ScenarioSpec(
        window=8,
        pool=_het["pool"],
        arrivals=ArrivalSpec(kind="mmpp", rate=0.01, rate_hi=0.12,
                             dwell_mean_s=900.0),
        engine=EngineKnobs(dt=5.0, tis_bin_s=8.0),
        difficulty=DifficultySpec(p_hard=0.35, hard_scale=0.0),
        features=FeatureSpec(kind="lm", n_features=8, class_sep=3.0,
                             hard_sep_scale=0.1),
        embed=_lm_embed,
        policy=PolicySpec(redundancy=_drip, routing=RoutingSpec(kind="scored"),
                          learner=LearnerSpec(enabled=True,
                                              min_votes_known=1)),
    ))


def _seed_grids():
    # the paper-table grid: mitigation on/off x redundancy x offered load
    # over the canonical streaming workload. The two straggler settings
    # are static configs (2 compilations); redundancy and rate are traced,
    # so all 24 cells run as 2 compiled batches.
    register_grid("paper_stream", GridSpec(
        base=get_scenario("stream_default"),
        axes=(
            ("policy.straggler.enabled", (False, True)),
            ("policy.redundancy.votes", (1, 3, 5)),
            ("arrivals.rate", (0.006, 0.009, 0.012, 0.015)),
        ),
    ))
    # batch-engine counterpart: mitigation x worker speed x accuracy skew
    # (the pool axes ride the simfast PopTraced bundle -> 2 compilations)
    register_grid("paper_fast", GridSpec(
        base=get_scenario("smallR1"),
        axes=(
            ("policy.straggler.enabled", (False, True)),
            ("pool.median_mu", (30.0, 60.0, 90.0)),
            ("pool.acc_a", (5.0, 8.0, 11.0)),
        ),
    ))
    # CI smoke grids: one class each, small enough for a laptop/CI leg
    register_grid("grid_smoke_stream", GridSpec(
        base=get_scenario("stream_default"),
        axes=(
            ("arrivals.rate", (0.008, 0.012)),
            ("policy.redundancy.votes", (1, 2, 3)),
        ),
    ))
    register_grid("grid_smoke_simfast", GridSpec(
        base=get_scenario("smallR1"),
        axes=(
            ("pool.median_mu", (30.0, 60.0)),
            ("pool.acc_a", (5.0, 8.0, 11.0)),
        ),
    ))




_seed()
_seed_grids()


# ---------------------------------------------------------------------------
# name-keyed helpers over the registry
# ---------------------------------------------------------------------------

def list_stream_configs() -> list:
    """Sorted names of the simulator stream workloads the port runs: every
    registered scenario of the stream engine but those with LM task features
    (ROADMAP A12b) and the live-serving ones, which carry a serve sub-spec
    of their own and whose arrival process is nominal (they run through
    ``serve_tick``)."""
    return [n for n in list_scenarios()
            if "stream" in engines(spec := _REGISTRY[n])
            and spec.features.kind == "gaussian"
            and spec.serve == ServeSpec()]


def get_stream_config(name: str, overrides: dict = None):
    """The named workload's ``StreamConfig`` (``to_stream_config`` of its
    registry scenario) with top-level config-field ``overrides`` applied
    (e.g. ``{"refresh_every": 40}``)."""
    if name not in list_stream_configs():
        raise KeyError(f"unknown stream workload {name!r}; ported: "
                       f"{', '.join(list_stream_configs())}")
    cfg = to_stream_config(get_scenario(name))
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def list_fast_configs() -> list:
    """Sorted names of the batch-engine workloads."""
    return [n for n in list_scenarios()
            if "simfast" in engines(_REGISTRY[n])]


def get_fast_config(name: str, overrides: dict = None):
    """The named workload's ``FastConfig`` (``to_fast_config`` of its
    registry scenario) with top-level config-field ``overrides`` applied."""
    if name not in list_fast_configs():
        raise KeyError(f"unknown batch workload {name!r}; ported: "
                       f"{', '.join(list_fast_configs())}")
    cfg = to_fast_config(get_scenario(name))
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


def learning_spec(spec: ScenarioSpec) -> LearningSpec:
    """The :class:`LearningSpec` of a scenario."""
    f, lr = spec.features, spec.policy.learner
    return LearningSpec(
        n_features=f.n_features, class_sep=f.class_sep,
        n_classes=spec.n_classes, kind=lr.kind, al_fraction=lr.al_fraction,
        decision_latency_s=lr.decision_latency_s, feature_kind=f.kind,
        hard_sep_scale=f.hard_sep_scale, p_hard=spec.difficulty.p_hard,
        embed=to_embed_config(spec))


# the reference's dotted override keys that get_learning_spec takes, and
# the LearningSpec field each one sets ("embed.<field>" sets that
# EmbedConfig field)
_OVERRIDE_FIELDS = {
    "features.kind": "feature_kind",
    "features.n_features": "n_features",
    "features.class_sep": "class_sep",
    "features.hard_sep_scale": "hard_sep_scale",
    "difficulty.p_hard": "p_hard",
}


def get_learning_spec(name: str, overrides: dict = None) -> LearningSpec:
    """The named batch workload's :class:`LearningSpec`, with the
    reference's dotted ``overrides`` applied (``"features.kind"``,
    ``"embed.model"``, ``"embed.reduced"``, ``"embed.seq_len"``, ... ; see
    ``_OVERRIDE_FIELDS``); an unknown key raises ``KeyError``."""
    get_fast_config(name)
    spec = learning_spec(get_scenario(name))
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
