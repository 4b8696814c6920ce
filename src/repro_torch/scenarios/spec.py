"""Declarative scenario/policy specs: the one vocabulary over the engines
(copy of ``src/repro/scenarios/spec.py``).

  * :class:`ScenarioSpec` describes the WORKLOAD: how many tasks and how
    they arrive (:class:`ArrivalSpec`), how hard they are and what the
    learner can observe about them (:class:`DifficultySpec`,
    :class:`FeatureSpec`), and who labels them (:class:`PoolSpec`).
  * :class:`PolicySpec` describes the SYSTEM'S RESPONSE: straggler
    mitigation, pool maintenance, redundancy, worker-aware routing, backlog
    admission and hybrid-learner fusion.

Every spec is a frozen dataclass, validated field by field at construction
(``ValueError`` messages name the offending field, word for word as the
reference's), hashable and comparable. The reference also registers each
spec as a static jax pytree node; the port has no pytrees and drops that.

:mod:`repro_torch.scenarios.compile` lowers specs to the port's engine
configs, :mod:`repro_torch.scenarios.facade` runs them, and
:mod:`repro_torch.scenarios.registry` names the canonical workloads.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional


_ARRIVAL_KINDS = ("batch", "poisson", "mmpp", "diurnal")
_FEATURE_KINDS = ("gaussian", "lm")
_POOLING_KINDS = ("mean", "last")
_ADMISSION_KINDS = ("fifo", "uncertain", "uncertain_learnable")
_ROUTING_KINDS = ("uniform", "scored")
_LEARNER_KINDS = ("AL", "PL", "HL", "NL")
_STEAL_KINDS = ("none", "pressure")


def _fail(cls, field: str, msg: str):
    raise ValueError(f"{cls.__name__}.{field}: {msg}")


def _check(cls, cond: bool, field: str, msg: str):
    if not cond:
        _fail(cls, field, msg)


@dataclasses.dataclass(frozen=True)
class ArrivalSpec:
    """How tasks enter the system.

    ``kind="batch"`` is the closed-world workload (a finite task set
    submitted up front — the events/simfast engines); the other kinds are
    open-world arrival processes (the stream engine): homogeneous Poisson,
    2-state Markov-modulated Poisson (bursty), or sinusoidal diurnal.
    """
    kind: str = "batch"
    rate: float = 0.05            # tasks/s (poisson; mmpp calm; diurnal mean)
    rate_hi: float = 0.2          # mmpp burst-state rate
    dwell_mean_s: float = 600.0   # mmpp mean dwell per state
    period_s: float = 86400.0     # diurnal period
    amplitude: float = 0.8        # diurnal modulation depth in [0, 1)

    def __post_init__(self):
        c = ArrivalSpec
        _check(c, self.kind in _ARRIVAL_KINDS, "kind",
               f"must be one of {_ARRIVAL_KINDS}, got {self.kind!r}")
        _check(c, self.rate > 0, "rate", f"must be > 0, got {self.rate}")
        _check(c, self.rate_hi > 0, "rate_hi",
               f"must be > 0, got {self.rate_hi}")
        _check(c, self.dwell_mean_s > 0, "dwell_mean_s",
               f"must be > 0, got {self.dwell_mean_s}")
        _check(c, self.period_s > 0, "period_s",
               f"must be > 0, got {self.period_s}")
        _check(c, 0.0 <= self.amplitude < 1.0, "amplitude",
               f"must be in [0, 1), got {self.amplitude}")


@dataclasses.dataclass(frozen=True)
class DifficultySpec:
    """Task-difficulty mixture: a ``p_hard`` fraction of tasks scale worker
    accuracy toward chance (``p_correct = 1/C + (acc - 1/C) * hard_scale``;
    ``hard_scale=0`` makes hard tasks exactly chance-level)."""
    p_hard: float = 0.0
    hard_scale: float = 0.35

    def __post_init__(self):
        c = DifficultySpec
        _check(c, 0.0 <= self.p_hard <= 1.0, "p_hard",
               f"must be in [0, 1], got {self.p_hard}")
        _check(c, 0.0 <= self.hard_scale <= 1.0, "hard_scale",
               f"must be in [0, 1], got {self.hard_scale}")


@dataclasses.dataclass(frozen=True)
class FeatureSpec:
    """The observable side of a task — the feature vector the hybrid
    learner generalizes over. ``kind="gaussian"`` draws class-conditional
    Gaussians in the tick (the historical path); ``kind="lm"`` gathers
    precomputed LM embeddings of synthetic text tasks from the
    device-resident ``repro_torch.embed`` bank (configured by the scenario's
    :class:`EmbedSpec`). Either way ``hard_sep_scale < 1`` makes hard
    tasks hard for the MODEL too (Gaussian: class separation shrinks by
    that factor; lm: the text's class-signal token rate shrinks), which
    is what lets difficulty-aware admission learn to avoid chance-level
    tasks from features alone."""
    n_features: int = 8
    class_sep: float = 1.8
    hard_sep_scale: float = 1.0
    kind: str = "gaussian"

    def __post_init__(self):
        c = FeatureSpec
        _check(c, self.kind in _FEATURE_KINDS, "kind",
               f"must be one of {_FEATURE_KINDS}, got {self.kind!r}")
        _check(c, self.n_features >= 1, "n_features",
               f"must be >= 1, got {self.n_features}")
        _check(c, self.class_sep > 0, "class_sep",
               f"must be > 0, got {self.class_sep}")
        _check(c, 0.0 < self.hard_sep_scale <= 1.0, "hard_sep_scale",
               f"must be in (0, 1], got {self.hard_sep_scale}")


@dataclasses.dataclass(frozen=True)
class EmbedSpec:
    """LM-embedding configuration for ``FeatureSpec(kind="lm")`` — the
    declarative twin of :class:`repro_torch.embed.config.EmbedConfig`.

    ``model`` names a ``repro_torch.configs`` architecture (``reduced=True``
    runs it at smoke scale); ``pooling`` collapses hidden states to one
    vector per task; ``bank_size`` embeddings are precomputed into the
    device-resident bank the jitted ticks gather from (layout
    ``2 x n_classes x variants``, so it must be a multiple of
    ``2 * n_classes`` — validated on the ScenarioSpec where n_classes is
    known); ``projection_dim`` optionally pins the random-projection
    target, which must equal ``FeatureSpec.n_features``."""
    model: str = "xlstm-125m"
    reduced: bool = True
    pooling: str = "mean"
    seq_len: int = 48
    bank_size: int = 512
    projection_dim: Optional[int] = None
    batch_size: int = 64
    seed: int = 0

    def __post_init__(self):
        c = EmbedSpec
        _check(c, self.pooling in _POOLING_KINDS, "pooling",
               f"must be one of {_POOLING_KINDS}, got {self.pooling!r}")
        _check(c, self.seq_len >= 4, "seq_len",
               f"must be >= 4, got {self.seq_len}")
        _check(c, self.bank_size >= 2, "bank_size",
               f"must be >= 2, got {self.bank_size}")
        _check(c, self.projection_dim is None or self.projection_dim >= 1,
               "projection_dim",
               f"must be None or >= 1, got {self.projection_dim}")
        _check(c, self.batch_size >= 1, "batch_size",
               f"must be >= 1, got {self.batch_size}")


@dataclasses.dataclass(frozen=True)
class PoolSpec:
    """Worker-pool size, heterogeneity, and churn (workers.Population
    distributions + retainer-pool recruitment semantics)."""
    pool_size: int = 15
    n_shards: int = 1             # stream engine: independent pool shards
    retainer: bool = True         # False = Base-NR cold recruitment
    recruit_mean_s: float = 45.0
    cold_recruit_mean_s: float = 200.0
    session_mean_s: float = 1800.0
    median_mu: float = 150.0      # median worker latency (lognormal)
    sigma_ln: float = 1.0
    cv_lo: float = 0.3
    cv_hi: float = 1.2
    acc_a: float = 18.0           # worker-accuracy Beta(acc_a, acc_b)
    acc_b: float = 2.0
    latency_floor: float = 2.0
    bank: Optional[int] = None    # pre-drawn replacement workers per slot
                                  # (None = engine default: 16 batch /
                                  # 64 stream)
    est_prior_acc: float = 0.85   # stream online-accuracy Beta prior
    est_prior_n: float = 8.0

    def __post_init__(self):
        c = PoolSpec
        _check(c, self.pool_size >= 1, "pool_size",
               f"must be >= 1, got {self.pool_size}")
        _check(c, self.n_shards >= 1, "n_shards",
               f"must be >= 1, got {self.n_shards}")
        for f in ("recruit_mean_s", "cold_recruit_mean_s", "session_mean_s",
                  "median_mu", "sigma_ln", "acc_a", "acc_b"):
            _check(c, getattr(self, f) > 0, f,
                   f"must be > 0, got {getattr(self, f)}")
        _check(c, 0.0 < self.cv_lo <= self.cv_hi, "cv_lo",
               f"need 0 < cv_lo <= cv_hi, got cv_lo={self.cv_lo} "
               f"cv_hi={self.cv_hi}")
        _check(c, self.latency_floor >= 0, "latency_floor",
               f"must be >= 0, got {self.latency_floor}")
        _check(c, self.bank is None or self.bank >= 1, "bank",
               f"must be None or >= 1, got {self.bank}")
        _check(c, 0.0 < self.est_prior_acc < 1.0, "est_prior_acc",
               f"must be in (0, 1), got {self.est_prior_acc}")
        _check(c, self.est_prior_n > 0, "est_prior_n",
               f"must be > 0, got {self.est_prior_n}")


@dataclasses.dataclass(frozen=True)
class ShardingSpec:
    """Device topology for the stream engine.

    The pool's ``n_shards`` shards are split into equal per-device groups
    and the whole tick runs under ``shard_map`` over a 1-D ``("shard",)``
    mesh in the reference, over the device groups of a
    ``repro_torch.launch.mesh.StreamMesh`` in the port (one controller, D
    devices; a card may hold several groups).  ``steal="pressure"`` turns on
    cross-shard work stealing: each tick the shards exchange fixed-shape
    backlog-pressure summaries (all-gather), shards more than
    ``steal_slack`` tasks above the global mean donate up to ``steal_max``
    of their oldest backlog entries, and starved shards claim them in
    deterministic shard order.  The default spec (one device, no stealing)
    is bit-identical to the unsharded tick.
    """
    n_devices: int = 1
    shards_per_device: Optional[int] = None   # None = n_shards // n_devices
    steal: str = "none"           # "none" | "pressure"
    steal_max: int = 4            # max tasks a donor shard exports per tick
    steal_slack: int = 2          # backlog excess over global mean to donate

    def __post_init__(self):
        c = ShardingSpec
        _check(c, self.n_devices >= 1, "n_devices",
               f"must be >= 1, got {self.n_devices}")
        _check(c, self.shards_per_device is None
               or self.shards_per_device >= 1, "shards_per_device",
               f"must be None or >= 1, got {self.shards_per_device}")
        _check(c, self.steal in _STEAL_KINDS, "steal",
               f"must be one of {_STEAL_KINDS}, got {self.steal!r}")
        _check(c, self.steal_max >= 1, "steal_max",
               f"must be >= 1, got {self.steal_max}")
        _check(c, self.steal_slack >= 0, "steal_slack",
               f"must be >= 0, got {self.steal_slack}")


@dataclasses.dataclass(frozen=True)
class TraceSpec:
    """In-loop observability, lowered to the engines' ``TraceConfig``
    (:mod:`repro_torch.obs.trace`). Disabled (the default) runs the
    untraced program on every engine; enabled, the trace buffers record
    only deterministic functions of existing state and draw nothing, so
    all shared outputs stay bit-identical either way
    (``tests/test_torch_trace.py``).

    ``phases``   — per-phase latency decomposition of time-in-system
    (backlog wait, window wait, work time, finalize lag);
    ``per_tick`` — per-tick/-batch activity series (votes, pool
    occupancy, drops, steals, admission scores).
    """
    enabled: bool = False
    phases: bool = True
    per_tick: bool = True

    def __post_init__(self):
        _check(TraceSpec, not self.enabled or self.phases or self.per_tick,
               "enabled",
               "= True needs at least one of phases/per_tick on")


@dataclasses.dataclass(frozen=True)
class ServeSpec:
    """Live serving front end (``repro_torch.serving.server``): the stream tick
    driven by real HTTP submissions instead of the sampled arrival
    process. Submissions are micro-batched into per-shard injected
    arrival counts each tick; router state stays device-resident with
    donated buffers between ticks and queries are answered from the
    finalized-label stream with wall-clock timestamps.

    ``tick_interval_s``    — minimum wall seconds between ticks while work
    is in flight (0 runs ticks back-to-back, the bench setting);
    ``max_pending``        — host-side admission queue bound: submissions
    beyond it are rejected with 429 instead of buffering unboundedly;
    ``request_timeout_s``  — default cap on a blocking ``wait=true``
    submission/query (the TASK stays in the system; only the HTTP wait
    times out);
    ``drain_timeout_s``    — graceful-shutdown budget to finish in-flight
    tasks before outstanding requests are resolved as ``"shutdown"``.
    """
    host: str = "127.0.0.1"
    port: int = 0                 # 0 = ephemeral (picked by the OS)
    tick_interval_s: float = 0.01
    max_pending: int = 4096
    request_timeout_s: float = 30.0
    drain_timeout_s: float = 10.0

    def __post_init__(self):
        c = ServeSpec
        _check(c, 0 <= self.port <= 65535, "port",
               f"must be in [0, 65535], got {self.port}")
        _check(c, self.tick_interval_s >= 0, "tick_interval_s",
               f"must be >= 0, got {self.tick_interval_s}")
        _check(c, self.max_pending >= 1, "max_pending",
               f"must be >= 1, got {self.max_pending}")
        _check(c, self.request_timeout_s > 0, "request_timeout_s",
               f"must be > 0, got {self.request_timeout_s}")
        _check(c, self.drain_timeout_s >= 0, "drain_timeout_s",
               f"must be >= 0, got {self.drain_timeout_s}")


@dataclasses.dataclass(frozen=True)
class EngineKnobs:
    """Discretization/measurement knobs that belong to the simulation, not
    the workload. ``dt=None`` uses the engine default (2 s batch tick /
    5 s stream tick)."""
    dt: Optional[float] = None
    bundle_s: float = 64.0        # simfast event-bundling window
    mitig_bundle_s: float = 12.0
    max_batch_time: float = 3600.0
    max_arrivals_per_tick: int = 64
    tis_bins: int = 512           # stream time-in-system histogram
    tis_bin_s: float = 4.0

    def __post_init__(self):
        c = EngineKnobs
        _check(c, self.dt is None or self.dt > 0, "dt",
               f"must be None or > 0, got {self.dt}")
        for f in ("bundle_s", "mitig_bundle_s", "max_batch_time", "tis_bin_s"):
            _check(c, getattr(self, f) > 0, f,
                   f"must be > 0, got {getattr(self, f)}")
        _check(c, self.max_arrivals_per_tick >= 1, "max_arrivals_per_tick",
               f"must be >= 1, got {self.max_arrivals_per_tick}")
        _check(c, self.tis_bins >= 2, "tis_bins",
               f"must be >= 2, got {self.tis_bins}")


# ---------------------------------------------------------------------------
# policy side
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StragglerSpec:
    """Straggler mitigation (paper §4): duplicate active tasks onto free
    workers, first completion wins."""
    enabled: bool = True
    max_dup: int = 2

    def __post_init__(self):
        _check(StragglerSpec, self.max_dup >= 0, "max_dup",
               f"must be >= 0, got {self.max_dup}")


@dataclasses.dataclass(frozen=True)
class MaintenanceSpec:
    """Pool maintenance (paper §4.2): evict workers whose TermEst-corrected
    latency estimate significantly exceeds ``pm_l`` (inf = off)."""
    pm_l: float = float("inf")
    use_termest: bool = True
    min_obs: int = 3
    z: float = 1.0
    alpha: float = 1.0

    def __post_init__(self):
        c = MaintenanceSpec
        _check(c, self.pm_l > 0, "pm_l", f"must be > 0, got {self.pm_l}")
        _check(c, self.min_obs >= 1, "min_obs",
               f"must be >= 1, got {self.min_obs}")
        _check(c, self.z >= 0, "z", f"must be >= 0, got {self.z}")
        _check(c, self.alpha > 0, "alpha",
               f"must be > 0, got {self.alpha}")


@dataclasses.dataclass(frozen=True)
class RedundancySpec:
    """Vote redundancy / QC. ``adaptive=False`` spends exactly ``votes``
    votes per task (the batch engines' fixed ``votes_needed``);
    ``adaptive=True`` drips ``max_outstanding`` at a time and finalizes
    early once the posterior clears ``conf_threshold`` (stream engine)."""
    adaptive: bool = False
    votes: int = 1                # fixed votes_needed == adaptive votes_cap
    conf_threshold: float = 0.92
    min_votes: int = 1
    max_outstanding: int = 1

    def __post_init__(self):
        c = RedundancySpec
        _check(c, self.votes >= 1, "votes", f"must be >= 1, got {self.votes}")
        _check(c, 0.5 < self.conf_threshold <= 1.0, "conf_threshold",
               f"must be in (0.5, 1], got {self.conf_threshold}")
        _check(c, 1 <= self.min_votes <= self.votes, "min_votes",
               f"need 1 <= min_votes <= votes, got min_votes="
               f"{self.min_votes} votes={self.votes}")
        _check(c, self.max_outstanding >= 1, "max_outstanding",
               f"must be >= 1, got {self.max_outstanding}")


@dataclasses.dataclass(frozen=True)
class RoutingSpec:
    """Worker->task matching. ``uniform`` is the two-tier rank match
    (``priority_match``); ``scored`` is FROG-style worker-aware matching
    (accuracy to uncertain tasks, speed to easy ones)."""
    kind: str = "uniform"
    w_acc: float = 3.0
    w_speed: float = 0.5
    ewma_alpha: float = 0.25

    def __post_init__(self):
        c = RoutingSpec
        _check(c, self.kind in _ROUTING_KINDS, "kind",
               f"must be one of {_ROUTING_KINDS}, got {self.kind!r}")
        _check(c, self.w_acc >= 0, "w_acc",
               f"must be >= 0, got {self.w_acc}")
        _check(c, self.w_speed >= 0, "w_speed",
               f"must be >= 0, got {self.w_speed}")
        _check(c, 0.0 < self.ewma_alpha <= 1.0, "ewma_alpha",
               f"must be in (0, 1], got {self.ewma_alpha}")


@dataclasses.dataclass(frozen=True)
class AdmissionSpec:
    """Backlog admission discipline. ``fifo`` is the arrival-order ring;
    ``uncertain`` admits most-uncertain-first under the online model;
    ``uncertain_learnable`` weights uncertainty by a learned learnability
    estimate so chance-level-hard tasks stop hogging the window.
    ``batch_replay`` gates admission until the window drains (the naive
    fixed-batch baseline)."""
    kind: str = "fifo"
    batch_replay: bool = False

    def __post_init__(self):
        c = AdmissionSpec
        _check(c, self.kind in _ADMISSION_KINDS, "kind",
               f"must be one of {_ADMISSION_KINDS}, got {self.kind!r}")
        if self.batch_replay and self.kind != "fifo":
            _fail(c, "batch_replay",
                  "batch_replay (drain-then-refill baseline) requires "
                  f"kind='fifo', got kind={self.kind!r}")


@dataclasses.dataclass(frozen=True)
class LearnerSpec:
    """Hybrid-learning policy: the streaming fusion knobs (``enabled`` turns
    the online learner + product-of-experts fusion on in the stream engine)
    and the batch-learning driver knobs (``kind``/``al_fraction``/... for
    the events/simfast learning loops)."""
    # streaming fusion (StreamLearnerConfig semantics)
    enabled: bool = False
    prior_scale: float = 1.0
    ramp_n: float = 48.0
    known_threshold: float = 0.97
    min_votes_known: int = 1
    fit_every: int = 4
    fit_steps: int = 2
    lr: float = 0.05
    l2: float = 1e-3
    buffer: int = 256
    prioritize: bool = True
    train_crowd_only: bool = True
    refresh_every: int = 0        # offline full-confusion EM refresh cadence
    refresh_iters: int = 8
    # batch learning-loop drivers (events run_learning / simfast
    # simulate_learning)
    kind: str = "HL"
    al_fraction: float = 0.5
    al_batch: int = 10
    decision_latency_s: float = 15.0
    async_retrain: bool = True
    uncertainty_sample: int = 400

    def __post_init__(self):
        c = LearnerSpec
        _check(c, self.prior_scale >= 0, "prior_scale",
               f"must be >= 0, got {self.prior_scale}")
        _check(c, self.ramp_n > 0, "ramp_n",
               f"must be > 0, got {self.ramp_n}")
        _check(c, 0.5 < self.known_threshold <= 1.0, "known_threshold",
               f"must be in (0.5, 1], got {self.known_threshold}")
        _check(c, self.min_votes_known >= 0, "min_votes_known",
               f"must be >= 0, got {self.min_votes_known}")
        for f in ("fit_every", "fit_steps", "buffer"):
            _check(c, getattr(self, f) >= 1, f,
                   f"must be >= 1, got {getattr(self, f)}")
        _check(c, self.lr > 0, "lr", f"must be > 0, got {self.lr}")
        _check(c, self.l2 >= 0, "l2", f"must be >= 0, got {self.l2}")
        _check(c, self.refresh_every >= 0, "refresh_every",
               f"must be >= 0, got {self.refresh_every}")
        _check(c, self.refresh_iters >= 1, "refresh_iters",
               f"must be >= 1, got {self.refresh_iters}")
        _check(c, self.kind in _LEARNER_KINDS, "kind",
               f"must be one of {_LEARNER_KINDS}, got {self.kind!r}")
        _check(c, 0.0 <= self.al_fraction <= 1.0, "al_fraction",
               f"must be in [0, 1], got {self.al_fraction}")
        _check(c, self.al_batch >= 1, "al_batch",
               f"must be >= 1, got {self.al_batch}")
        _check(c, self.decision_latency_s >= 0, "decision_latency_s",
               f"must be >= 0, got {self.decision_latency_s}")
        _check(c, self.uncertainty_sample >= 1, "uncertainty_sample",
               f"must be >= 1, got {self.uncertainty_sample}")


@dataclasses.dataclass(frozen=True)
class PolicySpec:
    """The system's response to a workload: every CLAMShell latency/quality
    technique as one pluggable module each."""
    straggler: StragglerSpec = StragglerSpec()
    maintenance: MaintenanceSpec = MaintenanceSpec()
    redundancy: RedundancySpec = RedundancySpec()
    routing: RoutingSpec = RoutingSpec()
    admission: AdmissionSpec = AdmissionSpec()
    learner: LearnerSpec = LearnerSpec()

    def __post_init__(self):
        c = PolicySpec
        if self.admission.kind != "fifo" and not self.learner.enabled:
            _fail(c, "admission.kind",
                  f"admission.kind={self.admission.kind!r} ranks backlog "
                  "tasks under the online model and therefore requires "
                  "learner.enabled=True")


@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    """One declarative workload + the policy that serves it.

    Compiled to the engine configs by ``repro_torch.scenarios.compile`` and run
    through ``repro_torch.scenarios.run``; see ``repro_torch.scenarios.registry`` for
    the named canonical scenarios.
    """
    name: str = ""
    n_classes: int = 2
    # closed-world (batch) workload shape
    n_tasks: int = 60
    batch_ratio: float = 1.0      # R = pool/batch -> batch = pool/R
    batch_size: Optional[int] = None
    n_records: int = 1
    # open-world (stream) workload shape
    horizon: int = 1000           # stream ticks per run
    window: int = 32              # ring-buffer task slots per shard
    backlog: int = 1024
    # sub-specs
    arrivals: ArrivalSpec = ArrivalSpec()
    difficulty: DifficultySpec = DifficultySpec()
    features: FeatureSpec = FeatureSpec()
    pool: PoolSpec = PoolSpec()
    policy: PolicySpec = PolicySpec()
    engine: EngineKnobs = EngineKnobs()
    sharding: ShardingSpec = ShardingSpec()
    trace: TraceSpec = TraceSpec()
    serve: ServeSpec = ServeSpec()
    embed: EmbedSpec = EmbedSpec()

    def __post_init__(self):
        c = ScenarioSpec
        _check(c, self.n_classes >= 2, "n_classes",
               f"must be >= 2, got {self.n_classes}")
        _check(c, self.n_tasks >= 1, "n_tasks",
               f"must be >= 1, got {self.n_tasks}")
        _check(c, self.batch_ratio > 0, "batch_ratio",
               f"must be > 0, got {self.batch_ratio}")
        _check(c, self.batch_size is None or self.batch_size >= 1,
               "batch_size", f"must be None or >= 1, got {self.batch_size}")
        _check(c, self.n_records >= 1, "n_records",
               f"must be >= 1, got {self.n_records}")
        _check(c, self.horizon >= 1, "horizon",
               f"must be >= 1, got {self.horizon}")
        _check(c, self.window >= 1, "window",
               f"must be >= 1, got {self.window}")
        _check(c, self.backlog >= self.window, "backlog",
               f"must be >= window ({self.window}), got {self.backlog}")
        if self.policy.learner.enabled \
                and self.features.n_features < self.n_classes:
            _fail(c, "features.n_features",
                  f"must be >= n_classes ({self.n_classes}) for one-hot "
                  f"class means, got {self.features.n_features}")
        if self.policy.redundancy.adaptive \
                and not math.isfinite(self.policy.redundancy.votes):
            _fail(c, "policy.redundancy.votes",
                  "adaptive redundancy needs a finite votes cap")
        sh = self.sharding
        if self.pool.n_shards % sh.n_devices != 0:
            _fail(c, "sharding.n_devices",
                  f"ShardingSpec.n_devices={sh.n_devices} must divide "
                  f"PoolSpec.n_shards={self.pool.n_shards} (each device "
                  "holds an equal group of pool shards)")
        if sh.shards_per_device is not None \
                and sh.n_devices * sh.shards_per_device != self.pool.n_shards:
            _fail(c, "sharding.shards_per_device",
                  f"ShardingSpec.n_devices={sh.n_devices} x "
                  f"shards_per_device={sh.shards_per_device} != "
                  f"PoolSpec.n_shards={self.pool.n_shards}")
        if sh.steal != "none" and self.policy.admission.kind != "fifo":
            _fail(c, "sharding.steal",
                  f"steal={sh.steal!r} rebalances the FIFO backlog ring and "
                  "requires policy.admission.kind='fifo', got "
                  f"{self.policy.admission.kind!r}")
        if self.features.kind == "lm":
            em = self.embed
            if self.arrivals.kind != "batch" \
                    and not self.policy.learner.enabled:
                _fail(c, "features.kind",
                      "= 'lm' on a stream workload requires policy.learner."
                      "enabled=True — LM embeddings exist to feed the "
                      "learnability head; without it the features are dead "
                      "weight in the tick (batch workloads feed "
                      "run_learning's own learner instead)")
            if em.projection_dim is not None \
                    and em.projection_dim != self.features.n_features:
                _fail(c, "embed.projection_dim",
                      f"= {em.projection_dim} must equal "
                      f"features.n_features={self.features.n_features} "
                      "(the projection target IS the learner feature "
                      "width; set projection_dim=None to infer it)")
            if em.bank_size % (2 * self.n_classes) != 0:
                _fail(c, "embed.bank_size",
                      f"= {em.bank_size} must be a positive multiple of "
                      f"2 * n_classes = {2 * self.n_classes} (the bank is "
                      "laid out easy/hard x class x variant)")
            if em.bank_size < self.pool.n_shards * self.window:
                _fail(c, "embed.bank_size",
                      f"= {em.bank_size} is smaller than n_shards x window "
                      f"= {self.pool.n_shards * self.window}; a bank that "
                      "cannot cover one full window of in-flight tasks "
                      "aliases variants pathologically — raise bank_size")


# ---------------------------------------------------------------------------
# grids
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GridSpec:
    """A Scenario x Policy grid: one base scenario plus dotted-path axes
    whose cross product defines the cells — the declarative form of a
    paper table (straggler x maintenance x redundancy x ...).

    ``axes`` is a tuple of ``(path, values)`` pairs where ``path`` is a
    dotted :func:`override` path into ``base`` and ``values`` a non-empty
    value tuple. Cells enumerate row-major with the LAST axis fastest
    (``itertools.product`` order). Axis paths are resolved against the
    base at construction; per-cell value validation happens in
    :meth:`cells` where axis combinations are applied jointly (a value
    can be valid only in combination, e.g. votes and min_votes swept
    together).

    The reference's ``repro.grid.run_grid`` executes grids; the port's is
    ROADMAP A10.
    """
    base: ScenarioSpec = ScenarioSpec()
    axes: tuple = ()
    name: str = ""

    def __post_init__(self):
        c = GridSpec
        _check(c, isinstance(self.base, ScenarioSpec), "base",
               f"must be a ScenarioSpec, got {type(self.base).__name__}")
        try:
            axes = tuple((str(p), tuple(vs)) for p, vs in self.axes)
        except (TypeError, ValueError):
            _fail(c, "axes", "must be ((path, (values...)), ...) pairs, "
                  f"got {self.axes!r}")
        object.__setattr__(self, "axes", axes)
        seen = set()
        for p, vs in axes:
            _check(c, p not in seen, "axes", f"duplicate axis {p!r}")
            seen.add(p)
            _check(c, len(vs) >= 1, "axes",
                   f"axis {p!r} needs at least one value")
            _get_path(self.base, p)      # raises naming the bad segment

    @property
    def shape(self) -> tuple:
        return tuple(len(vs) for _, vs in self.axes)

    @property
    def n_cells(self) -> int:
        return math.prod(self.shape) if self.axes else 1

    def cells(self) -> list:
        """``[(idx, values, spec), ...]`` — the cell's N-dim index tuple,
        its ``{path: value}`` override dict, and the fully-overridden
        (re-validated) ScenarioSpec."""
        import itertools
        paths = [p for p, _ in self.axes]
        out = []
        for idx in itertools.product(*(range(len(vs))
                                       for _, vs in self.axes)):
            values = {p: self.axes[a][1][i]
                      for a, (p, i) in enumerate(zip(paths, idx))}
            out.append((idx, values, override(self.base, values)))
        return out


def _get_path(spec, path: str):
    """Resolve a dotted field path, raising ``ValueError`` naming the bad
    segment (same error contract as :func:`override`)."""
    node = spec
    for head in path.split("."):
        if not dataclasses.is_dataclass(node):
            raise ValueError(f"path {path!r}: {type(node).__name__} "
                             "is not a spec dataclass")
        if head not in {f.name for f in dataclasses.fields(node)}:
            raise ValueError(f"path {path!r}: {type(node).__name__} "
                             f"has no field {head!r}")
        node = getattr(node, head)
    return node


# ---------------------------------------------------------------------------
# dotted-path override helper
# ---------------------------------------------------------------------------

def override(spec, overrides: dict):
    """Functional update of a (possibly nested) frozen spec.

    ``overrides`` maps dotted field paths to new values, e.g.::

        override(get_scenario("stream_default"),
                 {"pool.pool_size": 6, "window": 16})

    Unknown paths raise ``ValueError`` naming the bad segment; every
    intermediate node must be a dataclass. Validation reruns on each
    replaced node (``__post_init__``), so an override cannot produce an
    invalid spec silently.
    """
    def set_path(node, path, value):
        head, _, rest = path.partition(".")
        if not dataclasses.is_dataclass(node):
            raise ValueError(f"override path {path!r}: {type(node).__name__} "
                             "is not a spec dataclass")
        if head not in {f.name for f in dataclasses.fields(node)}:
            raise ValueError(f"override path {path!r}: "
                             f"{type(node).__name__} has no field {head!r}")
        if rest:
            value = set_path(getattr(node, head), rest, value)
        return dataclasses.replace(node, **{head: value})

    for path, value in overrides.items():
        spec = set_path(spec, path, value)
    return spec
