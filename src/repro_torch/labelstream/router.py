"""Streaming router: ring-buffer task window over sharded retainer pools.

Port of the single-device tick of ``src/repro/labelstream/router.py``.
Tasks arrive continuously (arrivals.py), queue in a per-shard backlog, are
admitted into a fixed-size ring-buffer window of ``window`` slots per shard,
are labeled by that shard's retainer pool, and are finalized by the
adaptive-redundancy policy (policy.py) on their running Dawid-Skene
posterior. Every ``refresh_every`` ticks the exact offline full-confusion EM
(aggregate.py) re-explains the window's vote log: one batched E-step kernel
launch per EM iteration for all replications x shards.

With ``learner.enabled`` tasks carry Gaussian feature vectors, a linear
learner per replication (shared by its shards, ``repro_torch.learning``)
trains online on finalized tasks from a replay ring, and its log-posterior
is fused into each task's posterior: model-known tasks finalize after
``min_votes_known`` votes, and votes go to the most uncertain tasks first.
``routing.enabled`` matches workers to tasks by score (routing.py);
``routing.admission`` other than ``"fifo"`` draws task identity at arrival
into a slot-array backlog and admits the most uncertain (or uncertain and
learnable) tasks first. ``sharding.steal="pressure"`` moves the oldest
backlog entries of hot shards to starved ones of the same replication
after every tick.

Layout: every per-shard tensor has a leading dimension ``B = n_reps *
n_shards`` (replication-major) in place of the reference's two ``vmap``s;
the learner's tensors lead with ``n_reps``. The tick loop is a Python loop
over ``_shard_tick``. Per-tick control flow never waits for the device: the
refresh and fit cadences are host integer tests and nothing in the tick
calls ``.item()``.

Randomness: the tick's own draws come from the counter-based ``lowbias32``
hash of ``(seed, step)`` (bit-exact with the reference); the worker banks
and seeds are drawn once on the host with a seeded ``numpy`` generator, and
per-tick arrivals with a ``torch.Generator`` on the run's device. For
parity tests, :func:`state_from_numpy` takes the reference's initial state
(and, optionally, a learner state) and :func:`run_stream` takes injected
arrival counts.

Serve mode (``serve=True``, :func:`serve_init` / :func:`serve_tick`) runs
the same tick one step at a time with injected per-shard arrival counts,
each arrival carrying a request uid through the backlog (and a steal) into
its window slot, for the live front end :mod:`repro_torch.serving.server`.

``trace`` (a :class:`~repro_torch.obs.trace.TraceConfig`) adds the
latency-source buffers: each window slot's admission instant, its staffed
and unstaffed tick time and the instant of its last evidence, pooled at
finalize into per-phase histograms and sums (backlog wait + window wait +
work time = time in system), and per-tick activity series. Tracing reads
state the tick already computes and draws nothing, so every shared output
stays bit-identical.

Sweeps (:func:`run_stream_sweep`, :func:`run_stream_votes_sweep`,
:func:`run_stream_grid`) run every point x replication x shard as rows of
one batched run: each point's initial state and arrivals are drawn as its
standalone :func:`run_stream` draws them, and the tick takes per-row vote
caps and difficulty mixtures, so each point equals its standalone run.

With ``learner.feature_kind="lm"`` the task features are LM embeddings of
synthetic task text: the tick gathers them from the embedding bank
(``repro_torch.embed.bank``, built once per config and device by
:func:`_bank_for`, or injected through ``bank=``) with the uniform the
Gaussian path would spend on its first feature coordinate, so labels,
difficulty and votes stay the same streams. In serve mode an LM task's
identity is bound at arrival and rides the backlog (and a steal) to its
admission, so a submitter's real-text embedding and known label reach its
window slot.

Device sharding (``sharding.n_devices = D > 1``, the reference's
``shard_map`` tick) runs one controller over D shard groups of ``n_shards /
D`` shards, group ``g`` on device ``g`` of a
:class:`~repro_torch.launch.mesh.StreamMesh`: each tick advances every
group on its device, and the mesh's ``gather`` / ``psum`` join them in
canonical shard order for the work steal, the shared learner and the
reduction over shards. Everything drawn from the seed is drawn once at full
width and sliced per group, so any D gives the one-group results bit for
bit. The sweeps batch their points on one device, each point's shards in
one group, as the reference's sweeps run sharded configs unsharded.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.crowd import (
    SWITCH_DELAY_S, WAIT_PAY_PER_S, WORK_PAY_PER_RECORD,
)
from repro_torch.core.simfast import (
    INF, FastConfig, _init_workers, _uniform_block, churn_and_maintain,
    draw_latency, priority_match,
)
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import (
    gather_rows, shard_rows, tree_map,
)
from repro_torch.embed.bank import bank_gather, embedding_bank
from repro_torch.labelstream.aggregate import _add_at, _count_rows, _ds_em
from repro_torch.labelstream.arrivals import (
    ArrivalConfig, init_arrival_state, sample_arrivals,
)
from repro_torch.labelstream.policy import (
    PolicyConfig, confidence, fuse_posteriors, learner_known,
    should_finalize, target_outstanding, uncertainty,
)
from repro_torch.labelstream.routing import (
    RoutingConfig, admit_scores, admit_select, learnability_features,
    route_scores, scored_match,
)
from repro_torch.launch.mesh import (
    StreamMesh, check_stream_sharding, make_stream_mesh,
)
from repro_torch.learning import linear
from repro_torch.learning.linear import ordered_matmul
from repro_torch.obs import timing
from repro_torch.obs.trace import PHASES as TRACE_PHASES
from repro_torch.obs.trace import TraceConfig


@dataclasses.dataclass(frozen=True)
class StreamLearnerConfig:
    """Streaming hybrid learning knobs; fields and defaults as in the
    reference. ``feature_kind`` is ``"gaussian"`` (class-conditional
    Gaussians drawn in the tick) or ``"lm"`` (LM embeddings gathered from
    the embedding bank of ``embed``, a
    :class:`~repro_torch.embed.config.EmbedConfig`)."""
    enabled: bool = False
    n_features: int = 8
    class_sep: float = 1.8
    hard_sep_scale: float = 1.0
    feature_kind: str = "gaussian"
    embed: Optional[object] = None   # an EmbedConfig iff feature_kind="lm"
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


@dataclasses.dataclass(frozen=True)
class ShardingConfig:
    """Device topology for the streaming tick: ``n_devices`` shard groups
    of ``n_shards / n_devices`` shards, each on its own device of the
    run's :class:`~repro_torch.launch.mesh.StreamMesh`, with bit-identical
    results at any count. ``steal="pressure"`` adds cross-shard work
    stealing each tick: shards exchange their backlog depths (a gather),
    shards more than ``steal_slack`` tasks above the global mean donate up
    to ``steal_max`` of their OLDEST backlog entries, and shards below the
    mean claim them in deterministic shard order (FIFO admission only)."""
    n_devices: int = 1
    steal: str = "none"           # "none" | "pressure"
    steal_max: int = 4            # max tasks a donor shard exports per tick
    steal_slack: int = 2          # backlog excess over global mean to donate


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    """Static configuration for the streaming service (hashable); fields
    and defaults as in the reference."""
    n_shards: int = 2
    pool_size: int = 8            # workers per shard
    window: int = 32              # ring-buffer task slots per shard
    backlog: int = 1024           # backlog FIFO capacity per shard
    n_classes: int = 2
    dt: float = 5.0               # tick length (s)
    max_arrivals_per_tick: int = 64   # per shard; excess is counted dropped
    arrivals: ArrivalConfig = ArrivalConfig()
    policy: PolicyConfig = PolicyConfig()
    batch_replay: bool = False    # naive baseline: drain window, then refill
    # task difficulty mixture: a fraction of tasks where worker accuracy is
    # scaled toward chance (p_correct = 1/C + (acc - 1/C) * difficulty)
    p_hard: float = 0.0
    hard_scale: float = 0.35
    # straggler mitigation + pool maintenance (simfast semantics)
    straggler: bool = True
    max_dup: int = 2
    pm_l: float = float("inf")
    use_termest: bool = True
    min_obs: int = 3
    z: float = 1.0
    alpha: float = 1.0
    # retainer pool / population (simfast defaults)
    recruit_mean_s: float = 45.0
    session_mean_s: float = 1800.0
    median_mu: float = 150.0
    sigma_ln: float = 1.0
    cv_lo: float = 0.3
    cv_hi: float = 1.2
    acc_a: float = 18.0
    acc_b: float = 2.0
    latency_floor: float = 2.0
    # pre-drawn replacement workers per slot; a slot that has used every
    # column re-installs its last draw forever
    bank: int = 64
    # online worker-accuracy prior (Beta pseudo-counts)
    est_prior_acc: float = 0.85
    est_prior_n: float = 8.0
    learner: StreamLearnerConfig = StreamLearnerConfig()
    routing: RoutingConfig = RoutingConfig()
    # periodic offline full-confusion Dawid-Skene refresh every
    # ``refresh_every`` ticks over the window's vote log (0 = off)
    refresh_every: int = 0
    refresh_iters: int = 8
    serve: bool = False
    # time-in-system histogram (steady-state percentiles)
    tis_bins: int = 512
    tis_bin_s: float = 4.0
    sharding: ShardingConfig = ShardingConfig()
    # latency-source trace buffers and per-tick series (None: untraced)
    trace: Optional[TraceConfig] = None

    @property
    def fast(self) -> FastConfig:
        """simfast config slice used by the reused pool machinery."""
        return FastConfig(
            pool_size=self.pool_size, retainer=True,
            recruit_mean_s=self.recruit_mean_s,
            session_mean_s=self.session_mean_s,
            median_mu=self.median_mu, sigma_ln=self.sigma_ln,
            cv_lo=self.cv_lo, cv_hi=self.cv_hi,
            acc_a=self.acc_a, acc_b=self.acc_b,
            pm_l=self.pm_l, use_termest=self.use_termest,
            min_obs=self.min_obs, z=self.z, alpha=self.alpha,
            latency_floor=self.latency_floor, bank=self.bank,
        )


def heterogeneous_stream_config(**overrides) -> StreamConfig:
    """The canonical heterogeneous-pool workload where worker-aware routing
    has signal to exploit: a wide Beta(2, 1) worker-accuracy spread, a weak
    estimation prior so the online estimates separate workers, hour-long
    sessions so they stay valid, and drip adaptive redundancy (one
    outstanding vote, finalize at 0.95). ``overrides`` are StreamConfig
    fields applied on top."""
    base = dict(
        n_shards=2, pool_size=8, window=16, dt=5.0, tis_bin_s=8.0,
        arrivals=ArrivalConfig(kind="poisson", rate=0.012),
        acc_a=2.0, acc_b=1.0, est_prior_n=2.0, session_mean_s=3600.0,
        policy=PolicyConfig(adaptive=True, votes_cap=5, conf_threshold=0.95,
                            min_votes=1, max_outstanding=1))
    base.update(overrides)
    return StreamConfig(**base)


class StreamTraced(NamedTuple):
    """Absolute per-point overrides of the static stream knobs: the grid
    bundle of :func:`run_stream_grid`. Each leaf replaces the same-named
    config value; ``0`` is "not overridden" for ``rate`` (``arrivals.rate``:
    the poisson rate, mmpp calm rate or diurnal mean), ``votes_cap`` (a
    masked cap: the vote buffers stay at the config's ``votes_cap``),
    ``acc_a`` and ``acc_b`` (the workers' Beta accuracy prior), and any
    NEGATIVE value for ``p_hard`` and ``hard_scale`` (0 is a valid
    ``p_hard``). A point whose values equal the config runs as
    :func:`run_stream` does, bit for bit."""
    rate: object = 0.0
    votes_cap: object = 0
    acc_a: object = 0.0
    acc_b: object = 0.0
    p_hard: object = -1.0
    hard_scale: object = -1.0


# --------------------------------------------------------------------------
# state init
# --------------------------------------------------------------------------

def _init_window(cfg: StreamConfig, B: int, device):
    Ws, C, cap = cfg.window, cfg.n_classes, cfg.policy.votes_cap
    z = dict(device=device)
    win = dict(
        active=torch.zeros((B, Ws), dtype=torch.bool, **z),
        arrival_t=torch.zeros((B, Ws), **z),
        difficulty=torch.ones((B, Ws), **z),
        true_label=torch.zeros((B, Ws), dtype=torch.int64, **z),
        n_votes=torch.zeros((B, Ws), dtype=torch.int64, **z),
        logpost=torch.zeros((B, Ws, C), **z),
        # per-slot vote store (worker slot + label); row Ws is the dump row
        vote_wid=torch.zeros((B, Ws + 1, cap), dtype=torch.int64, **z),
        vote_lab=torch.zeros((B, Ws + 1, cap), dtype=torch.int64, **z),
    )
    if cfg.learner.enabled:
        win["feat"] = torch.zeros((B, Ws, cfg.learner.n_features), **z)
    if cfg.serve:
        # per-slot request uid (serve mode): -1 marks "no request here"
        win["uid"] = torch.full((B, Ws), -1, dtype=torch.int64, **z)
    if cfg.trace is not None and cfg.trace.phases:
        # per-slot phase accounting: admission instant, staffed ("work")
        # and unstaffed ("wait") tick time, and the instant of the last
        # posterior evidence (admission or credited vote)
        for k in ("admit_t", "work_s", "wait_s", "last_evt_t"):
            win[k] = torch.zeros((B, Ws), **z)
    return win


def _init_backlog(cfg: StreamConfig, B: int, device):
    Q, z = cfg.backlog, dict(device=device)
    if cfg.routing.admission != "fifo":
        # slot-array backlog: task identity (difficulty, label, features) is
        # drawn at ARRIVAL so admission can rank by model uncertainty; row Q
        # is the dump row of masked writes
        bl = dict(times=torch.zeros((B, Q + 1), **z),
                  diff=torch.ones((B, Q + 1), **z),
                  tlab=torch.zeros((B, Q + 1), dtype=torch.int64, **z),
                  feat=torch.zeros((B, Q + 1, cfg.learner.n_features), **z),
                  occ=torch.zeros((B, Q), dtype=torch.bool, **z),
                  count=torch.zeros((B,), dtype=torch.int64, **z))
    else:
        # FIFO ring of arrival times; slot Q is the dump slot of masked
        # writes
        bl = dict(times=torch.zeros((B, Q + 1), **z),
                  head=torch.zeros((B,), dtype=torch.int64, **z),
                  count=torch.zeros((B,), dtype=torch.int64, **z))
    if cfg.serve:
        # the request uid of every backlog entry (serve mode)
        bl["uid"] = torch.full((B, Q + 1), -1, dtype=torch.int64, **z)
    if _lm_ring(cfg):
        # serve + lm binds task identity at ARRIVAL (a submitter's label and
        # embedding ride the FIFO ring to the admission tick)
        bl["tlab"] = torch.zeros((B, Q + 1), dtype=torch.int64, **z)
        bl["diff"] = torch.ones((B, Q + 1), **z)
        bl["feat"] = torch.zeros((B, Q + 1, cfg.learner.n_features), **z)
    return bl


def _lm_ring(cfg: StreamConfig) -> bool:
    """Whether the FIFO backlog carries task identity (serve + lm)."""
    return (cfg.serve and cfg.learner.feature_kind == "lm"
            and cfg.routing.admission == "fifo")


def _init_learner(cfg: StreamConfig, n_reps: int, device):
    """One learner per replication, shared by its shards, and the replay
    ring of finalized (features, label) pairs (row ``buffer`` is the dump
    row); under ``uncertain_learnable`` also the learnability head over
    square-augmented features and its targets."""
    L, z = cfg.learner, dict(device=device)
    ls = dict(
        learn=linear.init(L.n_features, cfg.n_classes, (n_reps,), device),
        buf_X=torch.zeros((n_reps, L.buffer + 1, L.n_features), **z),
        buf_y=torch.zeros((n_reps, L.buffer + 1), dtype=torch.int64, **z),
        buf_n=torch.zeros((n_reps,), dtype=torch.int64, **z))
    if cfg.routing.admission == "uncertain_learnable":
        ls["learn2"] = linear.init(2 * L.n_features, 2, (n_reps,), device)
        ls["buf_t"] = torch.zeros((n_reps, L.buffer + 1), dtype=torch.int64,
                                  **z)
    return ls


def _init_shard(cfg: StreamConfig, rng: np.random.Generator, lead):
    """Worker state and banks for ``lead`` shards as numpy arrays, drawn
    with the reference's distributions (see ``simfast._init_workers``) plus
    the router's online-estimate fields."""
    ws, banks = _init_workers(cfg.fast, rng, lead)
    P = cfg.pool_size
    ws["est_correct"] = np.zeros(tuple(lead) + (P,), np.float32)
    ws["est_n"] = np.zeros(tuple(lead) + (P,), np.float32)
    # per-worker completion-latency EWMA (the routing speed axis)
    ws["lat_ewma"] = np.full(tuple(lead) + (P,), cfg.median_mu, np.float32)
    return ws, banks


_WS_KEYS = ("mu", "sigma", "acc", "repl_idx", "busy_until", "assigned",
            "start_t", "blocked_until", "session_end", "n_started",
            "n_completed", "n_terminated", "comp_sum", "comp_sqsum",
            "term_sum", "cost_wait", "cost_work", "n_evicted", "n_churned",
            "est_correct", "est_n", "lat_ewma")


def _tensor(a, B: int, device):
    a = np.asarray(a)
    if a.dtype == np.bool_:
        dtype = torch.bool
    elif np.issubdtype(a.dtype, np.integer):
        dtype = torch.int64
        a = a.astype(np.int64)
    else:
        dtype = torch.float32
    return torch.tensor(a, dtype=dtype, device=device).reshape(
        (B,) + a.shape[2:])


def _learner_from_numpy(cfg: StreamConfig, learner: dict, n_reps: int,
                        device):
    """The learner state from numpy arrays with leading dim ``n_reps``:
    ``learn`` (and, under ``uncertain_learnable``, ``learn2``) as the seven
    ``LinearLearner`` leaves, and the ring ``buf_X``, ``buf_y``, ``buf_n``
    (and ``buf_t``)."""
    keys = ["learn", "buf_X", "buf_y", "buf_n"]
    if cfg.routing.admission == "uncertain_learnable":
        keys += ["learn2", "buf_t"]
    missing = [k for k in keys if k not in learner]
    if missing:
        raise ValueError(f"learner state lacks {missing}")
    ls = {}
    for k in keys:
        if k in ("learn", "learn2"):
            ls[k] = linear.from_numpy(learner[k], device)
            lead = ls[k].W.shape[:-2]
        else:
            a = np.asarray(learner[k])
            ls[k] = torch.tensor(
                a.astype(np.int64) if np.issubdtype(a.dtype, np.integer)
                else a.astype(np.float32), device=device)
            lead = ls[k].shape[:1]
        if tuple(lead) != (n_reps,):
            raise ValueError(f"learner state {k!r} leads with {tuple(lead)}, "
                             f"expected ({n_reps},)")
    return ls


def state_from_numpy(cfg: StreamConfig, ws: dict, banks: dict, seeds,
                     device="cuda", learner: Optional[dict] = None):
    """The port's run state from per-shard initial state given as numpy
    arrays with leading dims ``(n_reps, n_shards)``: the worker state of
    ``_init_shard`` (the reference's or the port's), its banks, and the
    ``uint32`` per-shard counter seeds. Window and backlog start empty; the
    learner (``learner.enabled``) starts untrained unless ``learner`` gives
    its state (see :func:`_learner_from_numpy`). Returns a dict with
    ``ws``, ``banks``, ``win``, ``bl``, ``seeds`` and ``learner`` (None
    without one), per-shard tensors flattened to ``B = n_reps * n_shards``
    on ``device``."""
    dev = resolve_device(device)
    seeds = np.asarray(seeds)
    if seeds.ndim != 2 or seeds.shape[1] != cfg.n_shards:
        raise ValueError(f"seeds must be (n_reps, n_shards={cfg.n_shards}), "
                         f"got {seeds.shape}")
    n_reps = seeds.shape[0]
    B = n_reps * cfg.n_shards
    missing = [k for k in _WS_KEYS if k not in ws]
    if missing:
        raise ValueError(f"worker state lacks {missing}")
    if not cfg.learner.enabled:
        ls = None
    elif learner is None:
        ls = _init_learner(cfg, n_reps, dev)
    else:
        ls = _learner_from_numpy(cfg, learner, n_reps, dev)
    return dict(
        ws={k: _tensor(ws[k], B, dev) for k in _WS_KEYS},
        banks={k: _tensor(banks[k], B, dev) for k in ("mu", "sigma", "acc")},
        win=_init_window(cfg, B, dev), bl=_init_backlog(cfg, B, dev),
        seeds=_tensor(seeds.astype(np.uint32).astype(np.int64), B, dev),
        learner=ls)


# --------------------------------------------------------------------------
# one tick of every shard
# --------------------------------------------------------------------------

def _acc_hat(cfg: StreamConfig, ws):
    """Beta-smoothed clipped online worker-accuracy estimate — the quantity
    that weights online Dawid-Skene votes and feeds the routing accuracy
    axis."""
    return torch.clamp(
        (cfg.est_prior_acc * cfg.est_prior_n + ws["est_correct"])
        / (cfg.est_prior_n + ws["est_n"]), 0.52, 0.995)


def _task_features(u1, u2, tl, diff, L: StreamLearnerConfig, C: int):
    """Class-conditional Gaussian features (one-hot class means scaled by
    ``class_sep``, unit Box-Muller noise from the uniforms ``u1``, ``u2``
    (..., F)) for tasks with true labels ``tl`` (...). With
    ``hard_sep_scale != 1`` hard tasks (``diff < 1``) get their separation
    scaled by it."""
    nrm = torch.sqrt(-2.0 * torch.log1p(-u1)) * torch.cos(2.0 * math.pi * u2)
    means = L.class_sep * torch.eye(C, L.n_features, device=u1.device)
    base = means[tl]
    if L.hard_sep_scale != 1.0:
        base = base * torch.where(diff < 1.0, L.hard_sep_scale, 1.0)[..., None]
    return base + nrm


def _mixture(cfg: StreamConfig, ov):
    """The difficulty mixture ``(p_hard, hard_scale)``: the config's
    numbers, or the (B, 1) per-row tensors of a sweep's overrides."""
    if ov is None or ov.get("p_hard") is None:
        return cfg.p_hard, cfg.hard_scale
    return ov["p_hard"], ov["hard_scale"]


def _lm_identity(bank, u, tl, diff, feat_in=None, labels_in=None):
    """An LM task's label and features: labels ``labels_in`` >= 0 replace
    the drawn ``tl``, the bank gather by ``u`` gives the features, and
    ``feat_in`` rows whose first entry is finite (real-text embeddings)
    replace them."""
    if labels_in is not None:
        tl = torch.where(labels_in >= 0, labels_in, tl)
    feat = bank_gather(bank, u, tl, diff)
    if feat_in is not None:
        feat = torch.where(torch.isfinite(feat_in[..., :1]), feat_in, feat)
    return tl, feat


def _admit_fifo(cfg: StreamConfig, bl, n_arr, free, frank, gate, t, step,
                seed, uid_base=None, ov=None, bank=None, feat_in=None,
                labels_in=None):
    """FIFO ring push of this tick's arrivals and admission of the oldest
    into the free window slots; task identity (difficulty, label, features)
    is drawn at admission. In serve mode the arrivals carry the uids
    ``uid_base + i`` through the backlog's uid ring; with LM features
    there, identity is drawn at arrival instead (labels ``labels_in`` and
    embeddings ``feat_in`` (B, M, ...) may replace it, see
    :func:`_lm_identity`) and rides the ring with the uid. ``bank`` is the
    (2, C, K, F) embedding bank of LM features. ``ov`` holds a sweep's
    per-row overrides (see :func:`_shard_tick`). Returns ``(bl, dropped,
    admit, arr_t, diff, tl, featw, uid_w, adm)``; ``featw`` is None without
    the learner, ``uid_w`` (the admitted uids) outside serve mode, ``adm``
    (the ranked admission's mean score) always None here."""
    Ws, C, Q, M = cfg.window, cfg.n_classes, cfg.backlog, \
        cfg.max_arrivals_per_tick
    L, B, dev = cfg.learner, seed.shape[0], seed.device
    space = Q - bl["count"]
    n_push = torch.minimum(n_arr, space)
    dropped = n_arr - n_push
    slot = torch.arange(M, device=dev)
    pos = (bl["head"][:, None] + bl["count"][:, None] + slot) % Q
    posw = torch.where(slot < n_push[:, None], pos, Q)
    bl_times = bl["times"].scatter(1, posw, t)       # slot Q: dump writes
    bl_count = bl["count"] + n_push
    n_adm = torch.where(gate, torch.minimum(bl_count, free.sum(-1)), 0)
    admit = free & (frank < n_adm[:, None])
    src = torch.where(admit, (bl["head"][:, None] + frank) % Q, Q)
    arr_t = torch.gather(bl_times, 1, src)
    bl_new = dict(times=bl_times, head=(bl["head"] + n_adm) % Q,
                  count=bl_count - n_adm)
    uid_w = None
    if cfg.serve:
        # the dump slot keeps -1, so the state is the same from run to run
        # whatever order duplicate writes land in
        bl_new["uid"] = bl["uid"].scatter(1, posw, torch.where(
            slot < n_push[:, None], uid_base[:, None] + slot, -1))
        uid_w = torch.gather(bl_new["uid"], 1, src)
    ph, hs = _mixture(cfg, ov)
    if _lm_ring(cfg):
        # identity drawn at ARRIVAL (or injected) rides the ring; the dump
        # slot keeps its fills (0, 1.0, 0.0)
        F = L.n_features
        ua = _uniform_block(seed ^ 0x0BAD5EED, step, 3 * M).reshape(B, 3, M)
        diff_a = torch.where(ua[:, 0] < ph, hs, 1.0)
        tl_a = torch.clamp(torch.floor(ua[:, 1] * C).to(torch.int64), 0,
                           C - 1)
        tl_a, feat_a = _lm_identity(bank, ua[:, 2], tl_a, diff_a, feat_in,
                                    labels_in)
        okp = slot < n_push[:, None]
        bl_new["tlab"] = bl["tlab"].scatter(1, posw, torch.where(okp, tl_a,
                                                                 0))
        bl_new["diff"] = bl["diff"].scatter(1, posw, torch.where(okp, diff_a,
                                                                 1.0))
        bl_new["feat"] = bl["feat"].scatter(
            1, posw[..., None].expand(B, M, F),
            torch.where(okp[..., None], feat_a, 0.0))
        diff = torch.gather(bl_new["diff"], 1, src)
        tl = torch.gather(bl_new["tlab"], 1, src)
        featw = torch.gather(bl_new["feat"], 1,
                             src[..., None].expand(-1, -1, F))
        return bl_new, dropped, admit, arr_t, diff, tl, featw, uid_w, None
    # fresh-task draws at ADMISSION (difficulty mixture + label)
    uw = _uniform_block(seed ^ 0x33CC33CC, step, 2 * Ws).reshape(B, 2, Ws)
    diff = torch.where(uw[:, 0] < ph, hs, 1.0)
    tl = torch.clamp(torch.floor(uw[:, 1] * C).to(torch.int64), 0, C - 1)
    featw = None
    if L.enabled:
        F = L.n_features
        uf = _uniform_block(seed ^ 0x5EEDF00D, step, 2 * Ws * F
                            ).reshape(B, 2, Ws, F)
        if L.feature_kind == "lm":
            # the Gaussian draw's block, its first column picking the bank
            # variant, so every other stream stays the same
            featw = bank_gather(bank, uf[:, 0, :, 0], tl, diff)
        else:
            featw = _task_features(uf[:, 0], uf[:, 1], tl, diff, L, C)
    return bl_new, dropped, admit, arr_t, diff, tl, featw, uid_w, None


def _admit_ranked(cfg: StreamConfig, bl, n_arr, free, frank, gate, t, step,
                  seed, lp, uid_base=None, ov=None, bank=None, feat_in=None,
                  labels_in=None):
    """Learner-driven admission: this tick's arrivals draw their identity
    (difficulty, label, features) now and take the free slots of the
    slot-array backlog (the i-th arrival the i-th free slot); queued tasks
    enter the window most uncertain first under the current model (times
    the learnability head's estimate under ``uncertain_learnable``), ties
    in slot order. Serve mode's uids take the arrivals' backlog slots. LM
    features come from ``bank`` (the arrival's third uniform picks the
    variant), with ``labels_in`` / ``feat_in`` as in :func:`_admit_fifo`.
    Returns what :func:`_admit_fifo` does, ``adm`` being the mean
    admission score of the tasks admitted (B,) when the trace records
    per-tick series, else None."""
    C, Q, M = cfg.n_classes, cfg.backlog, cfg.max_arrivals_per_tick
    L, R, B, dev = cfg.learner, cfg.routing, seed.shape[0], seed.device
    F = L.n_features
    occ = bl["occ"]
    space = Q - occ.sum(-1)
    n_push = torch.minimum(n_arr, space)
    dropped = n_arr - n_push
    slot = torch.arange(M, device=dev)
    # i-th arrival -> i-th free backlog slot (searchsorted rank trick)
    csum = torch.cumsum((~occ).to(torch.int64), -1)
    dst = torch.searchsorted(csum, (slot + 1).expand(B, M).contiguous())
    ok = slot < n_push[:, None]
    dstw = torch.where(ok, dst, Q)                   # row Q is the dump row
    ua = _uniform_block(seed ^ 0x0BAD5EED, step, (2 + 2 * F) * M
                        ).reshape(B, 2 + 2 * F, M)
    ph, hs = _mixture(cfg, ov)
    diff_a = torch.where(ua[:, 0] < ph, hs, 1.0)
    tl_a = torch.clamp(torch.floor(ua[:, 1] * C).to(torch.int64), 0, C - 1)
    if L.feature_kind == "lm":
        tl_a, feat_a = _lm_identity(bank, ua[:, 2], tl_a, diff_a, feat_in,
                                    labels_in)
    else:
        feat_a = _task_features(ua[:, 2:2 + F].transpose(1, 2),
                                ua[:, 2 + F:].transpose(1, 2), tl_a, diff_a,
                                L, C)
    # the dump row keeps its initial values, so the state stays the same
    # from run to run whatever order duplicate writes land in
    bl_times = bl["times"].scatter(1, dstw, torch.where(ok, t, 0.0))
    bl_diff = bl["diff"].scatter(1, dstw, torch.where(ok, diff_a, 1.0))
    bl_tlab = bl["tlab"].scatter(1, dstw, torch.where(ok, tl_a, 0))
    bl_feat = bl["feat"].scatter(
        1, dstw[..., None].expand(B, M, F),
        torch.where(ok[..., None], feat_a, 0.0))
    occ = torch.cat([occ, torch.zeros((B, 1), dtype=torch.bool, device=dev)],
                    1).scatter(1, dstw, True)[:, :Q]
    n_adm = torch.where(gate, torch.minimum(occ.sum(-1), free.sum(-1)), 0)
    u_bl = uncertainty(ordered_matmul(bl_feat[:, :Q], lp["lW"])
                       + lp["lb"][:, None, :])
    if R.admission == "uncertain_learnable":
        adm_key = admit_scores(u_bl, bl_feat[:, :Q], lp["gW"], lp["gb"])
    else:
        adm_key = u_bl
    admit_bl, order = admit_select(adm_key, occ, n_adm)
    admit = free & (frank < n_adm[:, None])
    # the r-th free window slot takes the r-th most uncertain queued task
    src = torch.where(admit, torch.gather(order, 1, frank.clamp(0, Q - 1)),
                      Q)
    arr_t = torch.gather(bl_times, 1, src)
    diff = torch.gather(bl_diff, 1, src)
    tl = torch.gather(bl_tlab, 1, src)
    featw = torch.gather(bl_feat, 1, src[..., None].expand(-1, -1, F))
    occ = occ & ~admit_bl
    bl_new = dict(times=bl_times, diff=bl_diff, tlab=bl_tlab, feat=bl_feat,
                  occ=occ, count=occ.sum(-1))
    uid_w = None
    if cfg.serve:
        bl_new["uid"] = bl["uid"].scatter(
            1, dstw, torch.where(ok, uid_base[:, None] + slot, -1))
        uid_w = torch.gather(bl_new["uid"], 1, src)
    adm = None
    if cfg.trace is not None and cfg.trace.per_tick:
        # mean admission score of what this tick admitted (how uncertain
        # the admitted tasks still are)
        adm = (torch.where(admit_bl, adm_key, 0.0).sum(-1)
               / torch.clamp(admit_bl.sum(-1), min=1))
    return bl_new, dropped, admit, arr_t, diff, tl, featw, uid_w, adm


def _shard_tick(cfg: StreamConfig, ws, banks, win, bl, n_arr, t: float,
                step: int, seed, warmup_t: float, lp: Optional[dict] = None,
                uid_base=None, ov: Optional[dict] = None, bank=None,
                feat_in=None, labels_in=None):
    """Advance every shard by one tick. ``n_arr`` (B,) are this tick's
    arrivals per shard, ``t`` the tick's time and ``step`` its index (host
    numbers), ``seed`` (B,) the counter seeds, ``lp`` the learner's
    parameters expanded to B (:func:`_learner_tick_params`; None without a
    learner), ``uid_base`` (B,) the first uid of each shard's arrivals in
    serve mode. ``ov`` holds a sweep's per-row overrides as (B, 1) tensors:
    ``cap``, the effective vote cap (the buffers stay at the config's
    ``votes_cap``; the row's cap gates vote admission, finalization and the
    outstanding target), and ``p_hard`` / ``hard_scale``, the difficulty
    mixture. ``bank`` is the embedding bank of LM features and
    ``feat_in`` / ``labels_in`` serve mode's injected embeddings and labels
    (see :func:`_admit_fifo`). Returns ``(ws, win, bl, metrics, train)``;
    ``train`` holds the finalized examples for the learner's ring (None
    without one); in serve
    mode ``metrics`` also holds the per-slot ``srv_*`` outputs, and with a
    trace the phase histograms and sums (``ph`` (B, 4, tis_bins) / ``ps``
    (B, 4), the phases in ``TRACE_PHASES`` order) and the per-tick
    series."""
    P, Ws, C = cfg.pool_size, cfg.window, cfg.n_classes
    cap = cfg.policy.votes_cap
    cap_eff = None if ov is None else ov.get("cap")
    cap_t = cap if cap_eff is None else cap_eff
    pol, fast, L, R = cfg.policy, cfg.fast, cfg.learner, cfg.routing
    tr = cfg.trace
    tr_ph = tr is not None and tr.phases
    dev = seed.device
    B = seed.shape[0]
    up = _uniform_block(seed, step, 8 * P).reshape(B, 8, P)

    # ---- backlog push + admission into free window slots -----------------
    with timing.span("tick.admit", dev):
        free = ~win["active"]
        if cfg.batch_replay:
            # naive fixed-batch replay: refill only once the window is drained
            gate = free.all(-1)
        else:
            gate = torch.ones((B,), dtype=torch.bool, device=dev)
        frank = torch.cumsum(free.to(torch.int64), -1) - 1
        if R.admission != "fifo":
            bl, dropped, admit, arr_t, diff, tl, featw, uid_w, adm = \
                _admit_ranked(cfg, bl, n_arr, free, frank, gate, t, step, seed,
                              lp, uid_base, ov, bank, feat_in, labels_in)
        else:
            bl, dropped, admit, arr_t, diff, tl, featw, uid_w, adm = \
                _admit_fifo(cfg, bl, n_arr, free, frank, gate, t, step, seed,
                            uid_base, ov, bank, feat_in, labels_in)
        bl_count = bl["count"]
        win = dict(win)
        win["active"] = win["active"] | admit
        win["arrival_t"] = torch.where(admit, arr_t, win["arrival_t"])
        win["difficulty"] = torch.where(admit, diff, win["difficulty"])
        win["true_label"] = torch.where(admit, tl, win["true_label"])
        win["n_votes"] = torch.where(admit, 0, win["n_votes"])
        win["logpost"] = torch.where(admit[..., None], 0.0, win["logpost"])
        if L.enabled:
            win["feat"] = torch.where(admit[..., None], featw, win["feat"])
        if cfg.serve:
            win["uid"] = torch.where(admit, uid_w, win["uid"])
        if tr_ph:
            win["admit_t"] = torch.where(admit, t, win["admit_t"])
            win["work_s"] = torch.where(admit, 0.0, win["work_s"])
            win["wait_s"] = torch.where(admit, 0.0, win["wait_s"])
            win["last_evt_t"] = torch.where(admit, t, win["last_evt_t"])

    # ---- completions -> votes -> online posterior -----------------------
    with timing.span("tick.votes", dev):
        ws = dict(ws)
        active_w = ws["assigned"] >= 0
        comp = active_w & (ws["busy_until"] <= t)
        a_idx = torch.clamp(ws["assigned"], min=0)
        tid = torch.where(comp, ws["assigned"], Ws)
        lat = torch.where(comp, ws["busy_until"] - ws["start_t"], 0.0)
        d_w = torch.gather(win["difficulty"], 1, a_idx)
        p_corr = torch.clamp(1.0 / C + (ws["acc"] - 1.0 / C) * d_w, 1.0 / C,
                             0.995)
        tl_w = torch.gather(win["true_label"], 1, a_idx)
        correct = up[:, 0] < p_corr
        wrong = torch.floor(up[:, 1] * max(C - 1, 1)).to(torch.int64)
        label = torch.where(correct, tl_w,
                            torch.where(wrong >= tl_w, wrong + 1, wrong))
        # vote slot position: n_votes before this tick + rank among this tick's
        # completions of the same task; votes landing past the cap are dropped
        pr = torch.arange(P, device=dev)
        prior_ct = ((tid[:, None, :] == tid[:, :, None]) & comp[:, None, :]
                    & (pr[None, :] < pr[:, None])).sum(-1)
        vpos = torch.gather(win["n_votes"], 1, a_idx) + prior_ct
        keep = comp & (vpos < cap_t)
        tid_k = torch.where(keep, tid, Ws)
        vpos_k = torch.clamp(torch.where(keep, vpos, 0), 0, cap - 1)
        lin = tid_k * cap + vpos_k              # kept (task, slot) are unique
        flat_w = win["vote_wid"].reshape(B, -1)
        flat_l = win["vote_lab"].reshape(B, -1)
        win["vote_wid"] = flat_w.scatter(
            1, lin, torch.where(keep, pr, torch.gather(flat_w, 1, lin))
        ).reshape(B, Ws + 1, cap)
        win["vote_lab"] = flat_l.scatter(
            1, lin, torch.where(keep, label, torch.gather(flat_l, 1, lin))
        ).reshape(B, Ws + 1, cap)
        # online DS E-step: add the voter's estimated log-odds to its class
        a_e = _acc_hat(cfg, ws)
        delta = torch.log(a_e * max(C - 1, 1) / (1.0 - a_e))
        lp_all = torch.cat([win["logpost"],
                            torch.zeros((B, 1, C), device=dev)], 1
                           ).reshape(B, -1)
        win["logpost"] = _add_at(lp_all, tid_k * C + label,
                                 torch.where(keep, delta, 0.0)
                                 ).reshape(B, Ws + 1, C)[:, :Ws]
        win["n_votes"] = win["n_votes"] + _count_rows(
            Ws + 1, torch.where(keep, tid_k, Ws))[:, :Ws]
        if tr_ph:
            # the completion instant of this tick's credited votes (busy_until
            # still holds it; it is reset below): the finalize lag counts from
            # the last evidence the posterior saw. A max is exact in any order
            evt = torch.cat([win["last_evt_t"],
                             torch.zeros((B, 1), device=dev)], 1)
            win["last_evt_t"] = evt.scatter_reduce(
                1, tid_k, torch.where(keep, ws["busy_until"], -INF), "amax"
            )[:, :Ws]

    # ---- periodic offline full-confusion Dawid-Skene refresh ------------
    # every refresh_every ticks, re-run the exact batched EM on the
    # window's vote log and reset the online posteriors and worker-accuracy
    # estimates from it; one E-step launch per iteration for all shards
    if cfg.refresh_every > 0 \
            and step % cfg.refresh_every == cfg.refresh_every - 1:
        with timing.span("tick.refresh", dev):
            vmask_r = (torch.arange(cap, device=dev)[None, None, :]
                       < win["n_votes"][..., None]) \
                & win["active"][..., None]
            em = _ds_em(win["vote_lab"][:, :Ws], win["vote_wid"][:, :Ws],
                        vmask_r, P + 1, C, cfg.refresh_iters, False)
            vpw = em["votes_per_worker"][:, :P]
            win["logpost"] = torch.where(
                (win["active"] & (win["n_votes"] > 0))[..., None],
                em["log_posterior"], win["logpost"])
            ws["est_correct"] = em["accuracy"][:, :P] * vpw
            ws["est_n"] = vpw

    # ---- learner fusion (product of experts) ----------------------------
    with timing.span("tick.fuse", dev):
        # the policy reads the crowd posterior fused with the learner's: tasks
        # the model already knows finalize after min_votes_known crowd votes
        if L.enabled:
            model_lg = ordered_matmul(win["feat"], lp["lW"]) \
                + lp["lb"][:, None]
            fused = fuse_posteriors(win["logpost"],
                                    torch.log_softmax(model_lg, dim=-1),
                                    lp["fuse_w"][:, None, None])
            known, known_fin = learner_known(
                fused, win["n_votes"], threshold=L.known_threshold,
                min_votes_known=L.min_votes_known)
        else:
            fused = win["logpost"]

    # ---- finalization (adaptive redundancy) -----------------------------
    with timing.span("tick.finalize", dev):
        fin, conf = should_finalize(fused, win["n_votes"], pol, cap=cap_eff)
        if L.enabled:
            fin = fin | known_fin
        fin = fin & win["active"]
        result = fused.argmax(-1)
        tis = torch.where(fin, t - win["arrival_t"], 0.0)
        # steady-state metrics count tasks by ARRIVAL-time warmth
        wfin = fin & (win["arrival_t"] >= warmup_t)
        nbin = cfg.tis_bins
        hbin = torch.clamp((tis / cfg.tis_bin_s).to(torch.int64), 0, nbin - 1)
        hist_d = _count_rows(nbin + 1, torch.where(wfin, hbin, nbin))[:, :nbin]
        done_d = wfin.sum(-1)
        corr_d = (wfin & (result == win["true_label"])).sum(-1)
        tis_d = (tis * wfin).sum(-1)
        votesfin_d = (win["n_votes"] * wfin).sum(-1)
        if tr_ph:
            # the latency-source decomposition at finalize, the phases in
            # TRACE_PHASES order: backlog wait + window wait + work time is the
            # time in system (the tick accounting below); the finalize lag
            # overlaps the tail. All four bin into one (B, 4, nbin) histogram
            ph_vals = torch.stack(
                [win["admit_t"] - win["arrival_t"], win["wait_s"],
                 win["work_s"], torch.clamp(t - win["last_evt_t"], min=0.0)],
                1)
            pb = torch.clamp((ph_vals / cfg.tis_bin_s).to(torch.int64), 0,
                             nbin - 1)
            pb = torch.where(wfin[:, None], pb, nbin) + (nbin + 1) \
                * torch.arange(4, device=dev)[:, None]
            ph_hist = _count_rows(4 * (nbin + 1), pb.reshape(B, -1)
                                  ).reshape(B, 4, nbin + 1)[..., :nbin]
            ph_sum = (ph_vals * wfin[:, None]).sum(-1)
        # credit voters of finalized tasks by agreement with the final label
        # (incremental hard-EM M-step for the online accuracy estimates)
        vmask = (torch.arange(cap, device=dev)[None, None, :]
                 < win["n_votes"][..., None]) & fin[..., None]
        vw = torch.where(vmask, win["vote_wid"][:, :Ws], P).reshape(B, -1)
        agree = ((win["vote_lab"][:, :Ws] == result[..., None])
                 & vmask).reshape(B, -1)
        n_agree = torch.zeros((B, P + 1), dtype=torch.int64, device=dev
                              ).scatter_add_(1, vw, agree.to(torch.int64))
        ws["est_correct"] = ws["est_correct"] \
            + n_agree[:, :P].to(torch.float32)
        ws["est_n"] = ws["est_n"] + _count_rows(P + 1, vw)[:, :P].to(
            torch.float32)
        win["active"] = win["active"] & ~fin

    # ---- worker bookkeeping: completers + straggler losers --------------
    with timing.span("tick.workers", dev):
        lose = active_w & ~comp & torch.gather(fin, 1, a_idx)
        win_lat = torch.zeros((B, Ws + 1), device=dev).scatter_reduce(
            1, tid, lat, "amax")[:, :Ws]
        winner = torch.where(lose, torch.gather(win_lat, 1, a_idx), 0.0)
        freed = comp | lose
        ws["n_completed"] = ws["n_completed"] + comp
        ws["n_terminated"] = ws["n_terminated"] + lose
        ws["comp_sum"] = ws["comp_sum"] + lat * comp
        ws["comp_sqsum"] = ws["comp_sqsum"] + lat * lat * comp
        ws["term_sum"] = ws["term_sum"] + winner * lose
        # completion-latency EWMA: the routing speed axis (route_scores)
        ws["lat_ewma"] = torch.where(
            comp, (1.0 - R.ewma_alpha) * ws["lat_ewma"] + R.ewma_alpha * lat,
            ws["lat_ewma"])
        ws["cost_work"] = ws["cost_work"] + freed.sum(-1) * WORK_PAY_PER_RECORD
        ws["blocked_until"] = torch.where(
            comp, ws["busy_until"],
            torch.where(lose, t + SWITCH_DELAY_S, ws["blocked_until"]))
        ws["assigned"] = torch.where(freed, -1, ws["assigned"])
        ws["busy_until"] = torch.where(freed, INF, ws["busy_until"])

        # ---- churn + latency maintenance (shared simfast machinery) ---------
        ws, leave = churn_and_maintain(fast, ws, banks, t, up[:, 2], up[:, 3],
                                       cfg.recruit_mean_s)
        ws["est_correct"] = torch.where(leave, 0.0, ws["est_correct"])
        ws["est_n"] = torch.where(leave, 0.0, ws["est_n"])
        ws["lat_ewma"] = torch.where(leave, cfg.median_mu, ws["lat_ewma"])
        # stored votes key on the pool slot: remap votes cast by departing
        # workers to the dump slot P so crediting cannot charge the replacement
        leave_pad = torch.cat([leave, torch.zeros((B, 1), dtype=torch.bool,
                                                  device=dev)], 1)
        gone = torch.gather(leave_pad, 1, win["vote_wid"].reshape(B, -1)
                            ).reshape(win["vote_wid"].shape)
        win["vote_wid"] = torch.where(gone, P, win["vote_wid"])

    # ---- assignment: understaffed tasks first, then duplicates ----------
    with timing.span("tick.assign", dev):
        avail = (ws["assigned"] < 0) & (ws["blocked_until"] <= t) \
            & (ws["session_end"] > t)
        n_asg = _count_rows(Ws + 1, torch.where(ws["assigned"] >= 0,
                                                ws["assigned"], Ws))[:, :Ws]
        want = target_outstanding(win["n_votes"], pol, cap=cap_eff)
        if L.enabled:
            # a model-known task requests only the crowd votes it still needs
            # to clear the min_votes_known floor
            want = torch.where(known, torch.minimum(want, torch.clamp(
                L.min_votes_known - win["n_votes"], min=0)), want)
        tier1 = win["active"] & (n_asg < want)
        if cfg.straggler:
            extra = torch.clamp(want, max=cfg.max_dup)
            tier2 = win["active"] & (want > 0) & (n_asg >= want) \
                & (n_asg < want + extra)
        else:
            tier2 = torch.zeros_like(tier1)
        if R.enabled:
            # FROG-style routing: workers x window slots scored from the online
            # accuracy estimate (after this tick's crediting and churn) and the
            # latency EWMA, task uncertainty from the FUSED posterior
            shift = (_uniform_block(seed ^ 0xA5A5A5A5, step, 1)[:, 0]
                     * Ws).to(torch.int64)
            scores = route_scores(_acc_hat(cfg, ws), ws["lat_ewma"],
                                  uncertainty(fused), R)
            take, task_for_w, _, _ = scored_match(scores, avail, tier1, tier2,
                                                  shift)
        elif L.enabled and L.prioritize:
            # votes go to the window tasks with the LOWEST fused confidence
            # first: match in that permuted slot order and map back
            unc = torch.where(win["active"], -confidence(fused), -INF)
            perm = torch.argsort(-unc, dim=-1, stable=True)
            take, task_p, _, _ = priority_match(
                avail, torch.gather(tier1, 1, perm),
                torch.gather(tier2, 1, perm),
                torch.zeros((B,), dtype=torch.int64, device=dev))
            task_for_w = torch.gather(perm, 1, task_p)
        else:
            shift = (_uniform_block(seed ^ 0xA5A5A5A5, step, 1)[:, 0]
                     * Ws).to(torch.int64)
            take, task_for_w, _, _ = priority_match(avail, tier1, tier2, shift)
        lat_new = draw_latency(fast, ws["mu"], ws["sigma"], up[:, 6], up[:, 7])
        ws["assigned"] = torch.where(take, task_for_w, ws["assigned"])
        ws["busy_until"] = torch.where(take, t + lat_new, ws["busy_until"])
        ws["start_t"] = torch.where(take, t, ws["start_t"])
        ws["n_started"] = ws["n_started"] + take
        waiting = avail & ~take
        ws["cost_wait"] = ws["cost_wait"] \
            + waiting.sum(-1) * cfg.dt * WAIT_PAY_PER_S
        if tr_ph:
            # this tick is work time for every still-active task staffed after
            # the matching, window wait for the others; a task admitted at tick
            # k and finalized at tick k + m collects exactly m ticks, so the
            # three phases sum to its time in system
            n_asg_post = _count_rows(Ws + 1, torch.where(
                ws["assigned"] >= 0, ws["assigned"], Ws))[:, :Ws]
            staffed = win["active"] & (n_asg_post > 0)
            win["work_s"] = win["work_s"] + torch.where(staffed, cfg.dt, 0.0)
            win["wait_s"] = win["wait_s"] + torch.where(
                win["active"] & ~staffed, cfg.dt, 0.0)

    metrics = dict(
        hist=hist_d, done=done_d, correct=corr_d, sum_tis=tis_d,
        votes_fin=votesfin_d,
        completions=(comp & (torch.gather(win["arrival_t"], 1, a_idx)
                             >= warmup_t)).sum(-1),
        done_all=fin.sum(-1), dropped=dropped, backlog=bl_count,
        in_flight=win["active"].sum(-1),
        model_known=((wfin & known).sum(-1) if L.enabled
                     else torch.zeros_like(done_d)))
    if cfg.serve:
        # per-slot finalization outputs for the live serving front end:
        # which slots finalized this tick, their request uids, fused-label
        # answers, vote counts, posterior confidence and time in system
        metrics.update(srv_fin=fin, srv_uid=win["uid"], srv_label=result,
                       srv_votes=win["n_votes"], srv_conf=conf, srv_tis=tis)
    if tr_ph:
        metrics.update(ph=ph_hist, ps=ph_sum)
    if tr is not None and tr.per_tick:
        metrics.update(votes=keep.sum(-1),
                       busy_workers=(ws["assigned"] >= 0).sum(-1),
                       idle_workers=waiting.sum(-1))
        if adm is not None:
            metrics["adm_score"] = adm
    train = None
    if L.enabled:
        # finalized (features, label) pairs for the learner's ring. The
        # label is the CROWD-ONLY posterior's, so a confident-but-wrong model
        # cannot train on its own prediction; with train_crowd_only a pair
        # also needs one crowd vote
        crowd = win["logpost"].argmax(-1)
        train = dict(mask=fin & (win["n_votes"] >= 1) if L.train_crowd_only
                     else fin, feat=win["feat"], label=crowd)
        if R.admission == "uncertain_learnable":
            # learnability target: did the model's prediction agree with
            # the crowd's final label?
            train["learnable"] = (model_lg.argmax(-1) == crowd).to(
                torch.int64)
    return ws, win, bl, metrics, train


# --------------------------------------------------------------------------
# cross-shard work stealing
# --------------------------------------------------------------------------

def _steal_plan(counts, steal_max: int, slack: int):
    """Deterministic rebalance plan from the backlog depths ``counts`` (...,
    S) of one replication's shards: shards more than ``slack`` above the
    mean donate up to ``steal_max`` tasks, shards below it claim up to
    ``steal_max``, and the matched volume is filled greedily in shard order
    on both sides. Returns ``(give, take)``, each (..., S)."""
    S = counts.shape[-1]
    target = counts.sum(-1, keepdim=True) // S
    give0 = torch.clamp(counts - target - slack, 0, steal_max)
    take0 = torch.clamp(target - counts, 0, steal_max)
    vol = torch.minimum(give0.sum(-1, keepdim=True),
                        take0.sum(-1, keepdim=True))
    fill = lambda want: torch.minimum(
        torch.clamp(vol - (torch.cumsum(want, -1) - want), min=0), want)
    return fill(give0), fill(take0)


def _steal_rebalance(cfg: StreamConfig, bl, mesh: Optional[StreamMesh] = None):
    """Move backlog work from hot shards to starved ones of the same
    replication (FIFO ring). ``bl`` is one group's backlog, or a list of
    the mesh's groups' backlogs (each ``n_reps * n_shards / D`` rows).
    The groups' depths are gathered and the plan is global; donors pop
    their OLDEST entries (arrival times are task identity under FIFO
    admission), the donations are gathered and pooled per replication in
    donation-rank order, and each group's receivers claim their ranks at
    their own offset and append them at the tail: the replication's
    backlog multiset is unchanged. In serve mode the uid ring moves by the
    same plan, and with LM features the label, difficulty and embedding
    rings too, so a stolen entry keeps its identity. Returns ``(bl,
    received, donated)`` in ``bl``'s form, the counts per row."""
    one = isinstance(bl, dict)
    bls = [bl] if one else list(bl)
    if mesh is None:
        mesh = StreamMesh((bls[0]["count"].device,))
    sh = cfg.sharding
    S, Q, K = cfg.n_shards, cfg.backlog, sh.steal_max
    D = len(bls)
    Sl = S // D
    N = bls[0]["count"].shape[0] // Sl
    d0 = mesh.devices[0]
    counts = mesh.gather([b["count"].reshape(N, Sl) for b in bls], 1)
    give, take = _steal_plan(counts, K, sh.steal_slack)
    gcum = torch.cumsum(give, -1) - give                    # donation ranks
    tcum = torch.cumsum(take, -1) - take                    # claim ranks
    k = torch.arange(K, device=d0)
    validd = k < give[..., None]
    ranks = torch.where(validd, gcum[..., None] + k, S * K).reshape(N, -1)
    loc = []
    for g, (b, dev) in enumerate(zip(bls, mesh.devices)):
        give_l, take_l, tcum_l = (x[:, g * Sl:(g + 1) * Sl].to(dev)
                                  for x in (give, take, tcum))
        kl = k.to(dev)
        head = b["head"].reshape(N, Sl)
        count = b["count"].reshape(N, Sl)
        # donors pop their oldest entries off the ring head
        pos = (head[..., None] + kl) % Q                     # (N, Sl, K)
        head = (head + give_l) % Q
        count = count - give_l
        # receivers claim consecutive ranks and append at their tail
        validc = kl < take_l[..., None]
        loc.append(dict(
            pos=pos, validc=validc, take=take_l, give=give_l, head=head,
            count=count,
            claim=torch.where(validc, tcum_l[..., None] + kl, 0
                              ).reshape(N, -1),
            posr=torch.where(validc,
                             (head[..., None] + count[..., None] + kl) % Q,
                             Q)))

    def move(rings, fill):
        # the donations pooled in rank order (the dump entry S*K and the
        # ring's dump slot Q only ever take ``fill``); a ring may carry a
        # trailing feature axis
        trail = tuple(rings[0].shape[2:])
        ex = lambda i: i.reshape(i.shape + (1,) * len(trail)).expand(
            i.shape + trail)
        rings = [r.reshape((N, Sl, Q + 1) + trail) for r in rings]
        don = mesh.gather([torch.gather(r, 2, ex(lc["pos"]))
                           for r, lc in zip(rings, loc)], 1)
        pool = torch.full((N, S * K + 1) + trail, fill,
                          dtype=rings[0].dtype, device=d0).scatter(
            1, ex(ranks),
            torch.where(ex(validd), don, fill).reshape((N, -1) + trail)
        )[:, :S * K]
        out = []
        for r, lc, p in zip(rings, loc, mesh.replicate(pool)):
            incoming = torch.gather(p, 1, ex(lc["claim"])).reshape(
                (N, Sl, K) + trail)
            out.append(r.scatter(2, ex(lc["posr"]), torch.where(
                ex(lc["validc"]), incoming, fill)).reshape(
                    (N * Sl, Q + 1) + trail))
        return out

    new = [dict(times=t, head=lc["head"].reshape(-1),
                count=(lc["count"] + lc["take"]).reshape(-1))
           for t, lc in zip(move([b["times"] for b in bls], 0.0), loc)]
    for name, fill in (("uid", -1), ("tlab", 0), ("diff", 1.0),
                       ("feat", 0.0)):
        if name in bls[0]:
            for nb, ring in zip(new, move([b[name] for b in bls], fill)):
                nb[name] = ring
    got = [lc["take"].reshape(-1) for lc in loc]
    gave = [lc["give"].reshape(-1) for lc in loc]
    if one:
        return new[0], got[0], gave[0]
    return new, got, gave


# --------------------------------------------------------------------------
# driver
# --------------------------------------------------------------------------

def _learner_tick_params(cfg: StreamConfig, ls, n_shards: int):
    """The tick's learner parameters, each replication's expanded to its
    ``n_shards`` shards of one group (rows ``n_reps * n_shards``): the
    learner's ``lW``/``lb``, the fusion weight ``fuse_w`` (ramping with the
    ring's fill so an untrained model contributes nothing), and under
    ``uncertain_learnable`` the learnability head's ``gW``/``gb``. None
    without a learner."""
    if ls is None:
        return None
    L, S = cfg.learner, n_shards
    rep = lambda x: x.repeat_interleave(S, 0)
    fuse_w = L.prior_scale * torch.clamp(
        ls["buf_n"].to(torch.float32) / L.ramp_n, max=1.0)
    lp = dict(lW=rep(ls["learn"].W), lb=rep(ls["learn"].b),
              fuse_w=rep(fuse_w))
    if "learn2" in ls:
        lp.update(gW=rep(ls["learn2"].W), gb=rep(ls["learn2"].b))
    return lp


def _learner_push_fit(cfg: StreamConfig, ls, train, step: int):
    """Push this tick's finalized examples of every shard, in shard order,
    into their replication's replay ring, and on the ``fit_every`` cadence
    take ``fit_steps`` Adam steps on the ring (a no-op for a replication
    whose ring is empty) and refit the learnability head from scratch (60
    steps). Returns the new learner state."""
    L, S, Ws, F = cfg.learner, cfg.n_shards, cfg.window, \
        cfg.learner.n_features
    Bf = L.buffer
    N = ls["buf_n"].shape[0]
    tm = train["mask"].reshape(N, S * Ws)
    rank = torch.cumsum(tm.to(torch.int64), -1) - 1
    pos = torch.where(tm, (ls["buf_n"][:, None] + rank) % Bf, Bf)

    def push(ring, vals):
        # unmasked rows rewrite the dump row with its own value
        if ring.dim() == 3:
            idx = pos[..., None].expand(-1, -1, F)
            keep = tm[..., None]
        else:
            idx, keep = pos, tm
        return ring.scatter(1, idx, torch.where(
            keep, vals, torch.gather(ring, 1, idx)))

    new = dict(ls)
    new["buf_X"] = push(ls["buf_X"], train["feat"].reshape(N, S * Ws, F))
    new["buf_y"] = push(ls["buf_y"], train["label"].reshape(N, S * Ws))
    new["buf_n"] = ls["buf_n"] + tm.sum(-1)
    fit_now = step % L.fit_every == 0
    if fit_now:
        sw = (torch.arange(Bf, device=tm.device)[None, :]
              < new["buf_n"][:, None]).to(torch.float32)
        X, y = new["buf_X"][:, :Bf], new["buf_y"][:, :Bf]
        new["learn"] = linear.fit(ls["learn"], X, y, sw, steps=L.fit_steps,
                                  lr=L.lr, l2=L.l2, fresh_opt=False,
                                  ordered=True)
    if "learn2" in ls:
        new["buf_t"] = push(ls["buf_t"],
                            train["learnable"].reshape(N, S * Ws))
        if fit_now:
            # the tiny head gates every admission, so it is refit from
            # scratch each cadence on the current ring (a replication with
            # an empty ring keeps its head)
            fresh = linear.fit(
                linear.init(2 * F, 2, (N,), tm.device),
                learnability_features(X), new["buf_t"][:, :Bf], sw,
                steps=60, lr=L.lr, l2=L.l2, ordered=True)
            has = new["buf_n"] > 0
            new["learn2"] = linear.LinearLearner(*(
                torch.where(has.reshape((N,) + (1,) * (a.dim() - 1)), a, b)
                for a, b in zip(fresh, ls["learn2"])))
    return new


def _tick_arrivals(cfg: StreamConfig, arr_state, gen, t: float,
                   rate_scale: float, rate_abs=None):
    """One tick's arrivals for every replication: the total ``n_new``
    (n_reps,) and its per-shard split ``n_arr`` (n_reps, n_shards), each
    arrival assigned a uniform shard, the total capped at
    ``max_arrivals_per_tick * n_shards`` (the excess counts as dropped).
    ``rate_abs`` replaces ``arrivals.rate`` (see ``sample_arrivals``)."""
    S = cfg.n_shards
    cap_total = cfg.max_arrivals_per_tick * S
    n_new, arr_state, _ = sample_arrivals(cfg.arrivals, arr_state, gen, t,
                                          cfg.dt, rate_scale, rate_abs)
    dev = n_new.device
    n_cap = torch.clamp(n_new, max=cap_total)
    sid = torch.randint(0, S, (n_new.shape[0], cap_total), generator=gen,
                        device=dev)
    valid = torch.arange(cap_total, device=dev) < n_cap[:, None]
    n_arr = ((sid[..., None] == torch.arange(S, device=dev))
             & valid[..., None]).sum(1)
    return n_new, n_arr, arr_state


def draw_arrivals(cfg: StreamConfig, horizon: int, n_reps: int, *,
                  seed: int = 0, rate_scale: float = 1.0, rate_abs=None,
                  device="cuda"):
    """The arrivals :func:`run_stream` draws for ``seed``, as the
    ``(n_new (horizon, n_reps), n_arr (horizon, n_reps, n_shards))`` pair
    its ``arrivals`` argument takes: the tick draws nothing else from the
    run's generator. ``rate_abs`` (a number) draws them as if
    ``arrivals.rate`` were ``rate_abs``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    state = init_arrival_state(cfg.arrivals, n_reps, dev)
    t = np.float32(0.0)
    news, arrs = [], []
    for _ in range(horizon):
        n_new, n_arr, state = _tick_arrivals(cfg, state, gen, float(t),
                                             rate_scale, rate_abs)
        news.append(n_new)
        arrs.append(n_arr)
        t = np.float32(t + np.float32(cfg.dt))
    return torch.stack(news), torch.stack(arrs)


def draw_init(cfg: StreamConfig, n_reps: int, seed: int = 0, *,
              acc_a: Optional[float] = None, acc_b: Optional[float] = None):
    """The initial state :func:`run_stream` draws for ``seed``, as the
    numpy ``(ws, banks, seeds)`` that :func:`state_from_numpy` takes, with
    leading dims ``(n_reps, n_shards)``. ``acc_a`` / ``acc_b`` (numbers)
    draw the workers' accuracies as if the config's Beta prior had them."""
    if acc_a is not None or acc_b is not None:
        cfg = dataclasses.replace(
            cfg, acc_a=cfg.acc_a if acc_a is None else acc_a,
            acc_b=cfg.acc_b if acc_b is None else acc_b)
    rng = np.random.default_rng(seed)
    ws, banks = _init_shard(cfg, rng, (n_reps, cfg.n_shards))
    seeds = rng.integers(0, 2 ** 32, (n_reps, cfg.n_shards), dtype=np.uint64)
    return ws, banks, seeds



_ACCUM = ("hist", "done", "correct", "sum_tis", "votes_fin", "completions",
          "done_all", "dropped", "model_known")
# the trace's integer per-tick series, in the order the tick stacks them
# (``adm_score``, a float, joins them under ranked admission)
_TRACE_SERIES = ("votes", "busy_workers", "idle_workers", "dropped",
                 "stolen", "donated")


_GROUP_KEYS = ("ws", "banks", "win", "bl", "seeds")


def _to(tree, device):
    """A state part (tensors, dicts of them, learners) on ``device``."""
    return tree_map(lambda x: x.to(device) if torch.is_tensor(x) else x,
                    tree)


def _groups(state: dict):
    """The shard groups of a run or serve state and its mesh. A state of
    one group (:func:`state_from_numpy`) is its own group."""
    if "groups" in state:
        return state["groups"], state["mesh"]
    return [state], StreamMesh((state["seeds"].device,))


def shard_state(cfg: StreamConfig, state: dict, mesh: StreamMesh) -> dict:
    """A one-group run or serve state (:func:`state_from_numpy`,
    :func:`serve_state_from_numpy`) split into the ``mesh.size`` groups of
    ``cfg.n_shards / mesh.size`` shards, group ``g`` on
    ``mesh.devices[g]``: ``{"groups": [...], "mesh": mesh, "learner": ...}``
    and the state's other entries, the learner (one per replication,
    shared by all groups) on ``mesh.devices[0]``. A serve state's bank is
    copied to every group. One group comes back unchanged."""
    if mesh.size == 1:
        return state
    check_stream_sharding(cfg.n_shards, mesh.size)
    n_reps = state["seeds"].shape[0] // cfg.n_shards
    groups = shard_rows({k: state[k] for k in _GROUP_KEYS}, mesh, n_reps)
    if state.get("bank") is not None:
        for grp, b in zip(groups, mesh.replicate(state["bank"])):
            grp["bank"] = b
    rest = {k: v for k, v in state.items() if k not in _GROUP_KEYS}
    return dict(_to(rest, mesh.devices[0]), groups=groups, mesh=mesh)


def gather_state(cfg: StreamConfig, state: dict) -> dict:
    """The inverse of :func:`shard_state`: one group on the first group's
    device, its rows in canonical shard order."""
    if "groups" not in state:
        return state
    groups, mesh = _groups(state)
    n_reps = groups[0]["seeds"].shape[0] * mesh.size // cfg.n_shards
    flat = gather_rows([{k: g[k] for k in _GROUP_KEYS} for g in groups],
                       mesh, n_reps)
    rest = {k: v for k, v in state.items() if k not in ("groups", "mesh")}
    return dict(rest, **flat)


def _run_one(cfg: StreamConfig, horizon: int, state: dict, warmup_t: float,
             rate_scale: float, gen: Optional[torch.Generator],
             arrivals=None, ov: Optional[dict] = None, bank=None):
    """All replications of one run in lock-step: a loop of ``horizon``
    ticks over ``state`` (see :func:`state_from_numpy`; split into device
    groups by :func:`shard_state`). Arrivals are drawn at full width from
    ``gen`` on the first group's device, or taken from ``arrivals = (n_new
    (H, n_reps), n_arr (H, n_reps, n_shards))``, and each group takes its
    shards' columns; ``ov`` holds a sweep's per-row overrides (see
    :func:`_shard_tick`), ``bank`` the embedding bank of LM features
    (copied to every group's device). Every tick advances each group's
    shards on its own device, then the steal and the shared learner read
    the groups' gathered rows. Per-shard accumulators are gathered into
    canonical shard order before the reduction over shards, so the
    reduction and its float summation order are the same at any group
    count. Returns ``(out, state)``; ``out`` holds tensors on the first
    group's device, reduced over shards as in the reference."""
    S, M = cfg.n_shards, cfg.max_arrivals_per_tick
    cap_total = M * S
    groups, mesh = _groups(state)
    groups = [dict(g) for g in groups]
    D = mesh.size
    Sl = S // D
    dev = mesh.devices[0]
    N = groups[0]["seeds"].shape[0] // Sl
    ls = state["learner"]
    steal = cfg.sharding.steal != "none"
    tr = cfg.trace
    tr_ph = tr is not None and tr.phases
    tr_pt = tr is not None and tr.per_tick
    zi = lambda *s, d=dev: torch.zeros(s, dtype=torch.int64, device=d)
    accs = []
    for d in mesh.devices:
        acc = {k: zi(N * Sl, d=d) for k in _ACCUM if k != "hist"}
        acc["hist"] = zi(N * Sl, cfg.tis_bins, d=d)
        acc["sum_tis"] = torch.zeros((N * Sl,), device=d)
        if tr_ph:
            acc["ph"] = zi(N * Sl, len(TRACE_PHASES), cfg.tis_bins, d=d)
            acc["ps"] = torch.zeros((N * Sl, len(TRACE_PHASES)), device=d)
        acc["stolen"], acc["donated"] = zi(N * Sl, d=d), zi(N * Sl, d=d)
        accs.append(acc)
    over, arrived, arrived_warm = zi(N), zi(N), zi(N)
    series = {k: zi(N, horizon)
              for k in ("arrivals", "finalized", "backlog", "in_flight")}
    if tr_pt:
        # the trace's per-tick series: one (N, horizon, 6) buffer written
        # once a tick and split at the end
        tser = zi(N, horizon, len(_TRACE_SERIES))
        adm = torch.zeros((N, horizon), device=dev) \
            if cfg.routing.admission != "fifo" else None
    banks = mesh.replicate(bank) if bank is not None else [None] * D
    ovs = shard_rows(ov, mesh, N) if ov is not None else [None] * D
    arr_state = init_arrival_state(cfg.arrivals, N, dev)
    if arrivals is not None:
        inj_new, inj_arr = (
            a.to(device=dev, dtype=torch.int64) if torch.is_tensor(a)
            else torch.tensor(np.asarray(a), dtype=torch.int64, device=dev)
            for a in arrivals)
        if inj_new.shape != (horizon, N) or inj_arr.shape != (horizon, N, S):
            raise ValueError(
                f"injected arrivals must be ({horizon}, {N}) and ({horizon}, "
                f"{N}, {S}), got {tuple(inj_new.shape)} and "
                f"{tuple(inj_arr.shape)}")
    psum = lambda ms, k: mesh.psum([m[k].reshape(N, Sl).sum(-1) for m in ms])
    t = np.float32(0.0)
    for step in range(horizon):
        with timing.span("tick", dev):
            tf = float(t)
            if arrivals is not None:
                n_new, n_arr = inj_new[step], inj_arr[step]
            else:
                n_new, n_arr, arr_state = _tick_arrivals(
                    cfg, arr_state, gen, tf, rate_scale)
            over = over + torch.clamp(n_arr - M, min=0).sum(-1) \
                + (n_new - torch.clamp(n_new, max=cap_total))
            n_arr = torch.clamp(n_arr, max=M)
            with timing.span("tick.learner_fit", dev):
                lp = _learner_tick_params(cfg, ls, Sl)
            ms, trains = [], []
            for g, grp in enumerate(groups):
                d = mesh.devices[g]
                ws, win, bl, m, train = _shard_tick(
                    cfg, grp["ws"], grp["banks"], grp["win"], grp["bl"],
                    n_arr[:, g * Sl:(g + 1) * Sl].reshape(-1).to(d), tf, step,
                    grp["seeds"], warmup_t, _to(lp, d), ov=ovs[g],
                    bank=banks[g])
                grp.update(ws=ws, win=win, bl=bl)
                ms.append(m)
                trains.append(train)
            if steal:
                bls, gots, gaves = _steal_rebalance(
                    cfg, [grp["bl"] for grp in groups], mesh)
                for grp, acc, b, got, gave in zip(groups, accs, bls, gots,
                                                  gaves):
                    grp["bl"] = b
                    acc["stolen"] = acc["stolen"] + got
                    acc["donated"] = acc["donated"] + gave
            elif tr_pt:
                gots = gaves = [torch.zeros_like(m["dropped"]) for m in ms]
            if ls is not None:
                with timing.span("tick.learner_fit", dev):
                    ls = _learner_push_fit(
                        cfg, ls, gather_rows(trains, mesh, N), step)
            for acc, m in zip(accs, ms):
                for k in _ACCUM + (("ph", "ps") if tr_ph else ()):
                    acc[k] = acc[k] + m[k]
            arrived = arrived + n_new
            if tf >= warmup_t:
                arrived_warm = arrived_warm + n_new
            series["arrivals"][:, step] = n_new
            series["finalized"][:, step] = psum(ms, "done_all")
            series["backlog"][:, step] = psum(ms, "backlog")
            series["in_flight"][:, step] = psum(ms, "in_flight")
            if tr_pt:
                # per-tick activity, summed over each replication's shards
                tser[:, step] = mesh.psum([torch.stack(
                    [m["votes"], m["busy_workers"], m["idle_workers"],
                     m["dropped"], got, gave], -1).reshape(N, Sl, -1).sum(1)
                    for m, got, gave in zip(ms, gots, gaves)])
                if adm is not None:
                    adm[:, step] = gather_rows(
                        [m["adm_score"] for m in ms], mesh, N
                    ).reshape(N, S).sum(-1) / S
            t = np.float32(t + np.float32(cfg.dt))
    for grp, acc in zip(groups, accs):
        acc["cost_wait"] = grp["ws"]["cost_wait"]
        acc["cost_work"] = grp["ws"]["cost_work"]
        acc["n_churned"] = grp["ws"]["n_churned"]
        acc["n_evicted"] = grp["ws"]["n_evicted"]
        acc["backlog_end"] = grp["bl"]["count"]
        acc["in_flight_end"] = grp["win"]["active"].sum(-1)
        acc["stolen"] = acc.pop("stolen")
        acc["donated"] = acc.pop("donated")
    # canonical shard order first, then the one reduction over shards
    local = gather_rows(accs, mesh, N)
    out = {k: v.reshape((N, S) + v.shape[1:]).sum(1) for k, v in local.items()}
    if tr_ph:
        ph, ps = out.pop("ph"), out.pop("ps")
        for i, pk in enumerate(TRACE_PHASES):
            out["ph_" + pk] = ph[:, i].contiguous()
            out["ps_" + pk] = ps[:, i].contiguous()
    if tr_pt:
        for i, k in enumerate(_TRACE_SERIES):
            series[k] = tser[..., i].contiguous()
        if adm is not None:
            series["adm_score"] = adm
    out["dropped"] = out["dropped"] + over
    out["arrived"] = arrived
    out["arrived_warm"] = arrived_warm
    if ls is not None and "learn2" in ls:
        # the learnability head's final parameters (diagnostics)
        out["learn2_W"] = ls["learn2"].W
        out["learn2_b"] = ls["learn2"].b
    out["per_shard"] = {k: local[k].reshape(N, S) for k in
                        ("backlog_end", "in_flight_end", "stolen", "donated")}
    out["series"] = series
    if "groups" in state:
        return out, dict(state, groups=groups, learner=ls)
    return out, dict(groups[0], learner=ls)


def _validate_stream_config(cfg: StreamConfig):
    """The reference's checks, with its messages."""
    L = cfg.learner
    if cfg.serve:
        raise ValueError(
            "StreamConfig.serve=True is the live-injection mode: drive it "
            "one tick at a time via serve_init/serve_tick (repro_torch."
            "serving.server), not through the run_stream* simulators")
    if L.enabled and L.n_features < cfg.n_classes:
        raise ValueError("learner.n_features must be >= n_classes "
                         "(one-hot class means)")
    if L.feature_kind not in ("gaussian", "lm"):
        raise ValueError("learner.feature_kind must be 'gaussian' or 'lm', "
                         f"got {L.feature_kind!r}")
    if L.feature_kind == "lm":
        if not L.enabled:
            raise ValueError(
                "learner.feature_kind='lm' requires learner.enabled: LM "
                "embeddings exist to feed the learner/fusion path")
        if L.embed is None:
            raise ValueError(
                "learner.feature_kind='lm' requires learner.embed (an "
                "EmbedConfig; the scenario layer lowers spec.embed into it)")
        if L.embed.projection_dim is not None \
                and L.embed.projection_dim != L.n_features:
            raise ValueError(
                f"learner.embed.projection_dim={L.embed.projection_dim} "
                f"must equal learner.n_features={L.n_features} (the "
                "projection target IS the learner feature width)")
        if L.embed.bank_size % (2 * cfg.n_classes) != 0:
            raise ValueError(
                f"learner.embed.bank_size={L.embed.bank_size} must be a "
                f"positive multiple of 2 * n_classes = {2 * cfg.n_classes}")
    elif L.embed is not None:
        raise ValueError("learner.embed is set but feature_kind="
                         f"{L.feature_kind!r}; an embedding config without "
                         "the lm feature path is a misconfiguration")
    if cfg.routing.admission not in ("fifo", "uncertain",
                                     "uncertain_learnable"):
        raise ValueError("routing.admission must be 'fifo', 'uncertain' or "
                         "'uncertain_learnable', "
                         f"got {cfg.routing.admission!r}")
    if cfg.routing.admission != "fifo" and not L.enabled:
        raise ValueError(f"routing.admission={cfg.routing.admission!r} "
                         "requires learner.enabled: features are drawn at "
                         "arrival and ranked by the online model")
    sh = cfg.sharding
    if sh.steal not in ("none", "pressure"):
        raise ValueError("sharding.steal must be 'none' or 'pressure', "
                         f"got {sh.steal!r}")
    if sh.steal != "none":
        if cfg.routing.admission != "fifo":
            raise ValueError(
                f"sharding.steal={sh.steal!r} rebalances the FIFO backlog "
                "ring and requires routing.admission='fifo', got "
                f"{cfg.routing.admission!r}")
        if not 1 <= sh.steal_max <= cfg.backlog:
            raise ValueError("sharding.steal_max must be in [1, backlog="
                             f"{cfg.backlog}], got {sh.steal_max}")
        if sh.steal_slack < 0:
            raise ValueError("sharding.steal_slack must be >= 0, got "
                             f"{sh.steal_slack}")
    check_stream_sharding(cfg.n_shards, sh.n_devices)
    if cfg.trace is not None and not isinstance(cfg.trace, TraceConfig):
        raise TypeError("StreamConfig.trace must be None or a TraceConfig "
                        "(repro_torch.obs.trace), got "
                        f"{type(cfg.trace).__name__}")


def _bank_for(cfg: StreamConfig, device="cuda"):
    """The embedding bank's features (2, C, K, F) on ``device`` (the card
    unless told otherwise; raises without one) for ``feature_kind="lm"``,
    built once per config and device (``repro_torch.embed.bank``); None on
    the Gaussian path."""
    L = cfg.learner
    if L.feature_kind != "lm":
        return None
    return embedding_bank(L.embed, cfg.n_classes, L.n_features, L.class_sep,
                          L.hard_sep_scale, device=device).feats


def _check_bank(cfg: StreamConfig, bank, device):
    """An injected bank on ``device`` after checking its layout, else the
    built one (:func:`_bank_for`)."""
    if bank is None:
        return _bank_for(cfg, device)
    L = cfg.learner
    if L.feature_kind != "lm":
        raise ValueError("bank= is only read with learner.feature_kind='lm'")
    bank = (bank if torch.is_tensor(bank) else torch.from_numpy(
        np.array(bank, np.float32))).to(device=device, dtype=torch.float32)
    C, F = cfg.n_classes, L.n_features
    if bank.dim() != 4 or tuple(bank.shape[:2]) != (2, C) \
            or bank.shape[3] != F:
        raise ValueError(f"bank must be (2, {C}, K, {F}), got "
                         f"{tuple(bank.shape)}")
    return bank


def run_stream(cfg: StreamConfig, horizon: int, *, n_reps: int = 1,
               seed: int = 0, warmup_frac: float = 0.3,
               rate_scale: float = 1.0, device="cuda", init=None,
               arrivals=None, bank=None, devices=None):
    """Run ``n_reps`` replications of the streaming service for ``horizon``
    ticks on ``device``. Steady-state metrics only accumulate after
    ``warmup_frac`` of the horizon; ``rate_scale`` multiplies the offered
    arrival rate. Returns a dict of tensors with leading dim ``n_reps``
    plus ``warmup_t``/``measured_s`` floats.

    With ``sharding.n_devices = D > 1`` the shards run as D groups of
    ``n_shards / D``, group ``g`` on device ``g`` of
    :func:`~repro_torch.launch.mesh.make_stream_mesh` (``devices``, a list
    of D devices that may repeat a card, else the first D cards, or D
    groups on the CPU for ``device="cpu"``); the results equal the
    one-group run's bit for bit, and come back on the first group's
    device.

    ``seed`` draws the worker banks and counter seeds (host numpy) and the
    per-tick arrivals (a ``torch.Generator`` on the first group's device),
    each once at full width. For parity tests, ``init`` replaces the first
    with a :func:`state_from_numpy` state (which may carry a trained
    learner) and ``arrivals = (n_new (horizon, n_reps), n_arr (horizon,
    n_reps, n_shards))`` the second; ``n_arr`` are per-shard counts before
    the ``max_arrivals_per_tick`` cap. ``bank`` (LM features) replaces the
    embedding bank the run would build (:func:`_bank_for`) with a (2,
    n_classes, K, n_features) array. With the learner under
    ``uncertain_learnable`` the result also holds the learnability head's
    final ``learn2_W`` / ``learn2_b``.
    """
    _validate_stream_config(cfg)
    mesh = make_stream_mesh(cfg.sharding.n_devices, device, devices)
    dev = mesh.devices[0]
    if init is None:
        init = state_from_numpy(cfg, *draw_init(cfg, n_reps, seed), dev)
    elif init["seeds"].shape[0] != n_reps * cfg.n_shards:
        raise ValueError(f"init holds {init['seeds'].shape[0]} shards, "
                         f"expected n_reps * n_shards = "
                         f"{n_reps * cfg.n_shards}")
    gen = None
    if arrivals is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
    warmup_t = float(warmup_frac * horizon * cfg.dt)
    out, _ = _run_one(cfg, int(horizon), shard_state(cfg, init, mesh),
                      float(np.float32(warmup_t)), float(rate_scale), gen,
                      arrivals, bank=_check_bank(cfg, bank, dev))
    out["warmup_t"] = warmup_t
    out["measured_s"] = horizon * cfg.dt - warmup_t
    return out


def _as_stream_config(cfg) -> StreamConfig:
    """The sweeps accept a StreamConfig or, as in the reference, a
    declarative ScenarioSpec (lowered through ``to_stream_config``)."""
    if isinstance(cfg, StreamConfig):
        return cfg
    from repro_torch.scenarios.compile import to_stream_config
    return to_stream_config(cfg)


def _run_points(cfg: StreamConfig, horizon: int, points: list, *,
                n_reps: int, seed: int, warmup_frac: float, device,
                timing_name: Optional[str] = None, draws=None, bank=None):
    """The batched run behind the sweeps: every point x replication x shard
    is a row of one :func:`_run_one`. ``points`` holds one dict per point:
    ``rate_scale`` and ``rate_abs`` (the arrivals), ``acc_a`` / ``acc_b``
    (the workers' draw; None keeps the config's), and ``cap``, ``p_hard``,
    ``hard_scale`` (the tick's per-row overrides; None keeps the
    config's). Each point's initial state and arrivals are drawn as its
    standalone :func:`run_stream` draws them for ``seed`` (the arrivals from
    a generator of their own, ahead of the loop), so each point's rows run
    as that run does. ``draws`` (for parity tests) gives each point's
    ``(init, arrivals)`` instead: ``init`` the numpy ``(ws, banks, seeds)``
    of :func:`draw_init`, ``arrivals`` the ``(n_new, n_arr)`` of
    :func:`draw_arrivals`. ``timing_name`` records the call's wall time as
    ``<timing_name>.execute`` in :mod:`repro_torch.obs.timing`; ``bank``
    replaces the LM embedding bank (see :func:`run_stream`). Returns the
    outputs with leading dims ``(V, n_reps)``."""
    dev = resolve_device(device)
    V, S = len(points), cfg.n_shards
    t_start = time.perf_counter()
    if draws is not None and len(draws) != V:
        raise ValueError(f"draws holds {len(draws)} points, expected {V}")
    with timing.span("sweep.predraw"):
        inits, arrivals = {}, {}
        parts, news, arrs = [], [], []
        for i, p in enumerate(points):
            ik = (p.get("acc_a"), p.get("acc_b"))
            ak = (p.get("rate_scale", 1.0), p.get("rate_abs"))
            if draws is not None:
                parts.append(draws[i][0])
                n_new, n_arr = (
                    torch.as_tensor(np.asarray(a, np.int64), device=dev)
                    for a in draws[i][1])
            else:
                if ik not in inits:
                    inits[ik] = draw_init(cfg, n_reps, seed, acc_a=ik[0],
                                          acc_b=ik[1])
                parts.append(inits[ik])
                if ak not in arrivals:
                    arrivals[ak] = draw_arrivals(
                        cfg, horizon, n_reps, seed=seed, rate_scale=ak[0],
                        rate_abs=ak[1], device=dev)
                n_new, n_arr = arrivals[ak]
            news.append(n_new)
            arrs.append(n_arr)
        cat = lambda i: {k: np.concatenate([pt[i][k] for pt in parts])
                         for k in parts[0][i]}
        init = state_from_numpy(cfg, cat(0), cat(1),
                                np.concatenate([pt[2] for pt in parts]), dev)
    rows = n_reps * S

    def per_row(key, default, dtype):
        # one (B, 1) tensor for the whole run, built once before the loop;
        # None where no point overrides ``key``
        vals = [p.get(key) for p in points]
        if all(v is None for v in vals):
            return None
        vals = [default if v is None else v for v in vals]
        return torch.tensor(vals, dtype=dtype, device=dev
                            ).repeat_interleave(rows)[:, None]
    ov = dict(cap=per_row("cap", cfg.policy.votes_cap, torch.int64))
    if any(p.get("p_hard") is not None for p in points):
        ov["p_hard"] = per_row("p_hard", cfg.p_hard, torch.float32)
        ov["hard_scale"] = per_row("hard_scale", cfg.hard_scale,
                                   torch.float32)
    warmup_t = float(warmup_frac * horizon * cfg.dt)
    out, _ = _run_one(cfg, int(horizon), init, float(np.float32(warmup_t)),
                      1.0, None, (torch.cat(news, 1), torch.cat(arrs, 1)),
                      ov=ov, bank=_check_bank(cfg, bank, dev))
    out = _split_points(out, V)
    if timing_name is not None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        timing.record(f"{timing_name}.execute",
                      time.perf_counter() - t_start)
    out["warmup_t"] = warmup_t
    out["measured_s"] = horizon * cfg.dt - warmup_t
    return out


def _split_points(out, V: int):
    """Outputs with a leading ``V * n_reps`` dim as ``(V, n_reps, ...)``."""
    if isinstance(out, dict):
        return {k: _split_points(v, V) for k, v in out.items()}
    return out.reshape((V, -1) + tuple(out.shape[1:]))


def run_stream_sweep(cfg, horizon: int, rate_scales, *, n_reps: int = 1,
                     seed: int = 0, warmup_frac: float = 0.3,
                     shard: bool = True, device="cuda", draws=None,
                     bank=None):
    """Load sweep as one batched run: every offered-rate scale x
    replication x shard is a row of one tick loop (the
    ``scenarios.sweep`` backend for the stream engine's arrival-rate
    axis). Point i equals ``run_stream(cfg, horizon, n_reps=n_reps,
    seed=seed, rate_scale=rate_scales[i])``. ``shard`` is accepted for the
    reference's signature: on one device there is nothing to split.
    ``draws`` replaces each point's draws and ``bank`` the LM embedding
    bank (see ``_run_points``). Returns outputs with leading dims
    ``(len(rate_scales), n_reps)``."""
    cfg = _as_stream_config(cfg)
    _validate_stream_config(cfg)
    points = [dict(rate_scale=float(s)) for s in rate_scales]
    return _run_points(cfg, horizon, points, n_reps=n_reps, seed=seed,
                       warmup_frac=warmup_frac, device=device, draws=draws,
                       bank=bank)


def run_stream_votes_sweep(cfg, horizon: int, votes_caps, *, n_reps: int = 1,
                           seed: int = 0, warmup_frac: float = 0.3,
                           rate_scale: float = 1.0, device="cuda",
                           draws=None, bank=None):
    """Votes-cap sweep as one batched run with MASKED caps: the vote
    buffers are sized at ``max(votes_caps)`` and each row's effective cap
    gates vote admission, finalization and the outstanding-vote target.
    Columns past a row's cap are never written or read, so point i equals
    ``run_stream`` with ``policy.votes_cap = votes_caps[i]`` bit for bit.
    ``draws`` replaces each point's draws and ``bank`` the LM embedding
    bank (see ``_run_points``). Returns outputs with leading dims
    ``(len(votes_caps), n_reps)``."""
    cfg = _as_stream_config(cfg)
    caps = [int(v) for v in votes_caps]
    if not caps:
        raise ValueError("votes_caps must be non-empty")
    for v in caps:
        if v < max(1, cfg.policy.min_votes):
            raise ValueError(
                f"votes_cap sweep value {v} must be >= max(1, "
                f"policy.min_votes={cfg.policy.min_votes})")
    cfg = dataclasses.replace(
        cfg, policy=dataclasses.replace(cfg.policy, votes_cap=max(caps)))
    _validate_stream_config(cfg)
    points = [dict(rate_scale=float(rate_scale), cap=c) for c in caps]
    return _run_points(cfg, horizon, points, n_reps=n_reps, seed=seed,
                       warmup_frac=warmup_frac, device=device, draws=draws,
                       bank=bank)


def run_stream_grid(cfg, horizon: int, traced: StreamTraced, *,
                    n_reps: int = 1, seed: int = 0,
                    warmup_frac: float = 0.3, shard: bool = True,
                    timing_name: Optional[str] = None, device="cuda",
                    draws=None, bank=None):
    """Multi-axis grid over a :class:`StreamTraced` bundle as one batched
    run. The leaves share a leading cell axis ``(V,)`` (scalars broadcast);
    each cell runs the service with its absolute overrides of the arrival
    rate, the votes cap (masked, the buffers at the config's
    ``votes_cap``), the Beta accuracy prior and the difficulty mixture, and
    equals ``run_stream`` on the config with those values. Values are read
    as float64 on the host (the draws are host numpy), so a Python float
    reproduces the standalone run at that value. ``shard`` is accepted for
    the reference's signature (one device); ``timing_name`` records
    ``<timing_name>.execute`` in :mod:`repro_torch.obs.timing`; ``draws``
    replaces each cell's draws and ``bank`` the LM embedding bank (see
    ``_run_points``). Returns outputs with leading dims ``(V, n_reps)``."""
    cfg = _as_stream_config(cfg)
    if cfg.sharding.n_devices > 1:
        raise ValueError(
            "run_stream_grid batches grid cells across devices and cannot "
            "also shard_map single runs; use sharding.n_devices=1 (run "
            "device-sharded scenarios per-cell via run_stream)")
    _validate_stream_config(cfg)
    raw = {f: np.asarray(_np(getattr(traced, f)),
                         np.int64 if f == "votes_cap" else np.float64)
           for f in StreamTraced._fields}
    lo = max(1, cfg.policy.min_votes)
    for v in np.atleast_1d(raw["votes_cap"]):
        if v != 0 and not lo <= int(v) <= cfg.policy.votes_cap:
            raise ValueError(
                f"grid votes_cap value {int(v)} must be 0 (unset) or in "
                f"[max(1, policy.min_votes)={lo}, "
                f"policy.votes_cap={cfg.policy.votes_cap}]")
    for v in np.atleast_1d(raw["p_hard"]):
        if v > 1.0:
            raise ValueError(
                f"grid p_hard value {float(v)} must be negative (unset) "
                "or in [0, 1]")
    V = max([a.shape[0] for a in raw.values() if a.ndim > 0] or [1])
    lv = {f: np.broadcast_to(a, (V,)) for f, a in raw.items()}
    points = []
    for i in range(V):
        pos = lambda f, d: float(lv[f][i]) if lv[f][i] > 0 else d
        nonneg = lambda f, d: float(lv[f][i]) if lv[f][i] >= 0 else d
        points.append(dict(
            rate_abs=pos("rate", None),
            cap=int(lv["votes_cap"][i]) if lv["votes_cap"][i] > 0
            else cfg.policy.votes_cap,
            acc_a=pos("acc_a", None), acc_b=pos("acc_b", None),
            p_hard=nonneg("p_hard", cfg.p_hard),
            hard_scale=nonneg("hard_scale", cfg.hard_scale)))
    return _run_points(cfg, horizon, points, n_reps=n_reps, seed=seed,
                       warmup_frac=warmup_frac, device=device,
                       timing_name=timing_name, draws=draws, bank=bank)


def _hist_percentile(hist, q, bin_s):
    """Right-edge percentile from the pooled time-in-system histogram.

    A percentile landing in the clipped top bin is unbounded above and
    reports ``inf``; so does an empty histogram (no task finalized in the
    measured interval), never NaN."""
    hist = np.asarray(hist)
    if hist.size == 0:
        return float("inf")
    c = np.cumsum(hist)
    if c[-1] == 0:
        return float("inf")
    idx = int(np.searchsorted(c, q / 100.0 * c[-1]))
    if idx >= len(hist) - 1:
        return float("inf")
    return (idx + 1) * bin_s


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def stream_summary(cfg: StreamConfig, out) -> dict:
    """Reduce :func:`run_stream` output to the service-level quantities:
    offered vs sustained steady-state rate, p50/p95/p99 time-in-system,
    label accuracy, votes per finalized task, drops, cost; with trace
    phases also ``phases``, each phase's mean, p50, p95 and saturation."""
    reps = int(_np(out["done"]).shape[0])
    dur = float(out["measured_s"]) * reps
    hist = _np(out["hist"]).sum(0)
    done = float(_np(out["done"]).sum())
    offered = float(_np(out["arrived_warm"]).sum())
    # tasks still in the pipe at horizon end had no chance to finalize;
    # the credit is capped at a couple of windows' worth per replication so
    # an overloaded run cannot report itself stable
    pipe_cap = 2.0 * cfg.n_shards * cfg.window * reps
    holdover = min(float(_np(out["in_flight_end"]).sum()
                         + _np(out["backlog_end"]).sum()), pipe_cap)
    s = dict(
        n_reps=reps,
        offered_rate=offered / max(dur, 1e-9),
        sustained_rate=done / max(dur, 1e-9),
        completion_ratio=done / max(offered - holdover, 1.0),
        p50_tis=_hist_percentile(hist, 50, cfg.tis_bin_s),
        p95_tis=_hist_percentile(hist, 95, cfg.tis_bin_s),
        p99_tis=_hist_percentile(hist, 99, cfg.tis_bin_s),
        mean_tis=float(_np(out["sum_tis"]).sum()) / max(done, 1.0),
        accuracy=float(_np(out["correct"]).sum()) / max(done, 1.0),
        votes_per_task=float(_np(out["votes_fin"]).sum()) / max(done, 1.0),
        completions_per_task=float(_np(out["completions"]).sum())
        / max(done, 1.0),
        model_known_frac=float(_np(out["model_known"]).sum())
        / max(done, 1.0),
        dropped=float(_np(out["dropped"]).sum()),
        backlog_end=float(_np(out["backlog_end"]).sum()) / reps,
        in_flight_end=float(_np(out["in_flight_end"]).sum()) / reps,
        cost=float((_np(out["cost_wait"]) + _np(out["cost_work"])).sum())
        / reps,
        hist_saturated=bool(hist.size and hist[-1] > 0),
    )
    if "ph_backlog_wait" in out:
        # the latency-source breakdown (trace phases): where time in
        # system goes
        phases = {}
        for pk in TRACE_PHASES:
            ph = _np(out["ph_" + pk])
            ph = ph.reshape(-1, ph.shape[-1]).sum(0)
            phases[pk] = dict(
                mean=float(_np(out["ps_" + pk]).sum()) / max(done, 1.0),
                p50=_hist_percentile(ph, 50, cfg.tis_bin_s),
                p95=_hist_percentile(ph, 95, cfg.tis_bin_s),
                hist_saturated=bool(ph.size and ph[-1] > 0))
        s["phases"] = phases
    return s


# --------------------------------------------------------------------------
# live serving: single-tick stepping with injected arrivals
# --------------------------------------------------------------------------
#
# ``repro_torch.serving.server`` drives the router ONE tick at a time:
# pending HTTP submissions are micro-batched into per-shard injected
# arrival counts (``StreamConfig.serve`` replaces the sampled arrival
# process with exact counts and threads a request uid through backlog,
# window slot and steal), the state stays on the device between ticks, and
# the tick's small ``srv_*`` outputs leave it in one copy
# (:func:`serve_out_numpy`).

def _as_serve_config(cfg) -> StreamConfig:
    """Accept a serve-mode StreamConfig or a declarative ScenarioSpec
    (lowered through ``to_serve_config``, which sets ``serve=True``)."""
    if isinstance(cfg, StreamConfig):
        return cfg
    from repro_torch.scenarios.compile import to_serve_config
    return to_serve_config(cfg)


def _validate_serve_config(cfg: StreamConfig):
    _validate_stream_config(dataclasses.replace(cfg, serve=False))
    if not cfg.serve:
        raise ValueError(
            "serve_init/serve_tick require StreamConfig.serve=True "
            "(compile the scenario through "
            "repro_torch.scenarios.compile.to_serve_config)")


def serve_state_from_numpy(cfg, state: dict, device="cuda",
                           bank=None, devices=None) -> dict:
    """The port's serve state from a serve state given as numpy arrays
    (the reference's ``serve_init`` state, say): ``t``, ``step``, the
    per-shard ``seeds`` (S,) and worker state ``ws`` and ``banks`` (leading
    dim S), and with the learner ``learn`` (the seven ``LinearLearner``
    leaves), ``buf_X``, ``buf_y``, ``buf_n`` (and under
    ``uncertain_learnable`` ``learn2`` and ``buf_t``). Window and backlog
    start empty. With LM features the state holds the embedding bank:
    ``bank`` (2, C, K, F) if given, else the one :func:`_bank_for`
    builds. A sharded config's state is split into its device groups as
    :func:`serve_init` splits it (``device`` / ``devices`` as there)."""
    cfg = _as_serve_config(cfg)
    _validate_serve_config(cfg)
    mesh = make_stream_mesh(cfg.sharding.n_devices, device, devices)
    device = mesh.devices[0]
    lead = lambda d: {k: np.asarray(v)[None] for k, v in d.items()}
    learner = None
    if cfg.learner.enabled:
        learner = {k: ([np.asarray(a)[None] for a in state[k]]
                       if k in ("learn", "learn2") else
                       np.asarray(state[k])[None])
                   for k in ("learn", "buf_X", "buf_y", "buf_n", "learn2",
                             "buf_t") if k in state}
    st = state_from_numpy(cfg, lead(state["ws"]), lead(state["banks"]),
                          np.asarray(state["seeds"])[None], device,
                          learner=learner)
    return shard_state(cfg, dict(
        st, t=np.float32(state["t"]), step=int(state["step"]),
        bank=_check_bank(cfg, bank, device)), mesh)


def serve_init(cfg, seed: int = 0, device="cuda", bank=None,
               devices=None) -> dict:
    """The state :func:`serve_tick` advances, on ``device``.

    ``cfg`` is a StreamConfig with ``serve=True`` (or a ScenarioSpec,
    lowered by ``to_serve_config``). ``seed`` fixes the worker pools and
    the counter seeds (a numpy generator, as :func:`draw_init` for one
    replication) and through them every per-tick draw, so the label stream
    of a given injection schedule is deterministic. With LM features the
    state holds the embedding bank the ticks gather from: ``bank`` (2, C,
    K, F) if given, else the one :func:`_bank_for` builds on ``device``.
    Returns a dict of tensors plus the host clock ``t`` and tick index
    ``step``.

    With ``sharding.n_devices = D > 1`` the state is D groups of
    ``n_shards / D`` shards (:func:`shard_state`), group ``g`` on device
    ``g`` of :func:`~repro_torch.launch.mesh.make_stream_mesh` (``devices``,
    else the first D cards, or the CPU for ``device="cpu"``); the learner
    and the outputs live on the first group's device, the bank is built
    once and copied to each group. The pools and seeds are drawn at full
    width and split, so every D serves the same label stream."""
    cfg = _as_serve_config(cfg)
    _validate_serve_config(cfg)
    mesh = make_stream_mesh(cfg.sharding.n_devices, device, devices)
    dev = mesh.devices[0]
    st = state_from_numpy(cfg, *draw_init(cfg, 1, seed), dev)
    return shard_state(cfg, dict(st, t=np.float32(0.0), step=0,
                                 bank=_check_bank(cfg, bank, dev)), mesh)


_SRV_SLOT = ("fin", "uid", "label", "votes")        # (S, window) integers
_SRV_FLOAT = ("conf", "tis")                        # (S, window) float32
_SRV_SHARD = ("dropped", "backlog", "in_flight", "stolen", "donated")


def serve_tick(cfg, state: dict, n_arr, uid_base, feat=None, labels=None):
    """Advance the live service by ONE tick with injected arrivals.

    ``n_arr[s]`` (host integers, 0 <= n <= ``cfg.max_arrivals_per_tick``)
    tasks enter shard ``s`` this tick carrying uids ``uid_base[s] ..
    uid_base[s] + n_arr[s] - 1`` (the caller's per-shard monotonic
    counters); both reach the device in one copy. Injections beyond free
    backlog capacity are dropped from the TAIL of this tick's batch:
    ``out["dropped"][s]`` counts them. ``state`` is not modified; keep the
    returned state. Returns ``(state, out)``: ``out["fin"]`` masks the
    window slots finalized this tick and ``uid`` / ``label`` / ``votes`` /
    ``conf`` / ``tis`` give their request uid, fused label, vote count,
    posterior confidence and time in system (S, window); ``dropped``,
    ``backlog``, ``in_flight``, ``stolen``, ``donated`` are per shard (S,),
    all tensors on the state's (first group's) device; ``t`` is the
    post-tick clock (a host float). A sharded state (:func:`serve_init`
    with ``sharding.n_devices > 1``) advances each device group's shards
    on its device; the steal and the shared learner read the groups'
    gathered rows, and the outputs come back gathered in shard order.

    With LM features (``learner.feature_kind="lm"``) ``feat`` is an
    optional (S, max_arrivals_per_tick, n_features) float array of
    injected real-text embeddings and ``labels`` an optional (S,
    max_arrivals_per_tick) int array of known labels, aligned with the uid
    order; NaN feature rows and -1 labels mean "draw from the embedding
    bank". Both must be None for Gaussian features."""
    cfg = _as_serve_config(cfg)
    S, M = cfg.n_shards, cfg.max_arrivals_per_tick
    lm = cfg.learner.feature_kind == "lm"
    if lm:
        F = cfg.learner.n_features
        if (feat is not None and np.shape(feat) != (S, M, F)) \
                or (labels is not None and np.shape(labels) != (S, M)):
            raise ValueError(
                f"serve_tick lm injections must be feat ({S}, {M}, {F}) "
                f"and labels ({S}, {M}); got {np.shape(feat)} / "
                f"{np.shape(labels)}")
    elif feat is not None or labels is not None:
        raise ValueError(
            "serve_tick feat/labels injections require learner."
            "feature_kind='lm' (Gaussian tasks draw identity in the tick)")
    rows = [np.asarray(n_arr, np.int64).reshape(-1),
            np.asarray(uid_base, np.int64).reshape(-1)]
    if rows[0].shape != (S,) or rows[1].shape != (S,):
        raise ValueError(f"n_arr and uid_base must be ({S},), got "
                         f"{np.shape(n_arr)} / {np.shape(uid_base)}")
    if (rows[0] < 0).any() or (rows[0] > M).any():
        raise ValueError(f"n_arr must be in [0, max_arrivals_per_tick={M}], "
                         f"got {rows[0].tolist()}")
    if lm and labels is not None:
        rows.append(np.asarray(labels, np.int64).T)    # one copy with n_arr
    groups, mesh = _groups(state)
    D = mesh.size
    Sl = S // D
    dev = mesh.devices[0]
    inj = torch.as_tensor(np.concatenate([r.reshape(-1, S) for r in rows]),
                          device=dev)
    feat_t = (torch.as_tensor(np.asarray(feat, np.float32), device=dev)
              if lm and feat is not None else None)
    t, step, ls = state["t"], state["step"], state["learner"]
    lp = _learner_tick_params(cfg, ls, Sl)
    groups = [dict(g) for g in groups]
    ms, trains = [], []
    for g, grp in enumerate(groups):
        d = mesh.devices[g]
        cols = slice(g * Sl, (g + 1) * Sl)
        inj_g = inj[:, cols].to(d)
        kw = {}
        if lm:
            bank = grp.get("bank")
            # a missing ``feat`` / ``labels`` is all NaN / all -1: nothing
            # to override, so nothing is sent
            kw = dict(
                bank=_bank_for(cfg, d) if bank is None else bank,
                labels_in=inj_g[2:].T if labels is not None else None,
                feat_in=feat_t[cols].to(d) if feat_t is not None else None)
        ws, win, bl, m, train = _shard_tick(
            cfg, grp["ws"], grp["banks"], grp["win"], grp["bl"], inj_g[0],
            float(t), step, grp["seeds"], 0.0, _to(lp, d),
            uid_base=inj_g[1], **kw)
        grp.update(ws=ws, win=win, bl=bl)
        ms.append(m)
        trains.append(train)
    if cfg.sharding.steal != "none":
        bls, got, gave = _steal_rebalance(
            cfg, [grp["bl"] for grp in groups], mesh)
        for grp, b in zip(groups, bls):
            grp["bl"] = b
    else:
        got = gave = [torch.zeros_like(m["dropped"]) for m in ms]
    if ls is not None:
        ls = _learner_push_fit(cfg, ls, gather_rows(trains, mesh, 1), step)
    t_new = np.float32(t + np.float32(cfg.dt))
    if "groups" in state:
        new = dict(state, groups=groups)
    else:
        new = dict(groups[0])
    new.update(learner=ls, t=t_new, step=step + 1)
    gat = lambda xs: gather_rows(xs, mesh, 1)
    out = {k: gat([m["srv_" + k] for m in ms])
           for k in _SRV_SLOT + _SRV_FLOAT}
    out.update(dropped=gat([m["dropped"] for m in ms]),
               backlog=gat([grp["bl"]["count"] for grp in groups]),
               in_flight=gat([grp["win"]["active"].sum(-1)
                              for grp in groups]),
               stolen=gat(got), donated=gat(gave), t=float(t_new))
    return new, out


def serve_out_numpy(out: dict) -> dict:
    """:func:`serve_tick`'s outputs as numpy arrays, in one device-to-host
    copy: every tensor is packed into one int64 buffer on the device first
    (the float32 ones by their bits), so the host reads back exactly what
    the device computed. ``t`` passes through."""
    S, Ws = out["fin"].shape
    parts = [out[k].to(torch.int64).reshape(-1) for k in _SRV_SLOT]
    parts += [out[k].view(torch.int32).to(torch.int64).reshape(-1)
              for k in _SRV_FLOAT]
    parts += [out[k].to(torch.int64) for k in _SRV_SHARD]
    buf = torch.cat(parts).cpu().numpy()
    host, i = {}, 0
    for k in _SRV_SLOT + _SRV_FLOAT + _SRV_SHARD:
        n = S if k in _SRV_SHARD else S * Ws
        v = buf[i:i + n]
        i += n
        if k in _SRV_FLOAT:
            v = v.astype(np.int32).view(np.float32)
        host[k] = v.reshape((S,) if k in _SRV_SHARD else (S, Ws))
    host["fin"] = host["fin"].astype(bool)
    host["t"] = out["t"]
    return host
