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

Not yet ported (the config validator refuses them): LM task features,
device sharding and trace buffers.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

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
from repro_torch.learning import linear
from repro_torch.learning.linear import ordered_matmul


@dataclasses.dataclass(frozen=True)
class StreamLearnerConfig:
    """Streaming hybrid learning knobs; fields and defaults as in the
    reference. ``feature_kind="lm"`` (LM embeddings from a bank) is not
    ported yet."""
    enabled: bool = False
    n_features: int = 8
    class_sep: float = 1.8
    hard_sep_scale: float = 1.0
    feature_kind: str = "gaussian"
    embed: Optional[object] = None   # an EmbedConfig in the reference; None
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
    """Device topology for the streaming tick. ``steal="pressure"`` runs on
    one device; ``n_devices > 1`` is not ported yet."""
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
    trace: Optional[object] = None   # a TraceConfig in the reference; None

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
    return bl


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


def _admit_fifo(cfg: StreamConfig, bl, n_arr, free, frank, gate, t, step,
                seed, uid_base=None):
    """FIFO ring push of this tick's arrivals and admission of the oldest
    into the free window slots; task identity (difficulty, label, features)
    is drawn at admission. In serve mode the arrivals carry the uids
    ``uid_base + i`` through the backlog's uid ring. Returns ``(bl,
    dropped, admit, arr_t, diff, tl, featw, uid_w)``; ``featw`` is None
    without the learner, ``uid_w`` (the admitted uids) outside serve
    mode."""
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
    # fresh-task draws at ADMISSION (difficulty mixture + label)
    uw = _uniform_block(seed ^ 0x33CC33CC, step, 2 * Ws).reshape(B, 2, Ws)
    diff = torch.where(uw[:, 0] < cfg.p_hard, cfg.hard_scale, 1.0)
    tl = torch.clamp(torch.floor(uw[:, 1] * C).to(torch.int64), 0, C - 1)
    featw = None
    if L.enabled:
        F = L.n_features
        uf = _uniform_block(seed ^ 0x5EEDF00D, step, 2 * Ws * F
                            ).reshape(B, 2, Ws, F)
        featw = _task_features(uf[:, 0], uf[:, 1], tl, diff, L, C)
    return bl_new, dropped, admit, arr_t, diff, tl, featw, uid_w


def _admit_ranked(cfg: StreamConfig, bl, n_arr, free, frank, gate, t, step,
                  seed, lp, uid_base=None):
    """Learner-driven admission: this tick's arrivals draw their identity
    (difficulty, label, features) now and take the free slots of the
    slot-array backlog (the i-th arrival the i-th free slot); queued tasks
    enter the window most uncertain first under the current model (times
    the learnability head's estimate under ``uncertain_learnable``), ties
    in slot order. Serve mode's uids take the arrivals' backlog slots.
    Returns what :func:`_admit_fifo` does."""
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
    diff_a = torch.where(ua[:, 0] < cfg.p_hard, cfg.hard_scale, 1.0)
    tl_a = torch.clamp(torch.floor(ua[:, 1] * C).to(torch.int64), 0, C - 1)
    feat_a = _task_features(ua[:, 2:2 + F].transpose(1, 2),
                            ua[:, 2 + F:].transpose(1, 2), tl_a, diff_a, L, C)
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
    return bl_new, dropped, admit, arr_t, diff, tl, featw, uid_w


def _shard_tick(cfg: StreamConfig, ws, banks, win, bl, n_arr, t: float,
                step: int, seed, warmup_t: float, lp: Optional[dict] = None,
                uid_base=None):
    """Advance every shard by one tick. ``n_arr`` (B,) are this tick's
    arrivals per shard, ``t`` the tick's time and ``step`` its index (host
    numbers), ``seed`` (B,) the counter seeds, ``lp`` the learner's
    parameters expanded to B (:func:`_learner_tick_params`; None without a
    learner), ``uid_base`` (B,) the first uid of each shard's arrivals in
    serve mode. Returns ``(ws, win, bl, metrics, train)``; ``train`` holds
    the finalized examples for the learner's ring (None without one); in
    serve mode ``metrics`` also holds the per-slot ``srv_*`` outputs."""
    P, Ws, C = cfg.pool_size, cfg.window, cfg.n_classes
    cap = cfg.policy.votes_cap
    pol, fast, L, R = cfg.policy, cfg.fast, cfg.learner, cfg.routing
    dev = seed.device
    B = seed.shape[0]
    up = _uniform_block(seed, step, 8 * P).reshape(B, 8, P)

    # ---- backlog push + admission into free window slots -----------------
    free = ~win["active"]
    if cfg.batch_replay:
        # naive fixed-batch replay: refill only once the window is drained
        gate = free.all(-1)
    else:
        gate = torch.ones((B,), dtype=torch.bool, device=dev)
    frank = torch.cumsum(free.to(torch.int64), -1) - 1
    if R.admission != "fifo":
        bl, dropped, admit, arr_t, diff, tl, featw, uid_w = _admit_ranked(
            cfg, bl, n_arr, free, frank, gate, t, step, seed, lp, uid_base)
    else:
        bl, dropped, admit, arr_t, diff, tl, featw, uid_w = _admit_fifo(
            cfg, bl, n_arr, free, frank, gate, t, step, seed, uid_base)
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

    # ---- completions -> votes -> online posterior -----------------------
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
    keep = comp & (vpos < cap)
    tid_k = torch.where(keep, tid, Ws)
    vpos_k = torch.clamp(torch.where(keep, vpos, 0), 0, cap - 1)
    lin = tid_k * cap + vpos_k                  # kept (task, slot) are unique
    flat_w = win["vote_wid"].reshape(B, -1)
    flat_l = win["vote_lab"].reshape(B, -1)
    win["vote_wid"] = flat_w.scatter(
        1, lin, torch.where(keep, pr, torch.gather(flat_w, 1, lin))
    ).reshape(B, Ws + 1, cap)
    win["vote_lab"] = flat_l.scatter(
        1, lin, torch.where(keep, label, torch.gather(flat_l, 1, lin))
    ).reshape(B, Ws + 1, cap)
    # online DS E-step: add the voter's estimated log-odds to the voted class
    a_e = _acc_hat(cfg, ws)
    delta = torch.log(a_e * max(C - 1, 1) / (1.0 - a_e))
    lp_all = torch.cat([win["logpost"],
                        torch.zeros((B, 1, C), device=dev)], 1).reshape(B, -1)
    win["logpost"] = _add_at(lp_all, tid_k * C + label,
                             torch.where(keep, delta, 0.0)
                             ).reshape(B, Ws + 1, C)[:, :Ws]
    win["n_votes"] = win["n_votes"] + _count_rows(
        Ws + 1, torch.where(keep, tid_k, Ws))[:, :Ws]

    # ---- periodic offline full-confusion Dawid-Skene refresh ------------
    # every refresh_every ticks, re-run the exact batched EM on the
    # window's vote log and reset the online posteriors and worker-accuracy
    # estimates from it; one E-step launch per iteration for all shards
    if cfg.refresh_every > 0 \
            and step % cfg.refresh_every == cfg.refresh_every - 1:
        vmask_r = (torch.arange(cap, device=dev)[None, None, :]
                   < win["n_votes"][..., None]) & win["active"][..., None]
        em = _ds_em(win["vote_lab"][:, :Ws], win["vote_wid"][:, :Ws],
                    vmask_r, P + 1, C, cfg.refresh_iters, False)
        vpw = em["votes_per_worker"][:, :P]
        win["logpost"] = torch.where(
            (win["active"] & (win["n_votes"] > 0))[..., None],
            em["log_posterior"], win["logpost"])
        ws["est_correct"] = em["accuracy"][:, :P] * vpw
        ws["est_n"] = vpw

    # ---- learner fusion (product of experts) ----------------------------
    # the policy reads the crowd posterior fused with the learner's: tasks
    # the model already knows finalize after min_votes_known crowd votes
    if L.enabled:
        model_lg = ordered_matmul(win["feat"], lp["lW"]) + lp["lb"][:, None]
        fused = fuse_posteriors(win["logpost"],
                                torch.log_softmax(model_lg, dim=-1),
                                lp["fuse_w"][:, None, None])
        known, known_fin = learner_known(
            fused, win["n_votes"], threshold=L.known_threshold,
            min_votes_known=L.min_votes_known)
    else:
        fused = win["logpost"]

    # ---- finalization (adaptive redundancy) -----------------------------
    fin, conf = should_finalize(fused, win["n_votes"], pol)
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
    # credit voters of finalized tasks by agreement with the final label
    # (incremental hard-EM M-step for the online accuracy estimates)
    vmask = (torch.arange(cap, device=dev)[None, None, :]
             < win["n_votes"][..., None]) & fin[..., None]
    vw = torch.where(vmask, win["vote_wid"][:, :Ws], P).reshape(B, -1)
    agree = ((win["vote_lab"][:, :Ws] == result[..., None])
             & vmask).reshape(B, -1)
    n_agree = torch.zeros((B, P + 1), dtype=torch.int64, device=dev
                          ).scatter_add_(1, vw, agree.to(torch.int64))
    ws["est_correct"] = ws["est_correct"] + n_agree[:, :P].to(torch.float32)
    ws["est_n"] = ws["est_n"] + _count_rows(P + 1, vw)[:, :P].to(
        torch.float32)
    win["active"] = win["active"] & ~fin

    # ---- worker bookkeeping: completers + straggler losers --------------
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
    avail = (ws["assigned"] < 0) & (ws["blocked_until"] <= t) \
        & (ws["session_end"] > t)
    n_asg = _count_rows(Ws + 1, torch.where(ws["assigned"] >= 0,
                                            ws["assigned"], Ws))[:, :Ws]
    want = target_outstanding(win["n_votes"], pol)
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
            avail, torch.gather(tier1, 1, perm), torch.gather(tier2, 1, perm),
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
# cross-shard work stealing (one device)
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


def _steal_rebalance(cfg: StreamConfig, bl):
    """Move backlog work from hot shards to starved ones of the same
    replication (FIFO ring). Donors pop their OLDEST entries (arrival times
    are task identity under FIFO admission), the donations are pooled per
    replication in donation-rank order, and receivers append their claimed
    ranks at the tail: the replication's backlog multiset is unchanged. In
    serve mode the uid ring moves by the same plan. Returns ``(bl,
    received, donated)``, the counts (B,)."""
    sh = cfg.sharding
    S, Q, K = cfg.n_shards, cfg.backlog, sh.steal_max
    B = bl["count"].shape[0]
    N, dev = B // S, bl["count"].device
    counts = bl["count"].reshape(N, S)
    head = bl["head"].reshape(N, S)
    give, take = _steal_plan(counts, K, sh.steal_slack)
    gcum = torch.cumsum(give, -1) - give                    # donation ranks
    tcum = torch.cumsum(take, -1) - take                    # claim ranks
    k = torch.arange(K, device=dev)
    # donors pop their oldest entries off the ring head
    pos = (head[..., None] + k) % Q                         # (N, S, K)
    head = (head + give) % Q
    count = counts - give
    validd = k < give[..., None]
    ranks = torch.where(validd, gcum[..., None] + k, S * K).reshape(N, -1)
    # receivers claim consecutive ranks and append at their tail
    validc = k < take[..., None]
    claim = torch.where(validc, tcum[..., None] + k, 0).reshape(N, -1)
    posr = torch.where(validc, (head[..., None] + count[..., None] + k) % Q,
                       Q)

    def move(ring, fill):
        # the donations pooled in rank order (the dump entry S*K and the
        # ring's dump slot Q only ever take ``fill``)
        ring = ring.reshape(N, S, Q + 1)
        don = torch.gather(ring, 2, pos)
        pool = torch.full((N, S * K + 1), fill, dtype=ring.dtype,
                          device=dev).scatter(
            1, ranks, torch.where(validd, don, fill).reshape(N, -1)
        )[:, :S * K]
        incoming = torch.gather(pool, 1, claim).reshape(N, S, K)
        return ring.scatter(2, posr, torch.where(validc, incoming, fill)
                            ).reshape(B, Q + 1)

    new = dict(times=move(bl["times"], 0.0), head=head.reshape(B),
               count=(count + take).reshape(B))
    if "uid" in bl:
        new["uid"] = move(bl["uid"], -1)
    return new, take.reshape(B), give.reshape(B)


# --------------------------------------------------------------------------
# driver
# --------------------------------------------------------------------------

def _learner_tick_params(cfg: StreamConfig, ls):
    """The tick's learner parameters, each replication's expanded to its
    shards (B): the learner's ``lW``/``lb``, the fusion weight ``fuse_w``
    (ramping with the ring's fill so an untrained model contributes
    nothing), and under ``uncertain_learnable`` the learnability head's
    ``gW``/``gb``. None without a learner."""
    if ls is None:
        return None
    L, S = cfg.learner, cfg.n_shards
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
                   rate_scale: float):
    """One tick's arrivals for every replication: the total ``n_new``
    (n_reps,) and its per-shard split ``n_arr`` (n_reps, n_shards), each
    arrival assigned a uniform shard, the total capped at
    ``max_arrivals_per_tick * n_shards`` (the excess counts as dropped)."""
    S = cfg.n_shards
    cap_total = cfg.max_arrivals_per_tick * S
    n_new, arr_state, _ = sample_arrivals(cfg.arrivals, arr_state, gen, t,
                                          cfg.dt, rate_scale)
    dev = n_new.device
    n_cap = torch.clamp(n_new, max=cap_total)
    sid = torch.randint(0, S, (n_new.shape[0], cap_total), generator=gen,
                        device=dev)
    valid = torch.arange(cap_total, device=dev) < n_cap[:, None]
    n_arr = ((sid[..., None] == torch.arange(S, device=dev))
             & valid[..., None]).sum(1)
    return n_new, n_arr, arr_state


def draw_arrivals(cfg: StreamConfig, horizon: int, n_reps: int, *,
                  seed: int = 0, rate_scale: float = 1.0, device="cuda"):
    """The arrivals :func:`run_stream` draws for ``seed``, as the
    ``(n_new (horizon, n_reps), n_arr (horizon, n_reps, n_shards))`` pair
    its ``arrivals`` argument takes: the tick draws nothing else from the
    run's generator."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    state = init_arrival_state(cfg.arrivals, n_reps, dev)
    t = np.float32(0.0)
    news, arrs = [], []
    for _ in range(horizon):
        n_new, n_arr, state = _tick_arrivals(cfg, state, gen, float(t),
                                             rate_scale)
        news.append(n_new)
        arrs.append(n_arr)
        t = np.float32(t + np.float32(cfg.dt))
    return torch.stack(news), torch.stack(arrs)


def draw_init(cfg: StreamConfig, n_reps: int, seed: int = 0):
    """The initial state :func:`run_stream` draws for ``seed``, as the
    numpy ``(ws, banks, seeds)`` that :func:`state_from_numpy` takes, with
    leading dims ``(n_reps, n_shards)``."""
    rng = np.random.default_rng(seed)
    ws, banks = _init_shard(cfg, rng, (n_reps, cfg.n_shards))
    seeds = rng.integers(0, 2 ** 32, (n_reps, cfg.n_shards), dtype=np.uint64)
    return ws, banks, seeds



_ACCUM = ("hist", "done", "correct", "sum_tis", "votes_fin", "completions",
          "done_all", "dropped", "model_known")


def _run_one(cfg: StreamConfig, horizon: int, state: dict, warmup_t: float,
             rate_scale: float, gen: Optional[torch.Generator],
             arrivals=None):
    """All replications of one run in lock-step: a loop of ``horizon``
    ticks over ``state`` (see :func:`state_from_numpy`). Arrivals are drawn
    from ``gen`` or taken from ``arrivals = (n_new (H, n_reps), n_arr (H,
    n_reps, n_shards))``. Returns ``(out, state)``; ``out`` holds tensors
    on the state's device, reduced over shards as in the reference."""
    S, M = cfg.n_shards, cfg.max_arrivals_per_tick
    cap_total = M * S
    seeds = state["seeds"]
    dev = seeds.device
    B = seeds.shape[0]
    N = B // S
    ws, banks, win, bl = state["ws"], state["banks"], state["win"], state["bl"]
    ls = state["learner"]
    steal = cfg.sharding.steal != "none"
    zi = lambda *s: torch.zeros(s, dtype=torch.int64, device=dev)
    acc = {k: zi(B) for k in _ACCUM if k != "hist"}
    acc["hist"] = zi(B, cfg.tis_bins)
    acc["sum_tis"] = torch.zeros((B,), device=dev)
    stolen, donated = zi(B), zi(B)
    over, arrived, arrived_warm = zi(N), zi(N), zi(N)
    series = {k: zi(N, horizon)
              for k in ("arrivals", "finalized", "backlog", "in_flight")}
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
    t = np.float32(0.0)
    for step in range(horizon):
        tf = float(t)
        if arrivals is not None:
            n_new, n_arr = inj_new[step], inj_arr[step]
        else:
            n_new, n_arr, arr_state = _tick_arrivals(cfg, arr_state, gen, tf,
                                                     rate_scale)
        over = over + torch.clamp(n_arr - M, min=0).sum(-1) \
            + (n_new - torch.clamp(n_new, max=cap_total))
        n_arr = torch.clamp(n_arr, max=M).reshape(B)
        ws, win, bl, m, train = _shard_tick(
            cfg, ws, banks, win, bl, n_arr, tf, step, seeds, warmup_t,
            _learner_tick_params(cfg, ls))
        if steal:
            bl, got, gave = _steal_rebalance(cfg, bl)
            stolen = stolen + got
            donated = donated + gave
        if ls is not None:
            ls = _learner_push_fit(cfg, ls, train, step)
        for k in _ACCUM:
            acc[k] = acc[k] + m[k]
        arrived = arrived + n_new
        if tf >= warmup_t:
            arrived_warm = arrived_warm + n_new
        series["arrivals"][:, step] = n_new
        series["finalized"][:, step] = m["done_all"].reshape(N, S).sum(-1)
        series["backlog"][:, step] = m["backlog"].reshape(N, S).sum(-1)
        series["in_flight"][:, step] = m["in_flight"].reshape(N, S).sum(-1)
        t = np.float32(t + np.float32(cfg.dt))
    local = dict(acc)
    local["cost_wait"] = ws["cost_wait"]
    local["cost_work"] = ws["cost_work"]
    local["n_churned"] = ws["n_churned"]
    local["n_evicted"] = ws["n_evicted"]
    local["backlog_end"] = bl["count"]
    local["in_flight_end"] = win["active"].sum(-1)
    local["stolen"], local["donated"] = stolen, donated
    out = {k: v.reshape((N, S) + v.shape[1:]).sum(1) for k, v in local.items()}
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
    return out, dict(ws=ws, banks=banks, win=win, bl=bl, seeds=seeds,
                     learner=ls)


def _validate_stream_config(cfg: StreamConfig):
    """The reference's checks, plus a ``NotImplementedError`` for every
    feature the port does not run yet, so no such config runs silently on
    another path."""
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
    if L.feature_kind == "lm" and not L.enabled:
        raise ValueError(
            "learner.feature_kind='lm' requires learner.enabled: LM "
            "embeddings exist to feed the learner/fusion path")
    if L.feature_kind != "lm" and L.embed is not None:
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
    if sh.n_devices < 1 or cfg.n_shards % sh.n_devices:
        raise ValueError(f"sharding.n_devices={sh.n_devices} must be >= 1 "
                         f"and divide n_shards={cfg.n_shards}")
    unported = [
        (L.enabled and L.feature_kind == "lm",
         "learner.feature_kind='lm' (LM task features)"),
        (cfg.trace is not None, "trace"),
        (sh.n_devices > 1, f"sharding.n_devices={sh.n_devices}"),
    ]
    for on, what in unported:
        if on:
            raise NotImplementedError(f"{what} is not yet ported")


def run_stream(cfg: StreamConfig, horizon: int, *, n_reps: int = 1,
               seed: int = 0, warmup_frac: float = 0.3,
               rate_scale: float = 1.0, device="cuda", init=None,
               arrivals=None):
    """Run ``n_reps`` replications of the streaming service for ``horizon``
    ticks on ``device``. Steady-state metrics only accumulate after
    ``warmup_frac`` of the horizon; ``rate_scale`` multiplies the offered
    arrival rate. Returns a dict of tensors with leading dim ``n_reps``
    plus ``warmup_t``/``measured_s`` floats.

    ``seed`` draws the worker banks and counter seeds (host numpy) and the
    per-tick arrivals (a ``torch.Generator`` on ``device``). For parity
    tests, ``init`` replaces the first with a :func:`state_from_numpy`
    state (which may carry a trained learner) and ``arrivals = (n_new
    (horizon, n_reps), n_arr (horizon, n_reps, n_shards))`` the second;
    ``n_arr`` are per-shard counts before the ``max_arrivals_per_tick``
    cap. With the learner under ``uncertain_learnable`` the result also
    holds the learnability head's final ``learn2_W`` / ``learn2_b``.
    """
    _validate_stream_config(cfg)
    dev = resolve_device(device)
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
    out, _ = _run_one(cfg, int(horizon), init,
                      float(np.float32(warmup_t)), float(rate_scale), gen,
                      arrivals)
    out["warmup_t"] = warmup_t
    out["measured_s"] = horizon * cfg.dt - warmup_t
    return out


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
    label accuracy, votes per finalized task, drops, cost."""
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
    return dict(
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


def serve_state_from_numpy(cfg, state: dict, device="cuda") -> dict:
    """The port's serve state from a serve state given as numpy arrays
    (the reference's ``serve_init`` state, say): ``t``, ``step``, the
    per-shard ``seeds`` (S,) and worker state ``ws`` and ``banks`` (leading
    dim S), and with the learner ``learn`` (the seven ``LinearLearner``
    leaves), ``buf_X``, ``buf_y``, ``buf_n`` (and under
    ``uncertain_learnable`` ``learn2`` and ``buf_t``). Window and backlog
    start empty."""
    cfg = _as_serve_config(cfg)
    _validate_serve_config(cfg)
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
    return dict(st, t=np.float32(state["t"]), step=int(state["step"]))


def serve_init(cfg, seed: int = 0, device="cuda") -> dict:
    """The state :func:`serve_tick` advances, on ``device``.

    ``cfg`` is a StreamConfig with ``serve=True`` (or a ScenarioSpec,
    lowered by ``to_serve_config``). ``seed`` fixes the worker pools and
    the counter seeds (a numpy generator, as :func:`draw_init` for one
    replication) and through them every per-tick draw, so the label stream
    of a given injection schedule is deterministic. Returns a dict of
    tensors plus the host clock ``t`` and tick index ``step``."""
    cfg = _as_serve_config(cfg)
    _validate_serve_config(cfg)
    st = state_from_numpy(cfg, *draw_init(cfg, 1, seed), device)
    return dict(st, t=np.float32(0.0), step=0)


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
    all tensors on the state's device; ``t`` is the post-tick clock (a
    host float). ``feat`` / ``labels`` (real-text injections) need LM
    features, which are not ported yet (ROADMAP A12b)."""
    cfg = _as_serve_config(cfg)
    if feat is not None or labels is not None:
        raise ValueError(
            "serve_tick feat/labels injections require learner."
            "feature_kind='lm' (Gaussian tasks draw identity in the tick)")
    S, M = cfg.n_shards, cfg.max_arrivals_per_tick
    inj = np.stack([np.asarray(n_arr, np.int64).reshape(-1),
                    np.asarray(uid_base, np.int64).reshape(-1)])
    if inj.shape != (2, S):
        raise ValueError(f"n_arr and uid_base must be ({S},), got "
                         f"{np.shape(n_arr)} / {np.shape(uid_base)}")
    if (inj[0] < 0).any() or (inj[0] > M).any():
        raise ValueError(f"n_arr must be in [0, max_arrivals_per_tick={M}], "
                         f"got {inj[0].tolist()}")
    seeds = state["seeds"]
    inj = torch.as_tensor(inj, device=seeds.device)
    t, step, ls = state["t"], state["step"], state["learner"]
    ws, win, bl, m, train = _shard_tick(
        cfg, state["ws"], state["banks"], state["win"], state["bl"], inj[0],
        float(t), step, seeds, 0.0, _learner_tick_params(cfg, ls),
        uid_base=inj[1])
    if cfg.sharding.steal != "none":
        bl, got, gave = _steal_rebalance(cfg, bl)
    else:
        got = gave = torch.zeros_like(m["dropped"])
    if ls is not None:
        ls = _learner_push_fit(cfg, ls, train, step)
    t_new = np.float32(t + np.float32(cfg.dt))
    new = dict(state, ws=ws, win=win, bl=bl, learner=ls, t=t_new,
               step=step + 1)
    out = {k: m["srv_" + k] for k in _SRV_SLOT + _SRV_FLOAT}
    out.update(dropped=m["dropped"], backlog=bl["count"],
               in_flight=win["active"].sum(-1), stolen=got, donated=gave,
               t=float(t_new))
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
