"""Streaming router: ring-buffer task window over sharded retainer pools.

Port of the FIFO path of ``src/repro/labelstream/router.py``. Tasks arrive
continuously (arrivals.py), queue in a per-shard backlog FIFO, are admitted
into a fixed-size ring-buffer window of ``window`` slots per shard, are
labeled by that shard's retainer pool, and are finalized by the
adaptive-redundancy policy (policy.py) on their running Dawid-Skene
posterior. Every ``refresh_every`` ticks the exact offline full-confusion
EM (aggregate.py) re-explains the window's vote log: one batched E-step
kernel launch per EM iteration for all replications x shards.

Layout: every per-shard tensor has a leading dimension ``B = n_reps *
n_shards`` (replication-major) in place of the reference's two ``vmap``s,
and the tick loop is a Python loop over ``_shard_tick``. Per-tick control
flow never waits for the device: the refresh cadence is a host integer
test and nothing in the tick calls ``.item()``.

Randomness: the tick's own draws come from the counter-based ``lowbias32``
hash of ``(seed, step)`` (bit-exact with the reference); the worker banks
and seeds are drawn once on the host with a seeded ``numpy`` generator, and
per-tick arrivals with a ``torch.Generator`` on the run's device. For
parity tests, :func:`state_from_numpy` takes the reference's initial state
and :func:`run_stream` takes injected arrival counts.

Not yet ported (the config validator refuses them): the learner, scored
routing and learner-driven admission, work stealing, device sharding,
trace buffers and serve mode.
"""
from __future__ import annotations

import dataclasses
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
    PolicyConfig, should_finalize, target_outstanding,
)
from repro_torch.labelstream.routing import RoutingConfig


@dataclasses.dataclass(frozen=True)
class StreamLearnerConfig:
    """Streaming hybrid learning knobs; fields and defaults as in the
    reference. Only ``enabled=False`` runs in the port so far."""
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
    """Device topology for the streaming tick; only the single-device,
    no-stealing default runs in the port so far."""
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
    return dict(
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


def _init_backlog(cfg: StreamConfig, B: int, device):
    # FIFO ring of arrival times; slot Q is the dump slot of masked writes
    return dict(times=torch.zeros((B, cfg.backlog + 1), device=device),
                head=torch.zeros((B,), dtype=torch.int64, device=device),
                count=torch.zeros((B,), dtype=torch.int64, device=device))


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


def state_from_numpy(cfg: StreamConfig, ws: dict, banks: dict, seeds,
                     device="cuda"):
    """The port's run state from per-shard initial state given as numpy
    arrays with leading dims ``(n_reps, n_shards)``: the worker state of
    ``_init_shard`` (the reference's or the port's), its banks, and the
    ``uint32`` per-shard counter seeds. Window and backlog start empty.
    Returns a dict with ``ws``, ``banks``, ``win``, ``bl`` and ``seeds``,
    every tensor flattened to ``B = n_reps * n_shards`` on ``device``."""
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
    return dict(
        ws={k: _tensor(ws[k], B, dev) for k in _WS_KEYS},
        banks={k: _tensor(banks[k], B, dev) for k in ("mu", "sigma", "acc")},
        win=_init_window(cfg, B, dev), bl=_init_backlog(cfg, B, dev),
        seeds=_tensor(seeds.astype(np.uint32).astype(np.int64), B, dev))


# --------------------------------------------------------------------------
# one tick of every shard
# --------------------------------------------------------------------------

def _acc_hat(cfg: StreamConfig, ws):
    """Beta-smoothed clipped online worker-accuracy estimate — the quantity
    that weights online Dawid-Skene votes."""
    return torch.clamp(
        (cfg.est_prior_acc * cfg.est_prior_n + ws["est_correct"])
        / (cfg.est_prior_n + ws["est_n"]), 0.52, 0.995)


def _shard_tick(cfg: StreamConfig, ws, banks, win, bl, n_arr, t: float,
                step: int, seed, warmup_t: float):
    """Advance every shard by one tick. ``n_arr`` (B,) are this tick's
    arrivals per shard, ``t`` the tick's time and ``step`` its index (host
    numbers), ``seed`` (B,) the counter seeds. Returns ``(ws, win, bl,
    metrics)``."""
    P, Ws, C = cfg.pool_size, cfg.window, cfg.n_classes
    Q, M, cap = cfg.backlog, cfg.max_arrivals_per_tick, cfg.policy.votes_cap
    pol, fast, R = cfg.policy, cfg.fast, cfg.routing
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
    bl = dict(times=bl_times, head=(bl["head"] + n_adm) % Q,
              count=bl_count - n_adm)
    bl_count = bl["count"]
    # fresh-task draws at ADMISSION (difficulty mixture + label)
    uw = _uniform_block(seed ^ 0x33CC33CC, step, 2 * Ws).reshape(B, 2, Ws)
    diff = torch.where(uw[:, 0] < cfg.p_hard, cfg.hard_scale, 1.0)
    tl = torch.clamp(torch.floor(uw[:, 1] * C).to(torch.int64), 0, C - 1)
    win = dict(win)
    win["active"] = win["active"] | admit
    win["arrival_t"] = torch.where(admit, arr_t, win["arrival_t"])
    win["difficulty"] = torch.where(admit, diff, win["difficulty"])
    win["true_label"] = torch.where(admit, tl, win["true_label"])
    win["n_votes"] = torch.where(admit, 0, win["n_votes"])
    win["logpost"] = torch.where(admit[..., None], 0.0, win["logpost"])

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
    lp = torch.cat([win["logpost"],
                    torch.zeros((B, 1, C), device=dev)], 1).reshape(B, -1)
    win["logpost"] = _add_at(lp, tid_k * C + label,
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

    # ---- finalization (adaptive redundancy) -----------------------------
    fused = win["logpost"]
    fin, _conf = should_finalize(fused, win["n_votes"], pol)
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
    # completion-latency EWMA (the routing speed axis, kept for parity)
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
    tier1 = win["active"] & (n_asg < want)
    if cfg.straggler:
        extra = torch.clamp(want, max=cfg.max_dup)
        tier2 = win["active"] & (want > 0) & (n_asg >= want) \
            & (n_asg < want + extra)
    else:
        tier2 = torch.zeros_like(tier1)
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
        in_flight=win["active"].sum(-1))
    return ws, win, bl, metrics


# --------------------------------------------------------------------------
# driver
# --------------------------------------------------------------------------

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
          "done_all", "dropped")


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
    zi = lambda *s: torch.zeros(s, dtype=torch.int64, device=dev)
    acc = {k: zi(B) for k in _ACCUM if k != "hist"}
    acc["hist"] = zi(B, cfg.tis_bins)
    acc["sum_tis"] = torch.zeros((B,), device=dev)
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
        ws, win, bl, m = _shard_tick(cfg, ws, banks, win, bl, n_arr, tf,
                                     step, seeds, warmup_t)
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
    local["stolen"] = local["donated"] = zi(B)
    local["model_known"] = zi(B)
    out = {k: v.reshape((N, S) + v.shape[1:]).sum(1) for k, v in local.items()}
    out["dropped"] = out["dropped"] + over
    out["arrived"] = arrived
    out["arrived_warm"] = arrived_warm
    out["per_shard"] = {k: local[k].reshape(N, S) for k in
                        ("backlog_end", "in_flight_end", "stolen", "donated")}
    out["series"] = series
    return out, dict(ws=ws, banks=banks, win=win, bl=bl, seeds=seeds)


def _validate_stream_config(cfg: StreamConfig):
    """The reference's checks, plus a ``NotImplementedError`` for every
    feature the port does not run yet, so no such config runs silently on
    another path."""
    L = cfg.learner
    if cfg.serve:
        raise NotImplementedError(
            "StreamConfig.serve=True (live serve mode) is not yet ported")
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
    if sh.n_devices < 1 or cfg.n_shards % sh.n_devices:
        raise ValueError(f"sharding.n_devices={sh.n_devices} must be >= 1 "
                         f"and divide n_shards={cfg.n_shards}")
    unported = [
        (L.enabled, "learner.enabled"),
        (cfg.routing.enabled, "routing.enabled"),
        (cfg.routing.admission != "fifo",
         f"routing.admission={cfg.routing.admission!r}"),
        (cfg.trace is not None, "trace"),
        (sh.steal != "none", f"sharding.steal={sh.steal!r}"),
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
    state and ``arrivals = (n_new (horizon, n_reps), n_arr (horizon,
    n_reps, n_shards))`` the second; ``n_arr`` are per-shard counts before
    the ``max_arrivals_per_tick`` cap.
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
