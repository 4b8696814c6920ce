"""The stream tick of the two stream configurations, on the CPU in plain
PyTorch: what the reference of the stream cells reruns.

It is a frozen copy of the program's single-device tick
(``labelstream/router.py``), cut to the paths those configurations take:
FIFO admission, no worker-aware routing, no work steal, one device, no
trace, no serve mode, the hybrid learner always on (Gaussian or LM-bank
features), the priority match on the fused posterior, straggler
duplication, pool maintenance, adaptive redundancy and the periodic
full-confusion EM refresh. :func:`check_supported` refuses any other
configuration. It is not an independent implementation: it holds the card
against the same tick run on the CPU (see PERF.md, section 2).

Tasks arrive (drawn ahead of the loop, see :func:`draw_arrivals`), queue in
a per-shard FIFO backlog, are admitted into a window of ``window`` slots per
shard, are labeled by that shard's retainer pool, and are finalized by the
adaptive-redundancy policy on their running Dawid-Skene posterior fused
with the learner's. Every per-shard tensor has a leading dimension ``B =
n_reps * n_shards`` (replication-major); the learner's lead with
``n_reps``.

Randomness: the tick's own draws come from the counter-based ``lowbias32``
hash of ``(seed, step)``; the worker banks and seeds are drawn once with a
seeded ``numpy`` generator (:func:`draw_init`), the arrivals with a
``torch.Generator`` (:func:`draw_arrivals`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from perfbench.reference.stream import linear
from perfbench.reference.stream.aggregate import _add_at, _count_rows, _ds_em
from perfbench.reference.stream.arrivals import (
    ArrivalConfig, init_arrival_state, sample_arrivals,
)
from perfbench.reference.stream.linear import ordered_matmul
from perfbench.reference.stream.policy import (
    PolicyConfig, confidence, fuse_posteriors, learner_known,
    should_finalize, target_outstanding,
)
from perfbench.reference.stream.shared import (
    SWITCH_DELAY_S, WAIT_PAY_PER_S, WORK_PAY_PER_RECORD, bank_gather,
)
from perfbench.reference.stream.simfast import (
    INF, FastConfig, _init_workers, _uniform_block, churn_and_maintain,
    draw_latency, priority_match,
)


@dataclasses.dataclass(frozen=True)
class StreamLearnerConfig:
    """The hybrid learner's knobs (the configuration file's
    ``learner``)."""
    enabled: bool = False
    n_features: int = 8
    class_sep: float = 1.8
    hard_sep_scale: float = 1.0
    feature_kind: str = "gaussian"
    embed: Optional[object] = None
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
class RoutingConfig:
    """Worker-aware routing and ranked admission (the file's ``routing``);
    the reference runs neither."""
    enabled: bool = False
    w_acc: float = 3.0
    w_speed: float = 0.5
    ewma_alpha: float = 0.25
    admission: str = "fifo"


@dataclasses.dataclass(frozen=True)
class ShardingConfig:
    """Shard groups over devices and the work steal (the file's
    ``sharding``); the reference runs one group and no steal."""
    n_devices: int = 1
    steal: str = "none"
    steal_max: int = 4
    steal_slack: int = 2


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    """The stream's configuration (the file's ``stream_config``)."""
    n_shards: int = 2
    pool_size: int = 8
    window: int = 32
    backlog: int = 1024
    n_classes: int = 2
    dt: float = 5.0
    max_arrivals_per_tick: int = 64
    arrivals: ArrivalConfig = ArrivalConfig()
    policy: PolicyConfig = PolicyConfig()
    batch_replay: bool = False
    p_hard: float = 0.0
    hard_scale: float = 0.35
    straggler: bool = True
    max_dup: int = 2
    pm_l: float = float("inf")
    use_termest: bool = True
    min_obs: int = 3
    z: float = 1.0
    alpha: float = 1.0
    recruit_mean_s: float = 45.0
    session_mean_s: float = 1800.0
    median_mu: float = 150.0
    sigma_ln: float = 1.0
    cv_lo: float = 0.3
    cv_hi: float = 1.2
    acc_a: float = 18.0
    acc_b: float = 2.0
    latency_floor: float = 2.0
    bank: int = 64
    est_prior_acc: float = 0.85
    est_prior_n: float = 8.0
    learner: StreamLearnerConfig = StreamLearnerConfig()
    routing: RoutingConfig = RoutingConfig()
    refresh_every: int = 0
    refresh_iters: int = 8
    serve: bool = False
    tis_bins: int = 512
    tis_bin_s: float = 4.0
    sharding: ShardingConfig = ShardingConfig()
    trace: Optional[object] = None

    @property
    def fast(self) -> FastConfig:
        """The pool machinery's slice of the configuration."""
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


def check_supported(cfg: StreamConfig):
    """Raise where ``cfg`` takes a path the reference does not run."""
    L, R, S = cfg.learner, cfg.routing, cfg.sharding
    bad = [name for name, off in (
        ("serve", cfg.serve), ("trace", cfg.trace is not None),
        ("batch_replay", cfg.batch_replay), ("routing.enabled", R.enabled),
        ("routing.admission", R.admission != "fifo"),
        ("sharding.steal", S.steal != "none"),
        ("sharding.n_devices", S.n_devices != 1),
        ("learner.enabled", not L.enabled),
        ("learner.prioritize", not L.prioritize)) if off]
    if bad:
        raise ValueError(f"the stream reference does not run {bad}")


# --------------------------------------------------------------------------
# state
# --------------------------------------------------------------------------

_WS_KEYS = ("mu", "sigma", "acc", "repl_idx", "busy_until", "assigned",
            "start_t", "blocked_until", "session_end", "n_started",
            "n_completed", "n_terminated", "comp_sum", "comp_sqsum",
            "term_sum", "cost_wait", "cost_work", "n_evicted", "n_churned",
            "est_correct", "est_n", "lat_ewma")


def _tensor(a, B: int):
    a = np.asarray(a)
    if a.dtype == np.bool_:
        dtype = torch.bool
    elif np.issubdtype(a.dtype, np.integer):
        dtype = torch.int64
        a = a.astype(np.int64)
    else:
        dtype = torch.float32
    return torch.tensor(a, dtype=dtype).reshape((B,) + a.shape[2:])


def initial_state(cfg: StreamConfig, ws: dict, banks: dict, seeds) -> dict:
    """The run state from the numpy worker state, banks and ``uint32``
    seeds of :func:`draw_init` (leading dims ``(n_reps, n_shards)``): an
    empty window and backlog and an untrained learner, per-shard tensors
    flattened to ``B = n_reps * n_shards``."""
    seeds = np.asarray(seeds)
    n_reps = seeds.shape[0]
    B = n_reps * cfg.n_shards
    Ws, C, cap, Q = cfg.window, cfg.n_classes, cfg.policy.votes_cap, \
        cfg.backlog
    L = cfg.learner
    F = L.n_features
    win = dict(
        active=torch.zeros((B, Ws), dtype=torch.bool),
        arrival_t=torch.zeros((B, Ws)),
        difficulty=torch.ones((B, Ws)),
        true_label=torch.zeros((B, Ws), dtype=torch.int64),
        n_votes=torch.zeros((B, Ws), dtype=torch.int64),
        logpost=torch.zeros((B, Ws, C)),
        # per-slot vote store (worker slot + label); row Ws is the dump row
        vote_wid=torch.zeros((B, Ws + 1, cap), dtype=torch.int64),
        vote_lab=torch.zeros((B, Ws + 1, cap), dtype=torch.int64),
        feat=torch.zeros((B, Ws, F)))
    # FIFO ring of arrival times; slot Q is the dump slot of masked writes
    bl = dict(times=torch.zeros((B, Q + 1)),
              head=torch.zeros((B,), dtype=torch.int64),
              count=torch.zeros((B,), dtype=torch.int64))
    ls = dict(
        learn=linear.init(F, C, (n_reps,)),
        buf_X=torch.zeros((n_reps, L.buffer + 1, F)),
        buf_y=torch.zeros((n_reps, L.buffer + 1), dtype=torch.int64),
        buf_n=torch.zeros((n_reps,), dtype=torch.int64))
    return dict(
        ws={k: _tensor(ws[k], B) for k in _WS_KEYS},
        banks={k: _tensor(banks[k], B) for k in ("mu", "sigma", "acc")},
        win=win, bl=bl,
        seeds=_tensor(seeds.astype(np.uint32).astype(np.int64), B),
        learner=ls)


# --------------------------------------------------------------------------
# one tick of every shard
# --------------------------------------------------------------------------

def _acc_hat(cfg: StreamConfig, ws):
    """Beta-smoothed clipped online worker-accuracy estimate."""
    return torch.clamp(
        (cfg.est_prior_acc * cfg.est_prior_n + ws["est_correct"])
        / (cfg.est_prior_n + ws["est_n"]), 0.52, 0.995)


def _task_features(u1, u2, tl, diff, L: StreamLearnerConfig, C: int):
    """Class-conditional Gaussian features: one-hot class means scaled by
    ``class_sep`` plus unit Box-Muller noise from the uniforms ``u1``,
    ``u2``; hard tasks' separation scaled by ``hard_sep_scale``."""
    nrm = torch.sqrt(-2.0 * torch.log1p(-u1)) * torch.cos(2.0 * math.pi * u2)
    means = L.class_sep * torch.eye(C, L.n_features, device=u1.device)
    base = means[tl]
    if L.hard_sep_scale != 1.0:
        base = base * torch.where(diff < 1.0, L.hard_sep_scale, 1.0)[..., None]
    return base + nrm


def _admit_fifo(cfg: StreamConfig, bl, n_arr, free, frank, t, step, seed,
                bank):
    """FIFO ring push of this tick's arrivals and admission of the oldest
    into the free window slots; task identity (difficulty, label, features)
    is drawn at admission. Returns ``(bl, dropped, admit, arr_t, diff, tl,
    featw)``."""
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
    n_adm = torch.minimum(bl_count, free.sum(-1))
    admit = free & (frank < n_adm[:, None])
    src = torch.where(admit, (bl["head"][:, None] + frank) % Q, Q)
    arr_t = torch.gather(bl_times, 1, src)
    bl_new = dict(times=bl_times, head=(bl["head"] + n_adm) % Q,
                  count=bl_count - n_adm)
    # fresh-task draws at admission (difficulty mixture + label)
    uw = _uniform_block(seed ^ 0x33CC33CC, step, 2 * Ws).reshape(B, 2, Ws)
    diff = torch.where(uw[:, 0] < cfg.p_hard, cfg.hard_scale, 1.0)
    tl = torch.clamp(torch.floor(uw[:, 1] * C).to(torch.int64), 0, C - 1)
    F = L.n_features
    uf = _uniform_block(seed ^ 0x5EEDF00D, step, 2 * Ws * F
                        ).reshape(B, 2, Ws, F)
    if L.feature_kind == "lm":
        # the Gaussian draw's block, its first column picking the bank
        # variant, so every other stream stays the same
        featw = bank_gather(bank, uf[:, 0, :, 0], tl, diff)
    else:
        featw = _task_features(uf[:, 0], uf[:, 1], tl, diff, L, C)
    return bl_new, dropped, admit, arr_t, diff, tl, featw


def _shard_tick(cfg: StreamConfig, ws, banks, win, bl, n_arr, t: float,
                step: int, seed, warmup_t: float, lp: dict, bank=None):
    """Advance every shard by one tick. ``n_arr`` (B,) are this tick's
    arrivals per shard, ``t`` the tick's time and ``step`` its index,
    ``seed`` (B,) the counter seeds, ``lp`` the learner's parameters
    expanded to B (:func:`_learner_tick_params`), ``bank`` the embedding
    bank of LM features. Returns ``(ws, win, bl, metrics, train)``;
    ``train`` holds the finalized examples for the learner's ring."""
    P, Ws, C = cfg.pool_size, cfg.window, cfg.n_classes
    cap = cfg.policy.votes_cap
    pol, fast, L, R = cfg.policy, cfg.fast, cfg.learner, cfg.routing
    dev = seed.device
    B = seed.shape[0]
    up = _uniform_block(seed, step, 8 * P).reshape(B, 8, P)

    # ---- backlog push + admission into free window slots -----------------
    free = ~win["active"]
    frank = torch.cumsum(free.to(torch.int64), -1) - 1
    bl, dropped, admit, arr_t, diff, tl, featw = _admit_fifo(
        cfg, bl, n_arr, free, frank, t, step, seed, bank)
    bl_count = bl["count"]
    win = dict(win)
    win["active"] = win["active"] | admit
    win["arrival_t"] = torch.where(admit, arr_t, win["arrival_t"])
    win["difficulty"] = torch.where(admit, diff, win["difficulty"])
    win["true_label"] = torch.where(admit, tl, win["true_label"])
    win["n_votes"] = torch.where(admit, 0, win["n_votes"])
    win["logpost"] = torch.where(admit[..., None], 0.0, win["logpost"])
    win["feat"] = torch.where(admit[..., None], featw, win["feat"])

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
    model_lg = ordered_matmul(win["feat"], lp["lW"]) + lp["lb"][:, None]
    fused = fuse_posteriors(win["logpost"],
                            torch.log_softmax(model_lg, dim=-1),
                            lp["fuse_w"][:, None, None])
    known, known_fin = learner_known(
        fused, win["n_votes"], threshold=L.known_threshold,
        min_votes_known=L.min_votes_known)

    # ---- finalization (adaptive redundancy) -----------------------------
    fin, conf = should_finalize(fused, win["n_votes"], pol)
    fin = (fin | known_fin) & win["active"]
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
    ws["lat_ewma"] = torch.where(
        comp, (1.0 - R.ewma_alpha) * ws["lat_ewma"] + R.ewma_alpha * lat,
        ws["lat_ewma"])
    ws["cost_work"] = ws["cost_work"] + freed.sum(-1) * WORK_PAY_PER_RECORD
    ws["blocked_until"] = torch.where(
        comp, ws["busy_until"],
        torch.where(lose, t + SWITCH_DELAY_S, ws["blocked_until"]))
    ws["assigned"] = torch.where(freed, -1, ws["assigned"])
    ws["busy_until"] = torch.where(freed, INF, ws["busy_until"])

    # ---- churn + latency maintenance ------------------------------------
    ws, leave = churn_and_maintain(fast, ws, banks, t, up[:, 2], up[:, 3],
                                   cfg.recruit_mean_s)
    ws["est_correct"] = torch.where(leave, 0.0, ws["est_correct"])
    ws["est_n"] = torch.where(leave, 0.0, ws["est_n"])
    ws["lat_ewma"] = torch.where(leave, cfg.median_mu, ws["lat_ewma"])
    # votes cast by departing workers move to the dump slot P
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
    # a model-known task requests only the crowd votes it still needs
    want = torch.where(known, torch.minimum(want, torch.clamp(
        L.min_votes_known - win["n_votes"], min=0)), want)
    tier1 = win["active"] & (n_asg < want)
    if cfg.straggler:
        extra = torch.clamp(want, max=cfg.max_dup)
        tier2 = win["active"] & (want > 0) & (n_asg >= want) \
            & (n_asg < want + extra)
    else:
        tier2 = torch.zeros_like(tier1)
    # votes go to the window tasks with the LOWEST fused confidence first
    unc = torch.where(win["active"], -confidence(fused), -INF)
    perm = torch.argsort(-unc, dim=-1, stable=True)
    take, task_p, _, _ = priority_match(
        avail, torch.gather(tier1, 1, perm), torch.gather(tier2, 1, perm),
        torch.zeros((B,), dtype=torch.int64, device=dev))
    task_for_w = torch.gather(perm, 1, task_p)
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
        model_known=(wfin & known).sum(-1))
    # finalized (features, label) pairs for the learner's ring; the label
    # is the CROWD-ONLY posterior's
    crowd = win["logpost"].argmax(-1)
    train = dict(mask=fin & (win["n_votes"] >= 1) if L.train_crowd_only
                 else fin, feat=win["feat"], label=crowd)
    return ws, win, bl, metrics, train


# --------------------------------------------------------------------------
# the learner shared by a replication's shards
# --------------------------------------------------------------------------

def _learner_tick_params(cfg: StreamConfig, ls, n_shards: int):
    """The tick's learner parameters expanded to each replication's shards:
    ``lW``, ``lb`` and the fusion weight ``fuse_w`` (ramping with the
    ring's fill)."""
    L, S = cfg.learner, n_shards
    rep = lambda x: x.repeat_interleave(S, 0)
    fuse_w = L.prior_scale * torch.clamp(
        ls["buf_n"].to(torch.float32) / L.ramp_n, max=1.0)
    return dict(lW=rep(ls["learn"].W), lb=rep(ls["learn"].b),
                fuse_w=rep(fuse_w))


def _learner_push_fit(cfg: StreamConfig, ls, train, step: int):
    """Push this tick's finalized examples of every shard, in shard order,
    into their replication's replay ring, and on the ``fit_every`` cadence
    take ``fit_steps`` Adam steps on the ring."""
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
    if step % L.fit_every == 0:
        sw = (torch.arange(Bf, device=tm.device)[None, :]
              < new["buf_n"][:, None]).to(torch.float32)
        X, y = new["buf_X"][:, :Bf], new["buf_y"][:, :Bf]
        new["learn"] = linear.fit(ls["learn"], X, y, sw, steps=L.fit_steps,
                                  lr=L.lr, l2=L.l2)
    return new


# --------------------------------------------------------------------------
# draws from the seed
# --------------------------------------------------------------------------

def _tick_arrivals(cfg: StreamConfig, arr_state, gen, t: float,
                   rate_scale: float):
    """One tick's arrivals for every replication: the total ``n_new``
    (n_reps,) and its per-shard split ``n_arr`` (n_reps, n_shards), each
    arrival assigned a uniform shard, the total capped at
    ``max_arrivals_per_tick * n_shards``."""
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
                  seed: int, rate_scale: float, device):
    """The arrivals of a run of ``seed``, ``(n_new (horizon, n_reps), n_arr
    (horizon, n_reps, n_shards))``, drawn tick by tick from a
    ``torch.Generator`` on ``device`` seeded with ``seed``: the draw order
    is part of what the configuration fixes (see its ``guarantees``)."""
    dev = torch.device(device)
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


def draw_init(cfg: StreamConfig, n_reps: int, seed: int):
    """The initial state of a run of ``seed``, as numpy ``(ws, banks,
    seeds)`` with leading dims ``(n_reps, n_shards)``: the workers and
    their replacement banks, then the counter seeds, from one seeded
    ``numpy`` generator."""
    rng = np.random.default_rng(seed)
    lead = (n_reps, cfg.n_shards)
    ws, banks = _init_workers(cfg.fast, rng, lead)
    P = cfg.pool_size
    ws["est_correct"] = np.zeros(lead + (P,), np.float32)
    ws["est_n"] = np.zeros(lead + (P,), np.float32)
    ws["lat_ewma"] = np.full(lead + (P,), cfg.median_mu, np.float32)
    seeds = rng.integers(0, 2 ** 32, lead, dtype=np.uint64)
    return ws, banks, seeds


# --------------------------------------------------------------------------
# the run
# --------------------------------------------------------------------------

_ACCUM = ("hist", "done", "correct", "sum_tis", "votes_fin", "completions",
          "done_all", "dropped", "model_known")


def _run_one(cfg: StreamConfig, horizon: int, state: dict, warmup_t: float,
             arrivals, bank=None):
    """All replications of ``state`` in lock-step over ``horizon`` ticks,
    on the arrivals ``(n_new (H, n_reps), n_arr (H, n_reps, n_shards))``.
    Returns the outputs, reduced over each replication's shards."""
    S, M = cfg.n_shards, cfg.max_arrivals_per_tick
    cap_total = M * S
    N = state["seeds"].shape[0] // S
    ws, banks, win, bl = (state[k] for k in ("ws", "banks", "win", "bl"))
    seeds, ls = state["seeds"], state["learner"]
    zi = lambda *s: torch.zeros(s, dtype=torch.int64)
    acc = {k: zi(N * S) for k in _ACCUM if k != "hist"}
    acc["hist"] = zi(N * S, cfg.tis_bins)
    acc["sum_tis"] = torch.zeros((N * S,))
    over, arrived, arrived_warm = zi(N), zi(N), zi(N)
    series = {k: zi(N, horizon)
              for k in ("arrivals", "finalized", "backlog", "in_flight")}
    inj_new, inj_arr = arrivals
    per_rep = lambda m, k: m[k].reshape(N, S).sum(-1)
    t = np.float32(0.0)
    for step in range(horizon):
        tf = float(t)
        n_new, n_arr = inj_new[step], inj_arr[step]
        over = over + torch.clamp(n_arr - M, min=0).sum(-1) \
            + (n_new - torch.clamp(n_new, max=cap_total))
        n_arr = torch.clamp(n_arr, max=M)
        lp = _learner_tick_params(cfg, ls, S)
        ws, win, bl, m, train = _shard_tick(
            cfg, ws, banks, win, bl, n_arr.reshape(-1), tf, step, seeds,
            warmup_t, lp, bank=bank)
        ls = _learner_push_fit(cfg, ls, train, step)
        for k in _ACCUM:
            acc[k] = acc[k] + m[k]
        arrived = arrived + n_new
        if tf >= warmup_t:
            arrived_warm = arrived_warm + n_new
        series["arrivals"][:, step] = n_new
        series["finalized"][:, step] = per_rep(m, "done_all")
        series["backlog"][:, step] = per_rep(m, "backlog")
        series["in_flight"][:, step] = per_rep(m, "in_flight")
        t = np.float32(t + np.float32(cfg.dt))
    acc["cost_wait"] = ws["cost_wait"]
    acc["cost_work"] = ws["cost_work"]
    acc["n_churned"] = ws["n_churned"]
    acc["n_evicted"] = ws["n_evicted"]
    acc["backlog_end"] = bl["count"]
    acc["in_flight_end"] = win["active"].sum(-1)
    acc["stolen"], acc["donated"] = zi(N * S), zi(N * S)
    out = {k: v.reshape((N, S) + v.shape[1:]).sum(1) for k, v in acc.items()}
    out["dropped"] = out["dropped"] + over
    out["arrived"] = arrived
    out["arrived_warm"] = arrived_warm
    out["per_shard"] = {k: acc[k].reshape(N, S) for k in
                        ("backlog_end", "in_flight_end", "stolen", "donated")}
    out["series"] = series
    return out


def run_rows(cfg: StreamConfig, horizon: int, draws: list, *,
             warmup_frac: float, bank=None) -> dict:
    """One replication a row: ``draws`` holds each row's ``(init,
    arrivals)``, ``init`` the numpy ``(ws, banks, seeds)`` of
    :func:`draw_init` for one replication, ``arrivals`` its ``(n_new,
    n_arr)`` of :func:`draw_arrivals`. All rows run in one batch on the
    CPU. Returns the outputs with a leading row dimension."""
    check_supported(cfg)
    parts = [d[0] for d in draws]
    cat = lambda i: {k: np.concatenate([pt[i][k] for pt in parts])
                     for k in parts[0][i]}
    state = initial_state(cfg, cat(0), cat(1),
                          np.concatenate([pt[2] for pt in parts]))
    arr = lambda i: torch.cat([torch.as_tensor(np.asarray(d[1][i]),
                                               dtype=torch.int64)
                               for d in draws], 1)
    if bank is not None:
        bank = torch.as_tensor(bank, dtype=torch.float32)
        L, C = cfg.learner, cfg.n_classes
        if bank.dim() != 4 or tuple(bank.shape[:2]) != (2, C) \
                or bank.shape[3] != L.n_features:
            raise ValueError(f"bank must be (2, {C}, K, {L.n_features}), "
                             f"got {tuple(bank.shape)}")
    warmup_t = float(np.float32(warmup_frac * horizon * cfg.dt))
    return _run_one(cfg, int(horizon), state, warmup_t, (arr(0), arr(1)),
                    bank=bank)
