"""Vectorized Monte-Carlo crowd simulator (the ``simfast`` engine).

Port of ``src/repro/core/simfast.py``: the static :class:`FastConfig`, the
counter-based ``lowbias32`` randomness, the latency and exponential draws,
the two-tier ``priority_match``, worker-pool init from pre-drawn banks,
TermEst and ``churn_and_maintain`` (shared with the streaming router); the
batch engine (``_tick``, ``_run_batch``, ``_simulate_one``, ``simulate``);
and the hybrid-learning loop on it (``_learner_round``,
``simulate_learning_batch``, ``simulate_learning``, and its learner half
``make_learner_step``). Every function works on
tensors with leading batch dimensions (replications, or replications x
shards) in front of the pool or task axis: the reference's ``vmap`` over
replications is that leading dim, its ``lax.scan`` over batches and rounds
a Python loop.

The reference's batched ``while_loop`` over event ticks keeps stepping
every replication until the last one stops, and freezes a replication
whose condition went false by selecting its old carry. ``_run_batch`` does
the same: it computes ``alive`` per replication each step, keeps the old
value of every carry leaf where it is false, and reads ``alive.any()`` on
the host only every ``_ALIVE_EVERY`` steps (the extra masked steps are
no-ops).

The hash is computed in int64 masked to 32 bits: torch has no usable
``uint32`` shifts or products on the CPU, and every product here is split
into 16-bit halves so it stays exact in int64 without relying on signed
overflow (which CUDA does not define).

``FastConfig.trace`` adds per-batch trace counters (ticks, votes,
finalizations, cumulative assignments and straggler duplications, churn,
evictions, batch end times) that read state the engine already computes
and draw nothing, so traced runs equal untraced ones on every shared
output. :func:`simulate_swept` (:class:`SimScales` multipliers) and
:func:`simulate_swept_pop` (:class:`PopTraced` absolute overrides of the
population) run every sweep point x replication as rows of one batched
run, each point drawn as its standalone :func:`simulate` draws it.

The reference's ``pmap`` paths are a replication split here: with more
than one device (``devices=``, else every visible card for ``device=
"cuda"``, as the reference takes ``jax.local_device_count()``) and
``shard=True``, :func:`simulate`, :func:`simulate_swept_pop` and
:func:`simulate_learning_batch` split their rows (replications, or sweep
points x replications) across the devices, padded to a multiple of the
count by repeating the last row, each part run on its device from the
same full-width draws, and the parts gathered back with the padding
dropped: bit for bit the one-device run.
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
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import (
    shard_gather, shard_put, tree_map,
)
from repro_torch.labelstream.aggregate import _add_at
from repro_torch.launch.mesh import StreamMesh
from repro_torch.learning import linear, select as lsel
from repro_torch.obs import timing
from repro_torch.obs.trace import TraceConfig

INF = float("inf")
MASK32 = 0xFFFFFFFF


class SimScales(NamedTuple):
    """Multipliers of the continuous pool rates for :func:`simulate_swept`:
    worker speed (``median_mu``), session length (``session_mean_s``) and
    recruitment delay (``recruit_mean_s`` and ``cold_recruit_mean_s``).
    Leaves are numbers or share a leading sweep axis."""
    mu: object = 1.0
    session: object = 1.0
    recruit: object = 1.0


class PopTraced(NamedTuple):
    """Absolute per-point overrides of the population for
    :func:`simulate_swept_pop`: each leaf replaces the same-named
    ``FastConfig`` field, ``0.0`` meaning "not overridden" (every real
    value is positive). A point whose values equal the config's runs as
    :func:`simulate` does, bit for bit."""
    median_mu: object = 0.0
    session_mean_s: object = 0.0
    recruit_mean_s: object = 0.0
    cold_recruit_mean_s: object = 0.0
    acc_a: object = 0.0
    acc_b: object = 0.0


def _ov(traced, static):
    """Absolute-override resolve: ``traced`` unless it is the 0 sentinel,
    else the static config value."""
    return traced if traced > 0 else static


@dataclasses.dataclass(frozen=True)
class FastConfig:
    """Static (hashable) configuration of the simulator's pool machinery;
    fields and defaults as in the reference."""
    pool_size: int = 15
    n_tasks: int = 60
    batch_ratio: float = 1.0
    batch_size: Optional[int] = None
    n_records: int = 1
    votes_needed: int = 1
    n_classes: int = 2
    straggler: bool = True
    max_dup: int = 2
    pm_l: float = float("inf")        # maintenance latency threshold
    use_termest: bool = True
    min_obs: int = 3
    z: float = 1.0
    alpha: float = 1.0
    retainer: bool = True             # False = Base-NR cold start
    recruit_mean_s: float = 45.0
    cold_recruit_mean_s: float = 200.0
    session_mean_s: float = 1800.0
    median_mu: float = 150.0
    sigma_ln: float = 1.0
    cv_lo: float = 0.3
    cv_hi: float = 1.2
    acc_a: float = 18.0
    acc_b: float = 2.0
    dt: float = 2.0
    bundle_s: float = 64.0
    mitig_bundle_s: float = 12.0
    max_batch_time: float = 3600.0
    latency_floor: float = 2.0
    bank: int = 16
    # per-batch trace counters (None: untraced)
    trace: Optional[TraceConfig] = None

    @property
    def eff_batch(self) -> int:
        if self.batch_size is not None:
            return max(1, int(self.batch_size))
        return max(1, int(round(self.pool_size / self.batch_ratio)))

    @property
    def n_batches(self) -> int:
        return -(-self.n_tasks // self.eff_batch)

    @property
    def batch_steps(self) -> int:
        # tick budget: worst case is one completion per worker per tick
        # during backlog draining plus fine-grained mitigation-phase ticks
        return int(math.ceil(self.max_batch_time / self.dt))


# --------------------------------------------------------------------------
# population draws (host numpy, once per run)
# --------------------------------------------------------------------------

def _draw_workers(cfg: FastConfig, rng: np.random.Generator, shape):
    """(mu, sigma, acc) float32 arrays of ``shape`` with the reference's
    distributions. Drawn on the host: torch's Beta sampler takes no
    generator."""
    mu = cfg.median_mu * np.exp(cfg.sigma_ln * rng.standard_normal(shape))
    mu = np.maximum(15.0, mu)
    sigma = mu * rng.uniform(cfg.cv_lo, cfg.cv_hi, shape)
    acc = np.clip(rng.beta(cfg.acc_a, cfg.acc_b, shape), 0.55, 0.995)
    return (mu.astype(np.float32), sigma.astype(np.float32),
            acc.astype(np.float32))


def _init_workers(cfg: FastConfig, rng: np.random.Generator, lead=()):
    """Dense worker-pool state and banks as numpy arrays with leading dims
    ``lead``; column 0 of each bank seeds the initial pool, later columns
    are the fresh workers consumed by churn/eviction backfill. With a
    trace, also the cumulative ``tr_assigned`` / ``tr_dups`` counters."""
    P = cfg.pool_size
    lead = tuple(lead)
    mu_b, sigma_b, acc_b = _draw_workers(cfg, rng, lead + (P, cfg.bank))
    session = (rng.standard_exponential(lead + (P,))
               * cfg.session_mean_s).astype(np.float32)
    if cfg.retainer:
        blocked = np.zeros(lead + (P,), np.float32)   # synchronous fill
    else:                                              # Base-NR trickle-in
        blocked = (rng.standard_exponential(lead + (P,))
                   * cfg.cold_recruit_mean_s).astype(np.float32)
    zf = lambda: np.zeros(lead + (P,), np.float32)
    zi = lambda: np.zeros(lead + (P,), np.int32)
    banks = dict(mu=mu_b, sigma=sigma_b, acc=acc_b)
    ws = dict(
        mu=mu_b[..., 0], sigma=sigma_b[..., 0], acc=acc_b[..., 0],
        repl_idx=zi(), busy_until=np.full(lead + (P,), np.inf, np.float32),
        assigned=np.full(lead + (P,), -1, np.int32), start_t=zf(),
        blocked_until=blocked, session_end=blocked + session,
        n_started=zi(), n_completed=zi(), n_terminated=zi(),
        comp_sum=zf(), comp_sqsum=zf(), term_sum=zf(),
        cost_wait=np.zeros(lead, np.float32),
        cost_work=np.zeros(lead, np.float32),
        n_evicted=np.zeros(lead, np.int32), n_churned=np.zeros(lead, np.int32),
    )
    if cfg.trace is not None:
        # cumulative assignment / duplication counts, per replication like
        # the cost accumulators, so slot churn never resets them
        ws["tr_assigned"] = np.zeros(lead, np.int32)
        ws["tr_dups"] = np.zeros(lead, np.int32)
    return ws, banks


# --------------------------------------------------------------------------
# TermEst and the empirical latency spread
# --------------------------------------------------------------------------

def _termest(cfg: FastConfig, ws):
    """Vectorized TermEst (censoring-corrected latency) over all slots."""
    n = ws["n_started"].to(torch.float32)
    nc = ws["n_completed"].to(torch.float32)
    nt = ws["n_terminated"].to(torch.float32)
    l_tc = ws["comp_sum"] / torch.clamp(nc, min=1.0)
    l_f = ws["term_sum"] / torch.clamp(nt, min=1.0)
    l_tt = l_f * (n + cfg.alpha) / (nc + cfg.alpha)
    est = torch.where(nt == 0, l_tc,
                      (nt / torch.clamp(n, min=1.0)) * l_tt
                      + (nc / torch.clamp(n, min=1.0)) * l_tc)
    return torch.where(n > 0, est, torch.full_like(est, math.nan))


def _emp_std(ws):
    nc = ws["n_completed"].to(torch.float32)
    var = (ws["comp_sqsum"] - ws["comp_sum"] ** 2 / torch.clamp(nc, min=1.0)) \
        / torch.clamp(nc - 1.0, min=1.0)
    sd = torch.sqrt(torch.clamp(var, min=0.0))
    return torch.where(nc >= 2, sd, torch.full_like(sd, math.nan))


def _exp(u, mean):
    """Inverse-CDF exponential from a uniform [0,1) draw."""
    return -torch.log1p(-u) * mean


# --------------------------------------------------------------------------
# counter-based randomness (lowbias32), bit-exact with the reference
# --------------------------------------------------------------------------

def _mul32(x, c: int):
    """(x * c) mod 2^32 for int64 ``x`` in [0, 2^32) and a 32-bit constant,
    with every intermediate below 2^49."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & MASK32


def _lowbias32(x):
    """Strong-avalanche 32-bit integer hash (lowbias32) on int64 tensors
    holding uint32 values."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x


def _uniform_block(seed, step: int, n: int):
    """(..., n) uniforms in [0, 1) from (seed, step) counters.

    ``seed`` is an int64 tensor of uint32 values (any leading shape);
    ``step`` is a host integer (the tick), taken mod 2^32 as the
    reference's ``uint32`` cast does."""
    stepmix = ((int(step) & MASK32) * 0x9E3779B9) & MASK32
    base = _lowbias32(seed ^ stepmix)
    # built on the device: a host-to-device copy would wait for the stream
    ctr = _mul32(torch.arange(n, dtype=torch.int64, device=seed.device),
                 0x85EBCA6B)
    h = _lowbias32((base[..., None] + ctr) & MASK32)
    return (h >> 8).to(torch.float32) * (1.0 / (1 << 24))


# --------------------------------------------------------------------------
# matching, latency draws, churn
# --------------------------------------------------------------------------

def priority_match(avail, tier1, tier2, shift):
    """Rank-based two-tier matching of available workers onto eligible task
    slots, batched over leading dims.

    The r-th available worker (by slot index) takes the r-th eligible task,
    draining ``tier1`` tasks first and then ``tier2``; task order inside a
    tier is slot order rotated by ``shift`` (one value per batch element,
    so the rotation is a gather rather than a roll). Returns ``(take,
    task_for_w, took_tier1, n_tier1)``.
    """
    B = tier1.shape[-1]
    rot = (torch.arange(B, device=tier1.device) + shift[..., None]) % B
    t1_r = torch.gather(tier1, -1, rot)
    t2_r = torch.gather(tier2, -1, rot)
    c1 = torch.cumsum(t1_r.to(torch.int64), -1)
    c2 = torch.cumsum(t2_r.to(torch.int64), -1)
    n1 = c1[..., -1:]
    n_elig = n1 + c2[..., -1:]
    # rank->task lookup without a (P, B) match matrix: the r-th eligible
    # task is the first index where the running count reaches r+1
    wrank = torch.cumsum(avail.to(torch.int64), -1) - 1
    q1 = torch.searchsorted(c1.contiguous(), (wrank + 1).contiguous())
    q2 = torch.searchsorted(c2.contiguous(), (wrank - n1 + 1).contiguous())
    take = avail & (wrank < n_elig)
    task_rot = torch.where(wrank < n1, q1, q2)
    task_for_w = (torch.clamp(task_rot, 0, B - 1) + shift[..., None]) % B
    took_tier1 = take & (wrank < n1)
    return take, task_for_w, took_tier1, n1[..., 0]


def _replace_slots(cfg: FastConfig, ws, banks, leave, t, u_delay, u_sess,
                   recruit_mean, session_mean=None):
    """Slots in ``leave`` exit the pool; fresh workers from the pre-drawn
    bank arrive after an exponential recruitment delay."""
    if session_mean is None:
        session_mean = cfg.session_mean_s
    idx = torch.clamp(ws["repl_idx"] + 1, max=cfg.bank - 1)
    sel = lambda new, old: torch.where(leave, new, old)
    pick = lambda bank: torch.gather(bank, -1, idx[..., None].long())[..., 0]
    ws = dict(ws)
    ws["mu"] = sel(pick(banks["mu"]), ws["mu"])
    ws["sigma"] = sel(pick(banks["sigma"]), ws["sigma"])
    ws["acc"] = sel(pick(banks["acc"]), ws["acc"])
    ws["repl_idx"] = sel(idx, ws["repl_idx"])
    arrive = t + _exp(u_delay, recruit_mean)
    ws["blocked_until"] = sel(arrive, ws["blocked_until"])
    ws["session_end"] = sel(arrive + _exp(u_sess, session_mean),
                            ws["session_end"])
    for f in ("n_started", "n_completed", "n_terminated",
              "comp_sum", "comp_sqsum", "term_sum"):
        ws[f] = sel(torch.zeros_like(ws[f]), ws[f])
    return ws


def draw_latency(cfg: FastConfig, mu, sigma, u1, u2):
    """Floored Box-Muller worker-latency draw from two uniform blocks."""
    nrm = torch.sqrt(-2.0 * torch.log1p(-u1)) * torch.cos(2.0 * math.pi * u2)
    return torch.clamp(mu + sigma * nrm, min=cfg.latency_floor)


def churn_and_maintain(cfg: FastConfig, ws, banks, t, u_delay, u_sess,
                       recruit_mean, session_mean=None):
    """Session churn + PM_l latency eviction + bank backfill, vectorized.

    Idle workers whose session ended leave; with a finite ``pm_l``, idle
    live workers whose TermEst latency estimate significantly exceeds it
    (one-sided test) are evicted too. Departing slots are refilled from the
    banks after an exponential recruitment delay. Returns ``(ws, leave)``.
    """
    ws = dict(ws)
    idle = ws["assigned"] < 0
    arrived = ws["blocked_until"] <= t
    churned = idle & arrived & (ws["session_end"] <= t)
    ws["n_churned"] = ws["n_churned"] + churned.sum(-1)
    leave = churned
    if math.isfinite(cfg.pm_l):
        live = arrived & (ws["session_end"] > t)
        if cfg.use_termest:
            est = _termest(cfg, ws)
        else:
            est = torch.where(
                ws["n_completed"] > 0,
                ws["comp_sum"] / torch.clamp(
                    ws["n_completed"].to(torch.float32), min=1.0),
                torch.full_like(ws["comp_sum"], math.nan))
        s = _emp_std(ws)
        s = torch.where(torch.isfinite(s) & (s > 0), s, 0.5 * est)
        n_eff = torch.clamp(ws["n_completed"] + ws["n_terminated"], min=1
                            ).to(torch.float32)
        signif = (est - cfg.pm_l) >= cfg.z * s / torch.sqrt(n_eff)
        evict = (idle & live & (ws["n_started"] >= cfg.min_obs)
                 & torch.isfinite(est) & (est > cfg.pm_l) & signif)
        ws["n_evicted"] = ws["n_evicted"] + evict.sum(-1)
        leave = churned | evict
    ws = _replace_slots(cfg, ws, banks, leave, t, u_delay, u_sess,
                        recruit_mean, session_mean)
    return ws, leave


# --------------------------------------------------------------------------
# the batch engine: one tick over the current batch
# --------------------------------------------------------------------------

# how often (in steps) _run_batch asks the host whether any replication is
# still running; each ask waits for the device
_ALIVE_EVERY = 8


def _tick(cfg: FastConfig, ws, ts, banks, true_label, t0, t, seed, step: int,
          pop: Optional[dict] = None):
    """Process all events at/before time ``t`` and make new assignments,
    for every replication at once: ``ws`` holds ``(R, P)`` worker state,
    ``ts`` ``(R, B[, C])`` task state, ``true_label`` ``(R, B)``, ``t0``,
    ``t`` and ``seed`` are ``(R,)``; ``step`` is the host tick index.
    ``pop`` holds a sweep's per-row ``recruit`` and ``session`` means as
    ``(R, 1)`` tensors (None: the config's). Returns ``(ws, ts,
    t_next)``, op for op the reference's float32 arithmetic."""
    P, B, C = cfg.pool_size, cfg.eff_batch, cfg.n_classes
    R = t.shape[0]
    dev = t.device
    up = _uniform_block(seed, step, 8 * P).reshape(R, 8, P)
    tc = t[:, None]
    ws = dict(ws)
    active = ws["assigned"] >= 0

    # ---- completions: P-update scatters into a padded (B+1)-row table
    # (row B is the discard row for idle workers)
    comp = active & (ws["busy_until"] <= tc)
    tid = torch.where(comp, ws["assigned"], B)
    lat = torch.where(comp, ws["busy_until"] - ws["start_t"], 0.0)
    a_idx = torch.clamp(ws["assigned"], min=0)
    tl_w = torch.where(comp, torch.gather(true_label, 1, a_idx), 0)
    correct = up[:, 0] < ws["acc"]
    wrong = torch.floor(up[:, 1] * max(C - 1, 1)).to(torch.int64)
    label = torch.where(correct, tl_w,
                        torch.where(wrong >= tl_w, wrong + 1, wrong))
    votes = torch.cat([ts["votes"],
                       torch.zeros((R, 1, C), dtype=torch.float32,
                                   device=dev)], 1).reshape(R, (B + 1) * C)
    votes = _add_at(votes, tid * C + label,
                    comp.to(torch.float32)).reshape(R, B + 1, C)[:, :B]

    # ---- task completion (majority-vote QC)
    win_lat = torch.zeros((R, B + 1), device=dev).scatter_reduce_(
        1, tid, lat, "amax")[:, :B]
    win_t = torch.full((R, B + 1), INF, device=dev).scatter_reduce_(
        1, tid, torch.where(comp, ws["busy_until"], INF), "amin")[:, :B]
    win_t = torch.where(torch.isfinite(win_t), win_t, 0.0)
    nv = votes.sum(-1)
    newly = ~ts["done"] & (nv >= cfg.votes_needed)
    done = ts["done"] | newly
    ts = dict(votes=votes, done=done,
              completed=torch.where(newly, win_t, ts["completed"]),
              last_lat=torch.where(newly, win_lat, ts["last_lat"]))

    # ---- straggler losers of a newly done task, merged worker writes
    lose = active & ~comp & torch.gather(done, 1, a_idx)
    winner = torch.where(lose, torch.gather(ts["last_lat"], 1, a_idx), 0.0)
    freed = comp | lose
    ws["n_completed"] = ws["n_completed"] + comp
    ws["n_terminated"] = ws["n_terminated"] + lose
    ws["comp_sum"] = ws["comp_sum"] + lat * comp
    ws["comp_sqsum"] = ws["comp_sqsum"] + lat * lat * comp
    ws["term_sum"] = ws["term_sum"] + winner * lose
    ws["cost_work"] = ws["cost_work"] + (
        freed.sum(-1) * cfg.n_records * WORK_PAY_PER_RECORD)
    # blocked_until doubles as "available since": completers free at their
    # exact completion instant, losers at the winning vote + switch delay
    ws["blocked_until"] = torch.where(
        comp, ws["busy_until"],
        torch.where(lose, torch.gather(ts["completed"], 1, a_idx)
                    + SWITCH_DELAY_S, ws["blocked_until"]))
    ws["assigned"] = torch.where(freed, -1, ws["assigned"])
    ws["busy_until"] = torch.where(freed, INF, ws["busy_until"])

    # ---- churn + pool maintenance (single backfill update)
    rm = cfg.recruit_mean_s if cfg.retainer else cfg.cold_recruit_mean_s
    sm = None
    if pop is not None:
        rm, sm = pop["recruit"], pop["session"]
    ws, _ = churn_and_maintain(cfg, ws, banks, tc, up[:, 2], up[:, 3], rm,
                               sm)

    # ---- assignment (priority routing + straggler duplication)
    avail = (ws["assigned"] < 0) & (ws["blocked_until"] <= tc) \
        & (ws["session_end"] > tc)
    n_active = torch.zeros((R, B + 1), dtype=torch.int64, device=dev
                           ).scatter_add_(
        1, torch.where(ws["assigned"] >= 0, ws["assigned"], B),
        torch.ones_like(ws["assigned"]))[:, :B]
    open_t = ~done
    unass = open_t & (n_active == 0)
    if cfg.straggler:
        missing = cfg.votes_needed - nv
        mitig = open_t & (n_active >= 1) & (n_active < missing + 1) \
            & (n_active <= cfg.max_dup)
    else:
        mitig = torch.zeros_like(open_t)
    shift = (_uniform_block(seed ^ 0xA5A5A5A5, step, 1)[:, 0] * B
             ).to(torch.int64)
    take, task_for_w, took_unass, n_un = priority_match(
        avail, unass, mitig, shift)
    # a worker drawing from the unassigned queue starts at its exact free
    # moment; a mitigation duplicate only starts once the tick observes it
    start = torch.where(took_unass,
                        torch.maximum(ws["blocked_until"], t0[:, None]), tc)
    lat_new = draw_latency(cfg, ws["mu"], ws["sigma"], up[:, 6], up[:, 7]) \
        * max(1, cfg.n_records) ** 0.9
    ws["assigned"] = torch.where(take, task_for_w, ws["assigned"])
    ws["busy_until"] = torch.where(take, start + lat_new, ws["busy_until"])
    ws["start_t"] = torch.where(take, start, ws["start_t"])
    ws["n_started"] = ws["n_started"] + take
    if cfg.trace is not None:
        # a take outside the unassigned tier is a straggler duplicate
        ws["tr_assigned"] = ws["tr_assigned"] + take.sum(-1)
        ws["tr_dups"] = ws["tr_dups"] + (take & ~took_unass).sum(-1)

    # ---- event jump: hop to the next completion/arrival/session end
    busy_min = ws["busy_until"].amin(-1)
    arr_min = torch.where(ws["blocked_until"] > tc, ws["blocked_until"],
                          INF).amin(-1)
    sess_min = torch.where(ws["assigned"] < 0, ws["session_end"],
                           INF).amin(-1)
    next_evt = torch.minimum(torch.minimum(busy_min, arr_min), sess_min)
    more_unass = n_un > took_unass.sum(-1)
    dt_eff = torch.where(more_unass, cfg.bundle_s, cfg.mitig_bundle_s)
    t_next = torch.where(busy_min <= t, t,
                         torch.maximum(t + dt_eff, next_evt))
    # pay idle live workers for the upcoming quiet interval [t, t_next)
    waiting = avail & ~take
    ws["cost_wait"] = ws["cost_wait"] + \
        waiting.sum(-1) * (t_next - t) * WAIT_PAY_PER_S
    return ws, ts, t_next


def _run_batch(cfg: FastConfig, ws, banks, t0, seed, true_labels, valid,
               pop: Optional[dict] = None):
    """Label one batch to completion in every replication: the reference's
    event-jumping ``while_loop`` under ``vmap``. A replication whose
    condition (open tasks, step budget, time budget) is false keeps its
    carry; the loop ends when none is left. ``pop`` as in :func:`_tick`.
    Returns ``(ws, ts, t_end, steps)`` with ``steps`` the ``(R,)`` tick
    counts."""
    R, B = t0.shape[0], cfg.eff_batch
    dev = t0.device
    ts = dict(
        votes=torch.zeros((R, B, cfg.n_classes), device=dev),
        done=~valid,                       # padding rows are born done
        completed=torch.zeros((R, B), device=dev),
        last_lat=torch.zeros((R, B), device=dev))
    steps = torch.zeros((R,), dtype=torch.int64, device=dev)
    t = t0 + cfg.dt
    t_max = t0 + cfg.max_batch_time
    for i in range(cfg.batch_steps):
        # every replication still running has made exactly i steps, so the
        # host index i is its own step counter
        alive = ~ts["done"].all(-1) & (t <= t_max)
        if i % _ALIVE_EVERY == 0 and not bool(alive.any()):
            break
        ws_n, ts_n, t_n = _tick(cfg, ws, ts, banks, true_labels, t0, t,
                                seed, i, pop)
        a1 = alive[:, None]
        ws = {k: torch.where(alive if v.dim() == 1 else a1, v, ws[k])
              for k, v in ws_n.items()}
        ts = {k: torch.where(alive.reshape((R,) + (1,) * (v.dim() - 1)),
                             v, ts[k]) for k, v in ts_n.items()}
        t = torch.where(alive, t_n, t)
        steps = steps + alive
    t_end = torch.maximum(ts["completed"].amax(-1), t0)
    # a batch that hit its time/step budget can leave workers mid-task;
    # terminate those assignments so they cannot vote into the next batch
    still = ws["assigned"] >= 0
    ws["assigned"] = torch.where(still, -1, ws["assigned"])
    ws["busy_until"] = torch.where(still, INF, ws["busy_until"])
    return ws, ts, t_end, steps


def _simulate_one(cfg: FastConfig, ws, banks, seed, true_labels, pop=None):
    """All replications of one labeling run: the batches in order, each
    labeled to completion by :func:`_run_batch`. ``ws``/``banks`` are the
    initial pool state on the device, ``seed`` the ``(R,)`` uint32 counter
    seeds (int64), ``true_labels`` ``(n_tasks,)`` or ``(R, n_tasks)``,
    ``pop`` a sweep's per-row means (see :func:`_tick`). Returns the
    reference's outputs with leading dim R, plus ``n_ticks`` ``(R,
    n_batches)``; with a trace also the per-batch ``trace_*`` counters
    ``(R, n_batches)`` (``trace_assigned``, ``trace_dups``,
    ``trace_churned`` and ``trace_evicted`` cumulative)."""
    if cfg.trace is not None and not isinstance(cfg.trace, TraceConfig):
        raise TypeError("FastConfig.trace must be None or a TraceConfig "
                        "(repro_torch.obs.trace), got "
                        f"{type(cfg.trace).__name__}")
    if pop is not None and not isinstance(pop, dict):
        raise TypeError("pop must be None or a dict of per-row 'recruit' "
                        "and 'session' means (simulate_swept_pop builds "
                        f"it), got {type(pop).__name__}")
    R = seed.shape[0]
    dev = seed.device
    B, T, nb = cfg.eff_batch, cfg.n_tasks, cfg.n_batches
    pad = nb * B - T
    labels = torch.as_tensor(true_labels, device=dev).to(torch.int64)
    labels = labels.expand(R, T) if labels.dim() == 1 else labels
    labels = torch.cat([labels, torch.zeros((R, pad), dtype=torch.int64,
                                            device=dev)], 1).reshape(R, nb, B)
    valid = torch.cat([torch.ones((T,), dtype=torch.bool, device=dev),
                       torch.zeros((pad,), dtype=torch.bool, device=dev)]
                      ).reshape(nb, B)
    t = torch.zeros((R,), device=dev)
    outs = []
    for i in range(nb):
        mix = ((i + 1) * 0x9E3779B9) & MASK32
        seed_b = _lowbias32(seed ^ mix)
        val = valid[i].expand(R, B)
        ws, ts, t_end, steps = _run_batch(cfg, ws, banks, t, seed_b,
                                          labels[:, i], val, pop)
        fin = ts["done"] & val
        outs.append(dict(latency=torch.where(fin, ts["completed"] - t[:, None],
                                             0.0),
                         done=fin, result=ts["votes"].argmax(-1),
                         n_ticks=steps))
        if cfg.trace is not None:
            # the per-batch series; the counters are cumulative snapshots
            # (the exporter diffs them)
            outs[-1].update(
                trace_ticks=steps, trace_votes=ts["votes"].sum((1, 2)),
                trace_done=fin.sum(-1), trace_assigned=ws["tr_assigned"],
                trace_dups=ws["tr_dups"], trace_churned=ws["n_churned"],
                trace_evicted=ws["n_evicted"], trace_batch_end=t_end)
        t = t_end
    cat = lambda k: torch.cat([o[k] for o in outs], 1)
    done, result = cat("done"), cat("result")
    res = dict(
        latency=cat("latency")[:, :T],
        result=result[:, :T],
        done=done[:, :T],
        total_time=t,
        # undone tasks count against accuracy
        accuracy=((result == labels.reshape(R, -1)) & done).sum(-1)
        / max(T, 1),
        cost=ws["cost_wait"] + ws["cost_work"],
        cost_wait=ws["cost_wait"],
        cost_work=ws["cost_work"],
        n_evicted=ws["n_evicted"],
        n_churned=ws["n_churned"],
        mean_pool_mu=ws["mu"].mean(-1),
        n_ticks=torch.stack([o["n_ticks"] for o in outs], 1),
    )
    for k in outs[0]:
        if k.startswith("trace_"):
            res[k] = torch.stack([o[k] for o in outs], 1)
    return res


def _to_device(a, device):
    a = np.asarray(a)
    if a.dtype == np.bool_:
        return torch.tensor(a, dtype=torch.bool, device=device)
    if np.issubdtype(a.dtype, np.integer):
        return torch.tensor(a.astype(np.int64), device=device)
    return torch.tensor(a, dtype=torch.float32, device=device)


def draw_batch_init(cfg: FastConfig, n_reps: int, rng: np.random.Generator):
    """One run's initial draws for ``n_reps`` replications, as numpy: the
    worker state and banks of :func:`_init_workers` and the ``uint32``
    counter seeds. Returns ``dict(ws=..., banks=..., seed=...)``, the form
    ``simulate(draws=...)`` takes."""
    ws, banks = _init_workers(cfg, rng, (n_reps,))
    seed = rng.integers(0, 2 ** 32, (n_reps,), dtype=np.uint64)
    return dict(ws=ws, banks=banks, seed=seed)


def _draws_to_device(draws, device):
    """``draws`` (numpy, or ``u`` already a tensor) as tensors on
    ``device``: the seeds as int64, a learning round's uniforms ``u`` as
    float32."""
    out = dict(
        ws={k: _to_device(v, device) for k, v in draws["ws"].items()},
        banks={k: _to_device(v, device) for k, v in draws["banks"].items()},
        seed=torch.tensor(np.asarray(draws["seed"]).astype(np.uint32)
                          .astype(np.int64), device=device))
    if "u" in draws:
        u = draws["u"]
        out["u"] = (u.to(device, torch.float32) if torch.is_tensor(u) else
                    torch.tensor(np.asarray(u), dtype=torch.float32,
                                 device=device))
    return out


def _split_mesh(device, devices, shard: bool) -> StreamMesh:
    """The devices of the replication split: ``devices`` if given, else
    every visible card for a CUDA ``device`` without an index, else
    ``device`` alone; the first of them alone without ``shard``."""
    if devices is not None:
        devs = [resolve_device(d) for d in devices]
        if not devs:
            raise ValueError("devices= must list at least one device")
    else:
        dev = resolve_device(device)
        devs = [dev]
        if dev.type == "cuda" and dev.index is None:
            devs = [torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())]
    return StreamMesh(tuple(devs if shard else devs[:1]))


def _split_rows(tree, n: int, mesh: StreamMesh):
    """``tree``'s leaves (leading dim ``n``) padded to a multiple of the
    mesh's size by repeating the last row, then split into one
    consecutive part per device (on that device)."""
    pad = (-n) % mesh.size
    grow = lambda x: torch.cat([x, x[-1:].expand((pad,) + x.shape[1:])])
    return shard_put(tree_map(grow, tree) if pad else tree, mesh, 0)


def _join_rows(parts, n: int, mesh: StreamMesh):
    """The inverse of :func:`_split_rows`: the parts' leaves concatenated
    in device order on the first device, the padding rows dropped."""
    return tree_map(lambda x: x[:n], shard_gather(parts, mesh, 0))


def _splits(mesh: StreamMesh, n: int) -> bool:
    # the reference splits only when every device gets a row
    return mesh.size > 1 and n >= mesh.size


def _on_rows(mesh: StreamMesh, n: int, tree, run):
    """``run(part, device)`` over the ``n`` rows of ``tree``: one part per
    device where the rows split (:func:`_split_rows`, joined back by
    :func:`_join_rows`), else ``tree`` whole on the first device."""
    if not _splits(mesh, n):
        return run(tree, mesh.devices[0])
    return _join_rows([run(p, g) for p, g in
                       zip(_split_rows(tree, n, mesh), mesh.devices)],
                      n, mesh)


def simulate(cfg: FastConfig, n_reps: int, *, seed: int = 0,
             true_labels=None, device="cuda", draws=None,
             shard: bool = True, devices=None):
    """Run ``n_reps`` independent replications of the labeling simulation
    in lock-step on ``device``.

    The initial worker pools, banks and counter seeds come from a numpy
    generator seeded with ``seed``, or from ``draws`` (see
    :func:`draw_batch_init`; a test injects the reference's). Returns a
    dict of tensors with leading dim ``n_reps``: latency, done and result
    ``(n_reps, n_tasks)``, total_time, accuracy, cost and pool counters,
    and the port's ``n_ticks`` ``(n_reps, n_batches)``.

    With several devices (``devices``, else every card for ``device=
    "cuda"``) and ``shard`` the replications are split across them (see
    the module docstring); the outputs land on the first device.
    """
    mesh = _split_mesh(device, devices, shard)
    dev = mesh.devices[0]
    if true_labels is None:
        true_labels = np.zeros(cfg.n_tasks, dtype=np.int64)
    if draws is None:
        draws = draw_batch_init(cfg, n_reps, np.random.default_rng(seed))
    d = _draws_to_device(draws, dev)
    if d["seed"].shape != (n_reps,):
        raise ValueError(f"draws hold {tuple(d['seed'].shape)} seeds for "
                         f"n_reps={n_reps}")
    labels = torch.as_tensor(np.asarray(true_labels).astype(np.int64),
                             device=dev)
    if labels.dim() == 2:
        d["labels"] = labels
    return _on_rows(mesh, n_reps, d, lambda p, g: _simulate_one(
        cfg, p["ws"], p["banks"], p["seed"], p.get("labels", labels.to(g))))


def simulate_swept(cfg: FastConfig, n_reps: int, scales: SimScales, *,
                   seed: int = 0, true_labels=None, shard: bool = True,
                   device="cuda", draws=None, devices=None):
    """Sweep over the :class:`SimScales` multipliers as one batched run
    (the ``scenarios.sweep`` backend for the batch engine's continuous
    pool axes). Each multiplier is resolved against the config in float32,
    as the reference's sweep multiplies, into the absolute values of
    :func:`simulate_swept_pop`. Returns outputs with leading dims ``(V,
    n_reps)``."""
    f32 = lambda x: np.asarray(_np_leaf(x), np.float32)
    mu, se, re = f32(scales.mu), f32(scales.session), f32(scales.recruit)
    pop = PopTraced(
        median_mu=np.float32(cfg.median_mu) * mu,
        session_mean_s=np.float32(cfg.session_mean_s) * se,
        recruit_mean_s=np.float32(cfg.recruit_mean_s) * re,
        cold_recruit_mean_s=np.float32(cfg.cold_recruit_mean_s) * re)
    return simulate_swept_pop(cfg, n_reps, pop, seed=seed,
                              true_labels=true_labels, shard=shard,
                              device=device, draws=draws, devices=devices)


def _np_leaf(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else x


def simulate_swept_pop(cfg: FastConfig, n_reps: int, pop: PopTraced, *,
                       seed: int = 0, true_labels=None, shard: bool = True,
                       timing_name: Optional[str] = None, device="cuda",
                       draws=None, devices=None):
    """Sweep over a :class:`PopTraced` bundle as one batched run: the
    leaves share a leading sweep axis ``(V,)`` (numbers broadcast); every
    point x replication is a row of one :func:`_simulate_one`. Point i
    draws its pools as ``simulate`` on the config with point i's values
    does for ``seed``, and its rows run the tick with its recruitment and
    session means, so it equals that run bit for bit. Values are read as
    float64 on the host (the draws are host numpy). With several devices
    (``devices``, else every card for ``device="cuda"``) and ``shard`` the
    rows are split across them (see the module docstring);
    ``timing_name`` records ``<timing_name>.execute`` in
    :mod:`repro_torch.obs.timing`. ``draws`` (a list of V dicts as
    :func:`draw_batch_init` returns; parity tests) replaces each point's
    draws. Returns outputs with leading dims ``(V, n_reps)``."""
    mesh = _split_mesh(device, devices, shard)
    dev = mesh.devices[0]
    t_start = time.perf_counter()
    if true_labels is None:
        true_labels = np.zeros(cfg.n_tasks, dtype=np.int64)
    raw = [np.asarray(_np_leaf(leaf), np.float64) for leaf in pop]
    V = max([a.shape[0] for a in raw if a.ndim > 0] or [1])
    leaves = PopTraced(*[np.broadcast_to(a, (V,)) for a in raw])
    if draws is not None and len(draws) != V:
        raise ValueError(f"draws holds {len(draws)} points, expected {V}")
    cfgs, dev_draws = [], []
    for i in range(V):
        point = {f: _ov(float(getattr(leaves, f)[i]), getattr(cfg, f))
                 for f in PopTraced._fields}
        cfgs.append(dataclasses.replace(cfg, **point))
        d = draws[i] if draws is not None else draw_batch_init(
            cfgs[-1], n_reps, np.random.default_rng(seed))
        dev_draws.append(_draws_to_device(d, dev))
    cat = lambda part: {k: torch.cat([d[part][k] for d in dev_draws])
                        for k in dev_draws[0][part]}
    per_row = lambda vals: torch.tensor(
        vals, dtype=torch.float32, device=dev
    ).repeat_interleave(n_reps)[:, None]
    rows = dict(
        ws=cat("ws"), banks=cat("banks"),
        seed=torch.cat([d["seed"] for d in dev_draws]),
        pop=dict(recruit=per_row([c.recruit_mean_s if c.retainer
                                  else c.cold_recruit_mean_s for c in cfgs]),
                 session=per_row([c.session_mean_s for c in cfgs])))
    labels = torch.as_tensor(np.asarray(true_labels).astype(np.int64),
                             device=dev)
    out = _on_rows(mesh, V * n_reps, rows, lambda p, g: _simulate_one(
        cfg, p["ws"], p["banks"], p["seed"], labels.to(g), p["pop"]))
    out = {k: v.reshape((V, n_reps) + tuple(v.shape[1:]))
           for k, v in out.items()}
    if timing_name is not None:
        for d in mesh.devices:
            if d.type == "cuda":
                torch.cuda.synchronize(d)
        timing.record(f"{timing_name}.execute",
                      time.perf_counter() - t_start)
    return out


# --------------------------------------------------------------------------
# hybrid / active learning on the batch engine
# --------------------------------------------------------------------------

def _learner_round(bcfg: FastConfig, X, y, X_test, y_test, k_active: int,
                   n_passive: int, fit_steps: int, decision_latency_s: float,
                   use_kernel, W, b, labeled, y_obs, t_sim, draw):
    """One select -> fit -> crowd-vote -> bookkeeping round for every
    replication, in the reference's order: entropy on the pre-fit model,
    ``hybrid_select``, a fresh-Adam ``fit`` on the labels so far, one crowd
    batch of the chosen points, the dump-row scatter of the new labels,
    then ``test_accuracy``.

    ``W``/``b`` are ``(R, d, C)``/``(R, C)``, ``labeled``/``y_obs``
    ``(R, n)``, ``t_sim`` ``(R,)``; ``draw`` holds the round's randomness
    on the device: ``u`` ``(R, n)`` passive uniforms and the crowd batch's
    ``ws``, ``banks`` and ``seed``. Returns ``(W, b, labeled, y_obs,
    t_sim, aux)``."""
    n = labeled.shape[-1]
    st = linear.with_params(W, b)
    ent = linear.entropy(st, X, use_kernel=use_kernel)
    chosen, take, act_mask = lsel.hybrid_select(draw["u"], ent, labeled,
                                                k_active, n_passive)
    st = linear.fit(st, X, y_obs, labeled.to(torch.float32),
                    steps=fit_steps)
    out = _simulate_one(bcfg, draw["ws"], draw["banks"], draw["seed"],
                        y[chosen])
    done = out["done"] & take
    # padding entries of `chosen` (take=False) may repeat valid indices;
    # scatter through a dump column so no point receives two updates
    chosen_w = torch.where(done, chosen, n)
    pad = lambda a: torch.cat([a, torch.zeros_like(a[:, :1])], 1)
    y_obs = pad(y_obs).scatter_(1, chosen_w, out["result"])[:, :n]
    labeled = pad(labeled).scatter_(1, chosen_w, True)[:, :n]
    t_sim = t_sim + out["total_time"] + decision_latency_s
    acc = linear.test_accuracy(st, X_test, y_test)
    return (st.W, st.b, labeled, y_obs, t_sim,
            dict(acc=acc, act_mask=act_mask, ent=ent, chosen=chosen,
                 take=take, done=done, total_time=out["total_time"],
                 n_ticks=out["n_ticks"][:, 0]))


def make_learner_step(n_passive: int, k_active: int, fit_steps: int = 60,
                      use_kernel=True):
    """Batched hybrid-learning step (paper §5.1 point selection), the
    round's learner half without the crowd batch.

    ``step(W, b, X, labeled, y_obs, u)`` scores every point's predictive
    entropy through :func:`repro_torch.learning.linear.entropy` (the
    ``entropy_scores`` kernel for CUDA tensors, unless ``use_kernel`` is
    False), picks the top-``k_active`` unlabeled points (ties by index)
    and ``n_passive`` random ones by the ranks of the caller's uniforms
    ``u`` (one per point), and fits fresh-Adam full-batch on the labeled
    set (``labeled`` as the row weights). Returns ``(W, b, chosen,
    act_mask)``; every argument may carry leading replication dims."""
    uk = None if use_kernel else False

    def step(W, b, X, labeled, y_obs, u):
        st = linear.with_params(W, b)
        ent = linear.entropy(st, X, use_kernel=uk)
        chosen, _take, act_mask = lsel.hybrid_select(u, ent, labeled,
                                                     k_active, n_passive)
        st = linear.fit(st, X, y_obs, labeled.to(torch.float32),
                        steps=fit_steps)
        return st.W, st.b, chosen, act_mask

    return step


def draw_round(bcfg: FastConfig, n_reps: int, n: int,
               rng: np.random.Generator, gen: torch.Generator):
    """One learning round's randomness for ``n_reps`` replications over
    ``n`` points: the passive uniforms ``u`` ``(n_reps, n)`` from ``gen``
    on its device, and the crowd batch's fresh pool, banks and seeds from
    ``rng`` (host numpy, as :func:`draw_batch_init`)."""
    u = torch.rand((n_reps, n), generator=gen, device=gen.device)
    return dict(u=u, **draw_batch_init(bcfg, n_reps, rng))


def _learning_setup(cfg: FastConfig, X, y, X_test, y_test, k_active, dev):
    X = torch.as_tensor(np.asarray(X, np.float32), device=dev)
    X_test = torch.as_tensor(np.asarray(X_test, np.float32), device=dev)
    y_np = np.asarray(y).astype(np.int64)
    y = torch.as_tensor(y_np, device=dev)
    y_test = torch.as_tensor(np.asarray(y_test).astype(np.int64), device=dev)
    n_classes = int(y_np.max()) + 1
    p = cfg.pool_size
    if k_active is None:
        k_active = p // 2
    bcfg = dataclasses.replace(cfg, n_tasks=p, batch_size=p,
                               n_classes=n_classes)
    return X, y, X_test, y_test, n_classes, int(k_active), bcfg


def simulate_learning_batch(cfg: FastConfig, X, y, X_test, y_test, *,
                            rounds: int = 10, n_reps: int = 64,
                            k_active: Optional[int] = None, seed: int = 0,
                            fit_steps: int = 60,
                            decision_latency_s: float = 15.0,
                            use_kernel: bool = True, device="cuda",
                            draws=None, shard: bool = True, devices=None):
    """Vectorized hybrid learning: rounds as a Python loop, replications as
    the leading dim of every tensor, one entropy launch per round for all
    of them on each device.

    Each round draws, per replication, the passive uniforms (a
    ``torch.Generator`` on the first device seeded with ``seed``) and the
    crowd batch's fresh pool, banks and counter seed (a numpy generator
    seeded with ``seed``); ``draws`` (a sequence of ``rounds`` dicts as
    :func:`draw_round` returns) replaces them. ``use_kernel=False`` scores
    entropy with the plain version. With several devices (``devices``,
    else every card for ``device="cuda"``) and ``shard`` the replications
    are split across them (see the module docstring), each round's draws
    made at full width first.

    Returns a dict with ``curve`` = {t, n_labeled, acc}, each ``(n_reps,
    rounds + 1)``, and the final ``W``/``b``/``labeled``/``y_obs``/
    ``total_time``.
    """
    mesh = _split_mesh(device, devices, shard)
    dev = mesh.devices[0]
    X, y, X_test, y_test, C, k_active, bcfg = _learning_setup(
        cfg, X, y, X_test, y_test, k_active, dev)
    n, d = X.shape
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    split = _splits(mesh, n_reps)
    D = mesh.size if split else 1
    R = -(-n_reps // D)                  # replications per device, padded
    parts = []
    for g in range(D):
        gd = mesh.devices[g]
        st = linear.init(d, C, lead=(R,), device=gd)
        t = torch.zeros((R,), device=gd)
        parts.append(dict(
            data=tuple(a.to(gd) for a in (X, y, X_test, y_test)),
            W=st.W, b=st.b, t=t,
            labeled=torch.zeros((R, n), dtype=torch.bool, device=gd),
            y_obs=torch.zeros((R, n), dtype=torch.int64, device=gd)))
        acc0 = linear.test_accuracy(st, *parts[-1]["data"][2:])
        parts[-1]["curve"] = dict(t=[t], n_labeled=[
            parts[-1]["labeled"].sum(-1)], acc=[acc0])
    for r in range(rounds):
        draw = draws[r] if draws is not None else draw_round(
            bcfg, n_reps, n, rng, gen)
        dd = _draws_to_device(draw, dev)
        for dg, p in zip(_split_rows(dd, n_reps, mesh) if split else [dd],
                         parts):
            p["W"], p["b"], p["labeled"], p["y_obs"], p["t"], aux = \
                _learner_round(
                    bcfg, *p["data"], k_active, cfg.pool_size - k_active,
                    fit_steps, decision_latency_s, use_kernel, p["W"],
                    p["b"], p["labeled"], p["y_obs"], p["t"], dg)
            p["curve"]["t"].append(p["t"])
            p["curve"]["n_labeled"].append(p["labeled"].sum(-1))
            p["curve"]["acc"].append(aux["acc"])
    outs = [dict(curve={k: torch.stack(v, 1) for k, v in p["curve"].items()},
                 W=p["W"], b=p["b"], labeled=p["labeled"], y_obs=p["y_obs"],
                 total_time=p["t"]) for p in parts]
    return _join_rows(outs, n_reps, mesh) if split else outs[0]


def simulate_learning(cfg: FastConfig, X, y, X_test, y_test, *,
                      rounds: int = 10, k_active: Optional[int] = None,
                      seed: int = 0, fit_steps: int = 60,
                      decision_latency_s: float = 15.0,
                      use_kernel: bool = True, accest=None, device="cuda",
                      draws=None):
    """Hybrid learning loop, one replication per call (the scalar path).

    The same round as :func:`simulate_learning_batch` at one replication,
    with the simulated time summed on the host in float64, as the
    reference's scalar loop does. Pass an :class:`~repro_torch.learning.
    allocate.AccEst` as ``accest`` to re-split the active/passive budget
    between rounds from leave-one-arm-out refits. Returns ``(curve, info)``
    with ``curve = [(sim_time, n_labeled, test_acc)]``.
    """
    dev = resolve_device(device)
    X, y, X_test, y_test, C, k_active, bcfg = _learning_setup(
        cfg, X, y, X_test, y_test, k_active, dev)
    n, d = X.shape
    p = cfg.pool_size
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    st = linear.init(d, C, lead=(1,), device=dev)
    W, b = st.W, st.b
    labeled = torch.zeros((1, n), dtype=torch.bool, device=dev)
    y_obs = torch.zeros((1, n), dtype=torch.int64, device=dev)
    t_sim = 0.0

    def test_acc(W, b):
        return float(linear.test_accuracy(linear.with_params(W, b), X_test,
                                          y_test)[0])

    def refit_acc(sw):
        st = linear.fit(linear.with_params(W, b), X, y_obs, sw,
                        steps=fit_steps)
        return test_acc(st.W, st.b)

    curve = [(0.0, 0, test_acc(W, b))]
    for r in range(rounds):
        draw = draws[r] if draws is not None else draw_round(
            bcfg, 1, n, rng, gen)
        W, b, labeled, y_obs, _, aux = _learner_round(
            bcfg, X, y, X_test, y_test, k_active, p - k_active, fit_steps,
            decision_latency_s, use_kernel, W, b, labeled, y_obs,
            torch.zeros((1,), device=dev), _draws_to_device(draw, dev))
        t_sim += float(aux["total_time"][0]) + decision_latency_s
        curve.append((t_sim, int(labeled.sum()), float(aux["acc"][0])))
        if accest is not None:
            # leave-one-arm-out counterfactual: credit each arm the test
            # accuracy its newly bought labels add to a refit on all labels
            chosen, done = aux["chosen"][0], aux["done"][0]
            act = aux["act_mask"][0][chosen]
            act_pts, pas_pts = chosen[act & done], chosen[~act & done]
            lab_f = labeled.to(torch.float32)
            drop_act, drop_pas = lab_f.clone(), lab_f.clone()
            drop_act[0, act_pts] = 0.0
            drop_pas[0, pas_pts] = 0.0
            acc_full = refit_acc(lab_f)
            g_act = (acc_full - refit_acc(drop_act)) / max(len(act_pts), 1)
            g_pas = (acc_full - refit_acc(drop_pas)) / max(len(pas_pts), 1)
            k_active = min(p, max(0, int(round(
                accest.update(g_act, g_pas) * p))))
    return curve, dict(W=W[0], b=b[0], labeled=labeled[0], y_obs=y_obs[0])
