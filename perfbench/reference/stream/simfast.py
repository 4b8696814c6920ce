"""The crowd-simulator pieces the stream tick uses (a frozen copy of the
program's ``core/simfast.py``, cut to them): the pool machinery's
:class:`FastConfig`, the worker draws, the counter-based ``lowbias32``
randomness, the latency and exponential draws, the two-tier
``priority_match``, TermEst and ``churn_and_maintain``.

The hash is computed in int64 masked to 32 bits, every product split into
16-bit halves so it stays exact in int64.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

INF = float("inf")
MASK32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class FastConfig:
    """The pool machinery's configuration (what ``StreamConfig.fast``
    hands it)."""
    pool_size: int = 15
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
    latency_floor: float = 2.0
    bank: int = 16


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
    are the fresh workers consumed by churn/eviction backfill."""
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
