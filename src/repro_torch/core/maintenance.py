"""Pool maintenance (§4.2) and TermEst (§4.3).

Maintenance evicts workers whose estimated mean latency is significantly above
the threshold PM_l (one-sided test), replacing them from the pipelined reserve.

Straggler mitigation censors latency observations (slow tasks get terminated),
which silently disables maintenance — the paper observed replacements dropping
from ~30 to <5 per run. TermEst reconstructs the latency of terminated tasks:

    l_s,Tt = l_f * (N + alpha) / (N_c + alpha)
    l_s    = (N_t/N) * l_s,Tt + (N_c/N) * l_s,Tc

where l_f is the mean latency of the workers that caused this worker's
terminations, N = tasks started, N_c completed, N_t terminated.

Port of ``src/repro/core/maintenance.py``. The latency test is host
arithmetic, copied. The quality sweep's Dawid-Skene EM runs on the
:class:`Maintainer`'s ``device`` through
:func:`repro_torch.core.quality.em_worker_accuracy` (on the card, one
``ds_estep`` launch per EM iteration).
"""
from __future__ import annotations

import math
from typing import Optional

from repro_torch.core.crowd import RetainerPool
from repro_torch.core.workers import Worker


def termest_latency(w: Worker, alpha: float = 1.0) -> float:
    """TermEst estimate of a worker's true mean latency under censoring."""
    n, nc, nt = w.n_started, w.n_completed, w.n_terminated
    if n == 0:
        return float("nan")
    l_tc = (w.completed_latency_sum / nc) if nc else 0.0
    if nt == 0:
        return l_tc
    l_f = w.terminator_latency_sum / nt
    l_tt = l_f * (n + alpha) / (nc + alpha)
    return (nt / n) * l_tt + (nc / n) * l_tc


class Maintainer:
    """Threshold-based eviction with significance test + TermEst correction."""

    def __init__(self, pool: RetainerPool, pm_l: float = float("inf"), *,
                 use_termest: bool = True, min_obs: int = 3,
                 z: float = 1.0, alpha: float = 1.0,
                 quality_threshold: Optional[float] = None, lifeguard=None,
                 device="cuda"):
        self.pool = pool
        self.device = device             # where the quality EM runs
        self.pm_l = pm_l
        self.use_termest = use_termest
        self.min_obs = min_obs
        self.z = z
        self.alpha = alpha
        self.quality_threshold = quality_threshold
        self.lifeguard = lifeguard       # vote window for quality EM
        self.replaced_log: list = []     # (time, wid, est_latency)
        self.quality_evictions: list = []

    @property
    def enabled(self):
        return math.isfinite(self.pm_l)

    def estimate(self, w: Worker) -> float:
        if self.use_termest:
            return termest_latency(w, self.alpha)
        return w.emp_mean if w.n_completed else float("nan")

    def observe(self, w: Worker):
        """Called by the LifeGuard after every completion/termination."""
        if not self.enabled or w.wid not in self.pool.workers:
            return
        if w.n_started < self.min_obs:
            return
        est = self.estimate(w)
        if not math.isfinite(est) or est <= self.pm_l:
            return
        # one-sided significance: est must exceed PM_l by z * sem
        s = w.emp_std
        if not math.isfinite(s) or s <= 0:
            s = 0.5 * est  # weak prior when censoring leaves no spread
        n_eff = max(w.n_completed + w.n_terminated, 1)
        if est - self.pm_l < self.z * s / math.sqrt(n_eff):
            return
        if w.doomed:
            return  # already leaving
        self.replaced_log.append((self.pool.loop.now, w.wid, est))
        self.pool.evict(w)

    def sweep_quality(self):
        """Paper §4.2 'Extensions' / §7 future work: maintain the pool on
        QUALITY using inter-worker agreement — Dawid-Skene EM over the
        recent vote window, evicting workers whose estimated accuracy is
        below the threshold."""
        lg = self.lifeguard
        if (self.quality_threshold is None or lg is None
                or len(lg.completed_votes) < 20):
            return
        from repro_torch.core.quality import em_worker_accuracy
        _, acc = em_worker_accuracy(lg.completed_votes[-120:],
                                    lg.n_classes_seen, iters=10,
                                    device=self.device)
        for w in list(self.pool.workers.values()):
            n_votes = sum(1 for votes in lg.completed_votes
                          for _, wid in votes if wid == w.wid)
            if (n_votes >= self.min_obs and not w.doomed
                    and acc.get(w.wid, 1.0) < self.quality_threshold):
                self.quality_evictions.append(
                    (self.pool.loop.now, w.wid, acc[w.wid]))
                self.pool.evict(w)

    def sweep(self):
        """Batch-boundary pass over the whole pool (paper: maintenance runs
        continuously and asynchronously; the sweep also catches workers whose
        FIRST task is already far beyond the threshold)."""
        self.sweep_quality()
        if not self.enabled:
            return
        now = self.pool.loop.now
        for w in list(self.pool.workers.values()):
            if w.busy:
                started = getattr(w, "current_started", None)
                if (started is not None and w.n_completed == 0
                        and now - started > 2 * self.pm_l):
                    if not w.doomed:
                        self.replaced_log.append((now, w.wid, now - started))
                        self.pool.evict(w)   # dooms; replaced on completion
                continue
            self.observe(w)
