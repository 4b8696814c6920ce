"""Worker populations W: per-worker (mu_i, sigma_i, lambda_i) drawn from
long-tailed distributions calibrated to the medical-deployment statistics the
paper reports in §2.1 (fastest worker mu=28.5s, median ~4min, per-worker means
spread from tens of seconds to hours, extreme 90th percentiles).

Task latency for an assignment is N(mu_i, sigma_i^2) i.i.d. truncated below —
exactly the paper's simulator model; labels are correct w.p. lambda_i.

The port's own copy of ``src/repro/core/workers.py``: host numpy only, every
draw from a ``np.random.Generator`` on the reference's seeds (``seed``,
``12345``), so the draws are the reference's bit for bit.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np


@dataclass
class Worker:
    wid: int
    mu: float            # true mean task latency (s)
    sigma: float         # true latency std (s)
    accuracy: float      # P(correct label)
    # runtime bookkeeping
    joined_at: float = 0.0
    busy: bool = False
    doomed: bool = False      # evicted/churned while busy -> leaves when idle
    # empirical observations (censored under straggler mitigation)
    n_started: int = 0
    n_completed: int = 0
    n_terminated: int = 0
    completed_latency_sum: float = 0.0
    completed_latency_sqsum: float = 0.0
    terminator_latency_sum: float = 0.0   # latencies of workers that beat us
    tasks_done: int = 0
    earned: float = 0.0
    wait_since: float = 0.0

    def sample_latency(self, rng: np.random.Generator) -> float:
        return float(max(2.0, rng.normal(self.mu, self.sigma)))

    def sample_label(self, true_label: int, n_classes: int,
                     rng: np.random.Generator) -> int:
        if rng.random() < self.accuracy:
            return true_label
        wrong = rng.integers(0, n_classes - 1)
        return int(wrong if wrong < true_label else wrong + 1)

    # --- empirical stats -------------------------------------------------
    @property
    def emp_mean(self) -> float:
        if self.n_completed == 0:
            return float("nan")
        return self.completed_latency_sum / self.n_completed

    @property
    def emp_std(self) -> float:
        n = self.n_completed
        if n < 2:
            return float("nan")
        v = (self.completed_latency_sqsum - self.completed_latency_sum**2 / n) / (n - 1)
        return float(np.sqrt(max(v, 0.0)))


@dataclass
class Population:
    """The global worker distribution W (the MTurk marketplace)."""
    median_mu: float = 150.0
    sigma_ln: float = 1.0          # log-normal shape for worker means
    cv_lo: float = 0.3             # per-worker sigma = mu * U(cv_lo, cv_hi)
    cv_hi: float = 1.2
    acc_a: float = 18.0            # Beta prior for accuracy (~0.9 mean)
    acc_b: float = 2.0
    seed: int = 0
    _rng: Optional[np.random.Generator] = field(default=None, repr=False)
    _next_id: int = 0

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)

    def draw(self) -> Worker:
        mu = float(self.median_mu * np.exp(self._rng.normal(0.0, self.sigma_ln)))
        mu = max(15.0, mu)
        sigma = mu * self._rng.uniform(self.cv_lo, self.cv_hi)
        acc = float(np.clip(self._rng.beta(self.acc_a, self.acc_b), 0.55, 0.995))
        w = Worker(self._next_id, mu, sigma, acc)
        self._next_id += 1
        return w

    # population statistics used by the PM_l convergence model (§4.2)
    def split_stats(self, pm_l: float, n: int = 200_000):
        rng = np.random.default_rng(12345)
        mus = np.maximum(
            15.0, self.median_mu * np.exp(rng.normal(0.0, self.sigma_ln, n)))
        fast = mus[mus <= pm_l]
        slow = mus[mus > pm_l]
        q = len(slow) / n
        mu_f = float(fast.mean()) if len(fast) else float("nan")
        mu_s = float(slow.mean()) if len(slow) else float("nan")
        return q, mu_f, mu_s

    def predicted_mpl(self, pm_l: float, n_steps: int):
        """E[mu] after n maintenance steps: (1-q^{n+1}) mu_f + q^{n+1} mu_s."""
        q, mu_f, mu_s = self.split_stats(pm_l)
        return [(1 - q ** (i + 1)) * mu_f + q ** (i + 1) * mu_s
                for i in range(n_steps)]
