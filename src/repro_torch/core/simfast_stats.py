"""Summary statistics and engine-parity helpers for the batch engine (port
of ``src/repro/core/simfast_stats.py``).

:func:`summarize` reduces :func:`repro_torch.core.simfast.simulate`'s
stacked per-replication tensors (on any device) to the distributional
quantities the paper reports: mean / p50 / p95 task latency, throughput,
accuracy and cost. :func:`event_loop_summary` runs the scalar event-loop
engine on the matching ``CSConfig`` and reduces it to the same summary;
:func:`parity_report` compares the two.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class SimSummary:
    n_reps: int
    n_tasks: int
    frac_done: float
    mean_latency: float
    p50_latency: float
    p95_latency: float
    std_latency: float
    mean_total_time: float
    throughput: float           # labels per simulated second
    accuracy: float
    cost: float

    def as_row(self) -> str:
        return (f"mean_s={self.mean_latency:.1f};p95_s={self.p95_latency:.1f};"
                f"total_s={self.mean_total_time:.1f};acc={self.accuracy:.3f};"
                f"cost=${self.cost:.2f}")


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def summarize(out) -> SimSummary:
    """Reduce a simfast.simulate() output dict to a SimSummary."""
    done = _np(out["done"])
    lat = _np(out["latency"])
    total = _np(out["total_time"])
    lats = lat[done]
    n_reps, n_tasks = done.shape
    mean_total = float(total.mean())
    return SimSummary(
        n_reps=n_reps,
        n_tasks=n_tasks,
        frac_done=float(done.mean()),
        mean_latency=float(lats.mean()) if lats.size else float("nan"),
        p50_latency=float(np.percentile(lats, 50)) if lats.size else float("nan"),
        p95_latency=float(np.percentile(lats, 95)) if lats.size else float("nan"),
        std_latency=float(lats.std()) if lats.size else float("nan"),
        mean_total_time=mean_total,
        throughput=done.sum() / max(total.sum(), 1e-9),
        accuracy=float(_np(out["accuracy"]).mean()),
        cost=float(_np(out["cost"]).mean()),
    )


def event_loop_summary(cfg, n_reps: int, *, seed: int = 0,
                       true_labels=None, device="cuda") -> SimSummary:
    """Run the scalar event-loop engine on the matching CSConfig and reduce
    to the same summary, for apples-to-apples parity checks. ``device``
    is the :class:`~repro_torch.core.clamshell.ClamShell`'s (a labeling
    run without quality maintenance does no device work)."""
    from repro_torch.core.clamshell import ClamShell, CSConfig
    from repro_torch.core.workers import Population

    lats, totals, accs, costs, done = [], [], [], [], 0
    for r in range(n_reps):
        cs_cfg = CSConfig(
            pool_size=cfg.pool_size,
            batch_ratio=(cfg.pool_size / cfg.eff_batch),
            n_records=cfg.n_records,
            votes_needed=cfg.votes_needed,
            straggler=cfg.straggler,
            pm_l=cfg.pm_l,
            use_termest=cfg.use_termest,
            retainer=cfg.retainer,
            recruit_mean_s=cfg.recruit_mean_s,
            cold_recruit_mean_s=cfg.cold_recruit_mean_s,
            session_mean_s=cfg.session_mean_s,
            seed=seed + 1000 * r,
        )
        pop = Population(median_mu=cfg.median_mu, sigma_ln=cfg.sigma_ln,
                         cv_lo=cfg.cv_lo, cv_hi=cfg.cv_hi,
                         acc_a=cfg.acc_a, acc_b=cfg.acc_b,
                         seed=seed + 1000 * r)
        cs = ClamShell(cs_cfg, population=pop, device=device)
        res = cs.run_labeling(cfg.n_tasks, true_labels=true_labels,
                              max_time=cfg.max_batch_time * cfg.n_batches)
        lats.extend(res.task_latencies)
        totals.append(res.total_time)
        accs.append(res.accuracy)
        costs.append(res.cost)
        done += len(res.task_latencies)
    lats = np.asarray(lats)
    return SimSummary(
        n_reps=n_reps,
        n_tasks=cfg.n_tasks,
        frac_done=done / (n_reps * cfg.n_tasks),
        mean_latency=float(lats.mean()) if lats.size else float("nan"),
        p50_latency=float(np.percentile(lats, 50)) if lats.size else float("nan"),
        p95_latency=float(np.percentile(lats, 95)) if lats.size else float("nan"),
        std_latency=float(lats.std()) if lats.size else float("nan"),
        mean_total_time=float(np.mean(totals)),
        throughput=done / max(np.sum(totals), 1e-9),
        accuracy=float(np.mean(accs)),
        cost=float(np.mean(costs)),
    )


def parity_report(fast: SimSummary, slow: SimSummary) -> dict:
    """Relative disagreement between the two engines on the headline stats."""
    def rel(a, b):
        return abs(a - b) / max(abs(b), 1e-9)

    return dict(
        mean_latency_rel=rel(fast.mean_latency, slow.mean_latency),
        p50_latency_rel=rel(fast.p50_latency, slow.p50_latency),
        p95_latency_rel=rel(fast.p95_latency, slow.p95_latency),
        total_time_rel=rel(fast.mean_total_time, slow.mean_total_time),
        accuracy_abs=abs(fast.accuracy - slow.accuracy),
    )
