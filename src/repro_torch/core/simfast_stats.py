"""Summary statistics and engine-parity helpers for the batch engine (port
of ``src/repro/core/simfast_stats.py``).

:func:`summarize` reduces :func:`repro_torch.core.simfast.simulate`'s
stacked per-replication tensors (on any device) to the distributional
quantities the paper reports: mean / p50 / p95 task latency, throughput,
accuracy and cost. The reference's ``event_loop_summary`` runs the
event-loop engine, which is not ported yet (ROADMAP A9).
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
