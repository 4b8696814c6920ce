"""Engine-native trace switches + the events-engine host recorder (copy of
``src/repro/obs/trace.py``; framework-free, kept here so the port imports
nothing of the reference package).

:class:`TraceConfig` is the frozen (hashable) flag both batched engines
carry on their configs (``StreamConfig.trace`` / ``FastConfig.trace``).
``None`` — the default everywhere — runs the untraced program: no new
state, no new output keys, no extra randomness. A ``TraceConfig`` adds
fixed-shape buffers to the loop state only; every recorded quantity is a
deterministic function of state the engine already computes, and tracing
draws no counter-based uniforms — so traced runs stay bit-identical to
untraced runs on every shared output key (``tests/test_torch_trace.py``).

:class:`EventsTrace` is the scalar event loop's host-side counterpart:
``repro_torch.core.clamshell.ClamShell.run_labeling(..., trace=rec)``
calls ``record_batch`` after each batch and the recorder derives the
per-task phase decomposition from the Task/Assignment timestamps the loop
already keeps.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    """What the in-loop trace buffers record.

    ``phases``   — per-phase latency histograms/sums (backlog wait, window
    wait, work time, finalize lag) threaded through the stream tick;
    ``per_tick`` — per-tick/-batch activity series (votes issued, busy and
    idle pool slots, drops, steals, admission scores; per-batch event
    counts and straggler duplications on simfast).
    """
    phases: bool = True
    per_tick: bool = True

    def __post_init__(self):
        if not (self.phases or self.per_tick):
            raise ValueError("TraceConfig: enable at least one of "
                             "phases/per_tick (use trace=None to disable "
                             "tracing entirely)")


#: canonical phase order — every exporter/report renders these in this
#: order so artifacts from different engines line up
PHASES = ("backlog_wait", "window_wait", "work_time", "finalize_lag")


class EventsTrace:
    """Host-side per-task trace for the scalar event-loop engine.

    Purely observational: ``record_batch`` reads completed Task objects
    after the loop has already finished a batch, so a traced run is the
    identical simulation.

    Phase semantics on the event loop: ``backlog_wait`` is creation ->
    first assignment start (queueing before any worker touches the task),
    ``work_time`` is first start -> completion (includes straggler races
    and re-assignments — the event loop has no admission window, so
    ``window_wait`` is identically 0), ``finalize_lag`` is 0 (finalization
    is the threshold-crossing vote itself).
    """

    def __init__(self):
        self.tasks = []     # one dict per finalized task
        self.batches = []   # one dict per completed batch

    def record_batch(self, batch, *, t0: float, t_end: float):
        lat = []
        for t in batch:
            first = min((a.started_at for a in t.assignments),
                        default=t.completed_at)
            self.tasks.append(dict(
                task=t.tid,
                created_at=float(t.created_at),
                completed_at=float(t.completed_at),
                backlog_wait=float(first - t.created_at),
                window_wait=0.0,
                work_time=float(t.completed_at - first),
                finalize_lag=0.0,
                n_votes=len(t.votes),
                n_assignments=len(t.assignments),
                correct=bool(t.result == t.true_label),
            ))
            lat.append(float(t.completed_at - t.created_at))
        self.batches.append(dict(
            t0=float(t0), t_end=float(t_end), n_tasks=len(batch),
            mean_latency=(sum(lat) / len(lat)) if lat else 0.0,
            votes=sum(len(t.votes) for t in batch),
        ))

    def phase_hists(self, bin_s: float, n_bins: int = 128) -> dict:
        """Pool the per-task phases into fixed-width histograms (same
        top-bin-clipping convention as the stream engine's in-loop
        scatter, so the exporter renders both identically)."""
        out = {}
        for pk in PHASES:
            hist = [0] * n_bins
            total = 0.0
            for t in self.tasks:
                v = t[pk]
                hist[min(int(v / bin_s), n_bins - 1)] += 1
                total += v
            out[pk] = dict(hist=hist, sum=total)
        return out
