"""repro_torch.obs: in-loop trace buffers, latency-source decomposition and
a run-report layer over the port's batched engines (port of
``src/repro/obs``).

The pieces:

  * ``trace``  — :class:`TraceConfig`, the trace switch the stream tick and
    the batch engine read, and :class:`EventsTrace`, the event loop's
    host-side recorder (``core/clamshell.py`` takes it);
  * ``timing`` — process-wide wall-clock registry (first call vs later
    calls per named call site), and the spans inside the tick, the
    sweep, the encoder and the MoE, on while a ``torch.profiler`` session
    records;
  * ``export`` — versioned JSON-lines trace artifacts, the reference's
    schema (``python -m repro_torch.obs.export <scenario>``);
  * ``report`` — text dashboard over any trace artifact
    (``python -m repro_torch.obs.report TRACE_<scenario>.jsonl``).

This ``__init__`` exports only the engine-facing pieces (``trace`` /
``timing``, both import-light): ``export`` imports the scenario layer
inside functions, so the engines can import ``repro_torch.obs.trace``
without a cycle.
"""
from repro_torch.obs import timing
from repro_torch.obs.trace import EventsTrace, TraceConfig

__all__ = ["EventsTrace", "TraceConfig", "timing"]
