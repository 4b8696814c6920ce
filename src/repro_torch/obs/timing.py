"""Process-wide timing: a wall-clock registry of named call sites (copy of
``src/repro/obs/timing.py``), and spans inside the program on the
profiler's clock.

Every named call site is recorded as ``cold`` (its first call) vs ``warm``
(later calls), and ``compile_s ~= cold - mean(warm)`` estimates the one-time
cost of the first call (for the port: the kernel build, the CUDA context
and allocator warm-up). :class:`repro_torch.serving.server.LabelServer`
times its serve tick through :func:`timeit` and reports :func:`summary`
rows under ``/stats``; the grid and the batched sweeps record their
``<name>.execute`` wall time.

Spans are on exactly while a ``torch.profiler`` session records (the
profiler's own enabled flag); off, :func:`span` returns one shared no-op
context. On, a span appends one record: its name, the index of the
enclosing span (-1 at the top), its host start and end in ns on
``time.time_ns``'s clock (the Unix time onto which the profiler puts its
device events) and a pair of timing events recorded at entry and exit on
the current stream of the span's card: the ``device`` it is given, else
the current card once CUDA is initialised. At most :data:`SPAN_CAP`
records are kept; later spans are counted (:func:`dropped_spans`).
:func:`spans` resolves the device intervals after the traced work and
:func:`clear_spans` resets them. Spans never enter the call-site registry.
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import NamedTuple, Optional

import torch
from torch.autograd import profiler as _profiler

_CALLS: dict = {}      # name -> [seconds, ...] in call order

SPAN_CAP = 1_000_000
_SPANS: list = []      # [name, parent, t0_ns, t1_ns, event0, event1, ms]
_DROPPED = [0]
_LOCAL = threading.local()
_OFF = contextlib.nullcontext()


def record(name: str, seconds: float):
    _CALLS.setdefault(name, []).append(float(seconds))


def timeit(name: str, fn, *args, **kw):
    """Run ``fn`` and record its wall-clock under ``name``.
    Returns ``(result, seconds)``."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    dt = time.perf_counter() - t0
    record(name, dt)
    return out, dt


def clear():
    _CALLS.clear()


def entries() -> dict:
    """Raw per-name call durations (copy)."""
    return {k: list(v) for k, v in _CALLS.items()}


def summary() -> list:
    """One dict per name: calls, total_s, cold_s (first call), warm_s
    (mean of later calls, None if single-call) and the compile-time
    estimate ``compile_s = cold_s - warm_s`` (None if single-call)."""
    out = []
    for name, xs in _CALLS.items():
        warm = sum(xs[1:]) / (len(xs) - 1) if len(xs) > 1 else None
        out.append(dict(
            name=name, calls=len(xs), total_s=sum(xs), cold_s=xs[0],
            warm_s=warm,
            compile_s=max(xs[0] - warm, 0.0) if warm is not None else None,
        ))
    return out


# ---- spans -----------------------------------------------------------------

class Span(NamedTuple):
    """One recorded span: ``parent`` indexes the enclosing span in
    :func:`spans` (-1 at the top), ``t0_ns`` / ``t1_ns`` are host Unix
    times (``t1_ns`` None while open), ``device_ms`` the time between its
    two events on its card (None without one)."""
    name: str
    parent: int
    t0_ns: int
    t1_ns: Optional[int]
    device_ms: Optional[float]


def _stack() -> list:
    st = getattr(_LOCAL, "stack", None)
    if st is None:
        st = _LOCAL.stack = []
    return st


def _stream(device):
    """The stream a span's events go on: the current stream of ``device``
    where that is a card, of the current card where no device is given and
    CUDA is initialised; None otherwise."""
    if device is None:
        return torch.cuda.current_stream() if torch.cuda.is_initialized() \
            else None
    device = torch.device(device)
    return torch.cuda.current_stream(device) if device.type == "cuda" \
        else None


class _Open:
    """The context of one span while the profiler records."""
    __slots__ = ("name", "device", "rec", "stream")

    def __init__(self, name: str, device):
        self.name, self.device = name, device
        self.rec = self.stream = None

    def __enter__(self):
        if len(_SPANS) >= SPAN_CAP:
            _DROPPED[0] += 1
            return self
        st = _stack()
        self.rec = [self.name, st[-1] if st else -1, time.time_ns(), None,
                    None, None, None]
        self.stream = _stream(self.device)
        if self.stream is not None:
            ev = self.rec[4] = torch.cuda.Event(enable_timing=True)
            ev.record(self.stream)
        st.append(len(_SPANS))
        _SPANS.append(self.rec)
        return self

    def __exit__(self, *exc):
        rec = self.rec
        if rec is not None:
            if self.stream is not None:
                ev = rec[5] = torch.cuda.Event(enable_timing=True)
                ev.record(self.stream)
            rec[3] = time.time_ns()
            st = _stack()
            if st:
                st.pop()
        return False


def span(name: str, device=None):
    """A context that records a span ``name`` while a profiler session
    records, and the shared no-op context otherwise. ``device`` names the
    card whose stream the span's work runs on (the current card where
    None)."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Open(name, device)


def spans() -> list:
    """The recorded spans as :class:`Span`, in entry order, their device
    intervals resolved to ms (one synchronise of each card, the first time
    a record is read)."""
    pending = [r for r in _SPANS if r[6] is None and r[5] is not None]
    if pending:
        for d in range(torch.cuda.device_count()):
            torch.cuda.synchronize(d)
        for r in pending:
            r[6] = r[4].elapsed_time(r[5])
            r[4] = r[5] = None
    return [Span(r[0], r[1], r[2], r[3], r[6]) for r in _SPANS]


def dropped_spans() -> int:
    """Spans not recorded because :data:`SPAN_CAP` records were kept."""
    return _DROPPED[0]


def clear_spans():
    """Drop every span record and the dropped count."""
    _SPANS.clear()
    _DROPPED[0] = 0
    _stack().clear()
