"""Process-wide wall-clock registry: first call vs later calls per named
call site (copy of ``src/repro/obs/timing.py``).

Every named call site is recorded as ``cold`` (its first call) vs ``warm``
(later calls), and ``compile_s ~= cold - mean(warm)`` estimates the one-time
cost of the first call (for the port: the kernel build, the CUDA context
and allocator warm-up). :class:`repro_torch.serving.server.LabelServer`
times its serve tick through :func:`timeit` and reports :func:`summary`
rows under ``/stats``.
"""
from __future__ import annotations

import time

_CALLS: dict = {}      # name -> [seconds, ...] in call order


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
