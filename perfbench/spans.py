"""The program's own spans (``repro_torch.obs.timing``: on while the traced
window's profiler records), joined with the device trace, and the encoder's
padding counted from the traced requests.

- A device share is 100 x the device time of the named spans (each a pair
  of CUDA events around the span) over that of the enclosing spans: the
  stream's ``tick``, the encoder's ``encode.batch``.
- An idle share is 100 x the time in which no device operation ran
  (:func:`perfbench.profiling.merged`) while the host was inside the named
  spans, over the traced wall. Host times and the profiler's device events
  are both Unix times in ns.
- The padding share is 100 x (1 - real tokens / token slots) over the
  traced requests, from the lengths the driver records for each request
  and the program's micro-batch ``(B, seq_len)``.

Every function returns None where there is nothing to read: no trace, or a
program that records no spans.
"""
from __future__ import annotations

import numpy as np

from perfbench.profiling import merged


def program():
    """The spans the program recorded, or None where it records none (a
    program without spans, or nothing recorded)."""
    try:
        from repro_torch.obs import timing
    except ImportError:
        return None
    if not hasattr(timing, "spans"):
        return None
    return timing.spans() or None


def _within(spans, i: int, name: str) -> bool:
    """Whether span ``i`` has an enclosing span named ``name``."""
    p = spans[i].parent
    while p >= 0:
        if spans[p].name == name:
            return True
        p = spans[p].parent
    return False


def device_ms(spans, names, within=None):
    """The device time of the spans named in ``names`` (those with an
    enclosing span named ``within``, where given), in ms; None where no such
    span has a device interval."""
    got = [s.device_ms for i, s in enumerate(spans)
           if s.name in names and s.device_ms is not None
           and (within is None or _within(spans, i, within))]
    return sum(got) if got else None


def device_share(spans, names, of: str):
    """100 x the device time of ``names`` inside spans named ``of`` over
    the device time of the spans named ``of``; None where those have
    none."""
    whole = device_ms(spans, (of,))
    if not whole:
        return None
    return 100.0 * (device_ms(spans, names, within=of) or 0.0) / whole


def host_us(spans, names) -> list:
    """The union of the host intervals of the spans named in ``names``, as
    sorted ``(start_us, end_us)``."""
    ivs = sorted((s.t0_ns * 1e-3, s.t1_ns * 1e-3) for s in spans
                 if s.name in names and s.t1_ns is not None)
    out = []
    for a, b in ivs:
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def overlap(a, b) -> float:
    """The length two sorted lists of disjoint intervals share."""
    i = j = 0
    tot = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            tot += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return tot


def idle_in_us(spans, names, kernels) -> float:
    """Time in which no device operation ran while the host was inside a
    span named in ``names``, in us."""
    host = host_us(spans, names)
    busy = [(s, e) for s, e, _ in merged(kernels)]
    return sum(b - a for a, b in host) - overlap(host, busy)


def _traced(run: dict, names):
    """The program's spans named in ``names`` with the run's trace, or
    None."""
    if not run.get("kernels") or not run.get("traced_wall_s"):
        return None
    spans = program()
    if spans is None or not any(s.name in names for s in spans):
        return None
    return spans


def idle_share(run: dict, names):
    """100 x device idle while the host was inside ``names`` over the
    traced wall, in %."""
    spans = _traced(run, names)
    if spans is None:
        return None
    idle = idle_in_us(spans, names, run["kernels"]) * 1e-6
    return 100.0 * idle / run["traced_wall_s"]


def idle_outside_share(run: dict, names):
    """100 x device idle while the host was inside none of ``names`` over
    the traced wall, in %: the trace's idle less that inside them."""
    spans = _traced(run, names)
    if spans is None:
        return None
    wall = run["traced_wall_s"]
    busy = sum(e - s for s, e, _ in merged(run["kernels"])) * 1e-6
    idle = idle_in_us(spans, names, run["kernels"]) * 1e-6
    return 100.0 * (wall - busy - idle) / wall


def share_of(names, of: str):
    """:func:`device_share` of the program's spans, or None."""
    spans = program()
    return None if spans is None else device_share(spans, names, of)


def pad_share(run: dict):
    """100 x (1 - real tokens / token slots) over the encoder's traced
    requests: a request of n texts fills ceil(n / B) micro-batches of
    ``run["micro_batch"] = (B, seq_len)``, so pad rows of its last
    micro-batch and pad positions past each text's length both count, in
    %."""
    if not run.get("traced_calls") or not run.get("micro_batch"):
        return None
    B, seq_len = run["micro_batch"]
    real = slots = 0
    for c in run["calls"][:run["traced_calls"]]:
        if "lengths" not in c:
            continue
        n = len(c["lengths"])
        real += int(np.sum(c["lengths"], dtype=np.int64))
        slots += -(-n // B) * B * seq_len
    return 100.0 * (1.0 - real / slots) if slots else None
