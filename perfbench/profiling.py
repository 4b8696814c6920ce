"""Device time from ``torch.profiler``: the kernels of a traced window by
name, start and duration, the busy time (the union of their intervals),
and the breakdown the result line carries (the pattern of
``chip_smoke.py``'s ``kernel_events`` / ``device_profile``)."""
from __future__ import annotations

import time
from typing import NamedTuple

import torch


class Kernel(NamedTuple):
    name: str
    start_us: float
    dur_us: float


class Trace:
    """Collects device activity while open. ``kernels`` holds every
    device operation recorded (kernels, copies, sets); ``wall_s`` the host
    time between opening and closing, closed after a synchronise."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.kernels: list = []
        self.wall_s = 0.0
        self._prof = None

    def __enter__(self):
        if self.device.type == "cuda":
            from torch.profiler import ProfilerActivity, profile
            torch.cuda.synchronize(self.device)
            self._prof = profile(activities=[ProfilerActivity.CUDA])
            self._prof.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.wall_s = time.perf_counter() - self._t0
        if self._prof is None:
            return False
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self.kernels = _device_events(self._prof)
        self._prof = None
        return False

    def busy_s(self) -> float:
        return sum(b - a for a, b, _ in merged(self.kernels)) * 1e-6


def _device_events(prof) -> list:
    """The device operations of a finished profile, read from the kineto
    results (far faster than ``prof.events()`` for windows of 10^5
    launches)."""
    cuda = torch.autograd.DeviceType.CUDA
    out = []
    res = getattr(prof.profiler, "kineto_results", None)
    if res is not None:
        for e in res.events():
            if e.device_type() == cuda:
                out.append(Kernel(e.name(), e.start_ns() * 1e-3,
                                  e.duration_ns() * 1e-3))
    else:
        for e in prof.events():
            if e.device_type == cuda:
                out.append(Kernel(e.name, e.time_range.start,
                                  e.time_range.elapsed_us()))
    out.sort(key=lambda k: k.start_us)
    return out


def merged(kernels) -> list:
    """The union of the kernels' intervals as ``(start_us, end_us, name of
    the kernel that ends it)``, in time order."""
    out = []
    for k in sorted(kernels, key=lambda k: k.start_us):
        end = k.start_us + k.dur_us
        if out and k.start_us <= out[-1][1]:
            if end > out[-1][1]:
                out[-1] = (out[-1][0], end, k.name)
        else:
            out.append((k.start_us, end, k.name))
    return out


def short(name: str, n: int = 100) -> str:
    return name if len(name) <= n else name[:n - 3] + "..."


def by_name(kernels) -> dict:
    """Device seconds and launches per operation name."""
    out = {}
    for k in kernels:
        s, n = out.get(k.name, (0.0, 0))
        out[k.name] = (s + k.dur_us * 1e-6, n + 1)
    return out


def breakdown(kernels, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps summed by the operation the device had just finished (what the
    host was launching next is the work that follows it), at most ``top``
    of each, in seconds."""
    ops = sorted(((short(n), s) for n, (s, _) in by_name(kernels).items()),
                 key=lambda kv: -kv[1])[:top]
    gaps = {}
    iv = merged(kernels)
    for (_, end, name), (nxt, _, _) in zip(iv, iv[1:]):
        key = "after " + short(name)
        gaps[key] = gaps.get(key, 0.0) + (nxt - end) * 1e-6
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in idle]}


def idle_pct(run: dict):
    """Share of the traced wall time in which no operation ran on the
    device (100 - busy / wall, in %); None without a trace."""
    if not run.get("kernels") or not run.get("traced_wall_s"):
        return None
    return 100.0 * (1.0 - run["busy_s"] / run["traced_wall_s"])


def ops_per_tick(run: dict):
    """Device operations the traced sweep call launched over its ticks;
    None without a trace."""
    k = run.get("kernels")
    if not k or not run.get("ticks_traced"):
        return None
    return len(k) / run["ticks_traced"]


def per_window_s(run: dict, key: str):
    """The sum of the window's calls' ``key`` over the window's time;
    None where no call completed."""
    done = [c[key] for c in run.get("calls", []) if key in c]
    if not done or run["window_s"] <= 0:
        return None
    return sum(done) / run["window_s"]
