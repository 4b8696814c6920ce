"""Deterministic discrete-event engine for the crowd simulator (the port's
own copy of ``src/repro/core/events.py``; framework-free).

Same role as the paper's python simulator (§6.1): everything that happens —
task assignment, completion, recruitment, churn, model retrains — is an event
on a single clock, so experiments are exactly reproducible given a seed.
"""
from __future__ import annotations

import heapq
import itertools
from typing import Callable, Optional


class EventLoop:
    def __init__(self):
        self.now = 0.0
        self._heap = []
        self._seq = itertools.count()

    def at(self, t: float, fn: Callable, *args):
        if t < self.now:
            t = self.now
        heapq.heappush(self._heap, (t, next(self._seq), fn, args))

    def after(self, dt: float, fn: Callable, *args):
        self.at(self.now + dt, fn, *args)

    def run_until(self, t_end: float = float("inf"),
                  stop: Optional[Callable[[], bool]] = None):
        while self._heap:
            t, _, fn, args = self._heap[0]
            if t > t_end:
                break
            heapq.heappop(self._heap)
            self.now = t
            fn(*args)
            if stop is not None and stop():
                break
        return self.now

    def empty(self) -> bool:
        return not self._heap
