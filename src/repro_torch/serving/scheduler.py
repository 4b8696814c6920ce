"""Serving-side straggler mitigation: the paper's Mitigator applied to the
request path.

A request's *preprocessing* (tokenization, feature fetch, retrieval, crowd
verification — anything before the model step) runs on a pool of executors
with long-tailed latency. The scheduler replicates slow preprocessing
exactly like CLAMShell replicates slow label tasks: first completion wins,
losers are cancelled, chronically slow executors are evicted via
TermEst-corrected latency estimates (pool maintenance for the serving
fleet).

The model step itself is batched: requests whose preprocessing completed in
time join the next decode batch; stragglers join a later batch instead of
stalling the whole batch — this is the batch-latency insight of the paper
(block-until-slowest is the enemy) applied to continuous batching.

The port's own copy of ``src/repro/serving/scheduler.py``. It is host code
with no device work: the executors are simulated on the shared event loop
and the model step is the reference's cost model, so it takes no
``device`` argument.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

from repro_torch.core.events import EventLoop
from repro_torch.core.maintenance import termest_latency
from repro_torch.core.workers import Worker


@dataclass
class Request:
    rid: int
    arrived: float
    ready_at: Optional[float] = None     # preprocessing done
    done_at: Optional[float] = None
    attempts: int = 0


class ServingScheduler:
    """Discrete-event model of the serving data path (same EventLoop as the
    crowd simulator — the math is identical, only the executors changed)."""

    def __init__(self, *, n_exec: int = 8, batch_size: int = 8,
                 batch_interval: float = 0.05, straggler: bool = True,
                 dup_after: float = 0.25, pm_l: float = 0.4, seed: int = 0):
        self.loop = EventLoop()
        self.rng = np.random.default_rng(seed)
        self.batch_size = batch_size
        self.batch_interval = batch_interval
        self.straggler = straggler
        self.dup_after = dup_after
        self.pm_l = pm_l
        # executors with long-tailed service time (median ~60ms, tail ~s)
        self.execs = []
        for i in range(n_exec):
            mu = float(0.06 * np.exp(self.rng.normal(0, 0.8)))
            w = Worker(i, mu=mu, sigma=mu * 0.6, accuracy=1.0)
            self.execs.append(w)
        self.ready: list = []
        self.done: list[Request] = []
        self.evicted: list[int] = []

    def _exec_latency(self, w):
        return max(0.005, self.rng.normal(w.mu, w.sigma))

    def _preprocess(self, req: Request, attempt: int):
        free = [w for w in self.execs if not w.busy]
        if not free:
            self.loop.after(0.01, self._preprocess, req, attempt)
            return
        w = free[int(self.rng.integers(len(free)))]
        w.busy = True
        w.n_started += 1
        lat = self._exec_latency(w)
        start = self.loop.now

        def finish():
            w.busy = False
            if req.ready_at is None:
                req.ready_at = self.loop.now
                w.n_completed += 1
                w.completed_latency_sum += lat
                w.completed_latency_sqsum += lat * lat
                heapq.heappush(self.ready, (req.ready_at, req.rid, req))
            else:  # a duplicate won
                w.n_terminated += 1
                w.terminator_latency_sum += req.ready_at - req.arrived
            self._maintain(w)

        self.loop.at(start + lat, finish)
        if self.straggler and attempt == 0:
            def maybe_dup():
                if req.ready_at is None:
                    req.attempts += 1
                    self._preprocess(req, 1)
            self.loop.after(self.dup_after, maybe_dup)

    def _maintain(self, w: Worker):
        if w.n_started < 4 or w.doomed:
            return
        est = termest_latency(w)
        if np.isfinite(est) and est > self.pm_l:
            w.doomed = True
            self.evicted.append(w.wid)
            # replace with a fresh executor (pipelined recruitment)
            mu = float(0.06 * np.exp(self.rng.normal(0, 0.8)))
            self.execs[self.execs.index(w)] = Worker(
                100 + len(self.evicted), mu=mu, sigma=mu * 0.6, accuracy=1.0)

    def _batch_tick(self):
        batch = []
        while self.ready and len(batch) < self.batch_size:
            _, _, req = heapq.heappop(self.ready)
            batch.append(req)
        if batch:
            step = 0.02 + 0.002 * len(batch)   # decode step cost model
            for req in batch:
                req.done_at = self.loop.now + step
                self.done.append(req)
        self.loop.after(self.batch_interval, self._batch_tick)

    def run(self, n_requests: int, arrival_rate: float = 40.0):
        t = 0.0
        for rid in range(n_requests):
            t += float(self.rng.exponential(1.0 / arrival_rate))
            req = Request(rid, t)
            self.loop.at(t, self._preprocess, req, 0)
        self.loop.after(self.batch_interval, self._batch_tick)
        self.loop.run_until(t + 60.0, stop=lambda: len(self.done) >= n_requests)
        lats = np.array([r.done_at - r.arrived for r in self.done])
        return {
            "n": len(self.done),
            "p50": float(np.percentile(lats, 50)),
            "p99": float(np.percentile(lats, 99)),
            "evicted": len(self.evicted),
        }
