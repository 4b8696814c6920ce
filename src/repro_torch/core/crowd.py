"""Retainer-pool crowd model: tasks, assignments, slots, recruitment, churn.

Implements the paper's §3 architecture: the Crowd Platform holds persistent
retainer slots; recruitment runs in the background (pipelined, so maintenance
never blocks on it); workers are paid to wait ($0.05/min) and per record
($0.02/record), including terminated (straggler-mitigated) assignments.

The port's own copy of ``src/repro/core/crowd.py`` (host Python and numpy;
the event loop does no device work). The batched engines read only the
pay and switch constants.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

from repro_torch.core.events import EventLoop
from repro_torch.core.workers import Population, Worker

WAIT_PAY_PER_S = 0.05 / 60.0
WORK_PAY_PER_RECORD = 0.02
SWITCH_DELAY_S = 2.0      # dialog-click delay on termination (§6.3)


@dataclass
class Task:
    tid: int
    true_label: int = 0
    n_classes: int = 2
    n_records: int = 1                    # N_g: records grouped per HIT
    votes_needed: int = 1                 # QC redundancy (decoupled from SM)
    votes: list = field(default_factory=list)   # (label, wid, latency)
    assignments: list = field(default_factory=list)
    done: bool = False
    created_at: float = 0.0
    completed_at: float = 0.0
    result: Optional[int] = None

    @property
    def active(self):
        return [a for a in self.assignments if not a.canceled and not a.completed]


@dataclass
class Assignment:
    task: Task
    worker: Worker
    started_at: float
    complete_at: float
    canceled: bool = False
    completed: bool = False

    @property
    def latency(self):
        return self.complete_at - self.started_at


class RetainerPool:
    """Maintains ~p live slots + a pipelined reserve of pre-trained workers."""

    def __init__(self, loop: EventLoop, population: Population, size: int,
                 *, recruit_mean_s: float = 45.0, session_mean_s: float = 1800.0,
                 reserve_target: int = 3, seed: int = 0):
        self.loop = loop
        self.pop = population
        self.size = size
        self.recruit_mean = recruit_mean_s
        self.session_mean = session_mean_s
        self.reserve_target = reserve_target
        self.rng = np.random.default_rng(seed + 777)
        self.workers: dict[int, Worker] = {}
        self.reserve: list[Worker] = []
        self.pending_recruits = 0
        self.on_available: Optional[Callable[[Worker], None]] = None
        self.cost_wait = 0.0
        self.cost_work = 0.0
        self.n_recruited = 0
        self.n_evicted = 0
        self.n_churned = 0

    # ---- lifecycle -----------------------------------------------------
    def fill(self):
        """Initial synchronous fill (recruitment time is amortized, §6.1)."""
        while len(self.workers) < self.size:
            self._admit(self.pop.draw())
        self._top_up_reserve()

    def _admit(self, w: Worker):
        w.joined_at = self.loop.now
        w.busy = False
        w.wait_since = self.loop.now
        self.workers[w.wid] = w
        self.n_recruited += 1
        # churn: the worker eventually abandons the pool
        self.loop.after(float(self.rng.exponential(self.session_mean)),
                        self._churn, w.wid)
        if self.on_available:
            self.on_available(w)

    def _churn(self, wid: int):
        w = self.workers.get(wid)
        if w is None:
            return  # left already
        if w.busy:
            w.doomed = True  # finishes the active task, then leaves
            self.n_churned += 1
            return
        self._release(w, churn=True)
        self._backfill()

    def _release(self, w: Worker, churn=False):
        if w.wid in self.workers:
            self._pay_wait(w)
            del self.workers[w.wid]
            if churn:
                self.n_churned += 1

    def evict(self, w: Worker):
        """Pool maintenance eviction: replace from the reserve, never block.
        Busy workers are paid for their active job and leave on completion."""
        if w.wid not in self.workers:
            return
        self.n_evicted += 1
        if w.busy:
            w.doomed = True
            return
        self._release(w)
        self._backfill()

    def _backfill(self):
        if self.reserve:
            self._admit(self.reserve.pop())
        else:
            self._recruit_async()
        self._top_up_reserve()

    def _top_up_reserve(self):
        while self.reserve_target > len(self.reserve) + self.pending_recruits - max(
                0, self.size - len(self.workers)):
            self._recruit_async()

    def _recruit_async(self):
        self.pending_recruits += 1
        delay = float(self.rng.exponential(self.recruit_mean))

        def arrive():
            self.pending_recruits -= 1
            w = self.pop.draw()
            if len(self.workers) < self.size:
                self._admit(w)
            else:
                self.reserve.append(w)

        self.loop.after(delay, arrive)

    # ---- accounting ----------------------------------------------------
    def _pay_wait(self, w: Worker):
        dt = max(0.0, self.loop.now - w.wait_since)
        self.cost_wait += dt * WAIT_PAY_PER_S
        w.earned += dt * WAIT_PAY_PER_S
        w.wait_since = self.loop.now

    def pay_work(self, w: Worker, n_records: int):
        amt = WORK_PAY_PER_RECORD * n_records
        self.cost_work += amt
        w.earned += amt

    def mark_busy(self, w: Worker):
        self._pay_wait(w)
        w.busy = True

    def mark_available(self, w: Worker):
        w.busy = False
        w.wait_since = self.loop.now
        if w.wid not in self.workers:
            return
        if w.doomed:  # deferred churn/eviction lands now
            self._release(w)
            self._backfill()
            return
        if self.on_available:
            self.on_available(w)

    @property
    def available(self):
        return [w for w in self.workers.values() if not w.busy]

    def mean_pool_latency(self) -> float:
        mus = [w.mu for w in self.workers.values()]
        return float(np.mean(mus)) if mus else float("nan")

    @property
    def total_cost(self):
        return self.cost_wait + self.cost_work
