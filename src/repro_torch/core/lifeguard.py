"""LifeGuard: batch scheduler + Mitigator (straggler mitigation, §4.1) with
quality-control decoupling.

Semantics per the paper:
  * unassigned tasks are routed to available workers first;
  * once every task is active/complete, available workers are assigned to
    ACTIVE tasks (duplicate assignments) — straggler mitigation;
  * first completed assignment wins; all other assignments of that task are
    terminated, their workers paid and immediately re-routed;
  * QC decoupling: a task needing v votes counts as `active` until it has v
    answers, and straggler mitigation adds at most ONE extra worker per
    missing vote at a time (avoids the naive 2x-votes blowup);
  * routing policies: random | longest | fewest | oracle (simulation showed
    random matches oracle; we implement all four to reproduce that result).

The port's own copy of ``src/repro/core/lifeguard.py``: host Python over the
event heap, draws from the pool's and its own numpy generators (``seed +
31337``) in the reference's order.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from repro_torch.core.crowd import (
    Assignment, RetainerPool, SWITCH_DELAY_S, Task,
)
from repro_torch.core.maintenance import Maintainer
from repro_torch.core.workers import Worker


class LifeGuard:
    def __init__(self, loop, pool: RetainerPool, *, straggler: bool = True,
                 routing: str = "random", maintainer: Optional[Maintainer] = None,
                 max_dup: int = 2, seed: int = 0):
        self.loop = loop
        self.pool = pool
        self.straggler = straggler
        self.routing = routing
        self.maintainer = maintainer
        self.max_dup = max_dup      # extra concurrent assignments per task
        self.rng = np.random.default_rng(seed + 31337)
        self.queue: list[Task] = []
        self.on_task_done: Optional[Callable[[Task], None]] = None
        self.on_batch_done: Optional[Callable[[list], None]] = None
        self._batch: list[Task] = []
        self.completed_votes: list = []   # rolling window for quality EM
        self.n_classes_seen: int = 2
        pool.on_available = self._route

    # ------------------------------------------------------------------
    def submit_batch(self, tasks: list[Task], on_done: Callable[[list], None]):
        for t in tasks:
            t.created_at = self.loop.now
        self._batch = list(tasks)
        self.queue.extend(tasks)
        self.on_batch_done = on_done
        for w in list(self.pool.available):
            self._route(w)

    # ------------------------------------------------------------------
    def _unassigned(self):
        return [t for t in self.queue
                if not t.done and len(t.active) == 0]

    def _mitigatable(self):
        """Active tasks eligible for one more duplicate assignment."""
        out = []
        for t in self.queue:
            if t.done:
                continue
            act = t.active
            if not act:
                continue
            missing = t.votes_needed - len(t.votes)
            # QC decoupling: at most one straggler-duplicate per missing vote
            if len(act) < missing + 1 and len(act) <= self.max_dup:
                out.append(t)
        return out

    def _pick(self, tasks: list[Task]) -> Task:
        if self.routing == "random" or len(tasks) == 1:
            return tasks[self.rng.integers(len(tasks))]
        if self.routing == "longest":
            return max(tasks, key=lambda t: self.loop.now - min(
                a.started_at for a in t.active))
        if self.routing == "fewest":
            return min(tasks, key=lambda t: len(t.active))
        if self.routing == "oracle":  # known-to-finish-slowest active task
            return max(tasks, key=lambda t: min(
                a.complete_at for a in t.active))
        raise ValueError(self.routing)

    def _route(self, w: Worker):
        if w.busy or w.wid not in self.pool.workers:
            return
        cand = self._unassigned()
        mitigation = False
        if not cand and self.straggler:
            cand = self._mitigatable()
            mitigation = True
        if not cand:
            return
        # routing policies rank ACTIVE tasks; unassigned ones are FIFO-random
        task = self._pick(cand) if mitigation else \
            cand[self.rng.integers(len(cand))]
        self._assign(task, w)

    def _assign(self, task: Task, w: Worker):
        self.pool.mark_busy(w)
        w.current_started = self.loop.now
        lat = w.sample_latency(self.pool.rng) * max(1, task.n_records) ** 0.9
        a = Assignment(task, w, self.loop.now, self.loop.now + lat)
        task.assignments.append(a)
        w.n_started += 1
        self.loop.at(a.complete_at, self._complete, a)

    # ------------------------------------------------------------------
    def _complete(self, a: Assignment):
        if a.canceled or a.task.done and a.completed:
            return
        w, task = a.worker, a.task
        if a.canceled:
            return
        a.completed = True
        # pay for the work regardless of later termination
        self.pool.pay_work(w, task.n_records)
        w.n_completed += 1
        w.tasks_done += 1
        lat = a.latency
        w.completed_latency_sum += lat
        w.completed_latency_sqsum += lat * lat
        label = w.sample_label(task.true_label, task.n_classes, self.pool.rng)
        task.votes.append((label, w.wid, lat))

        if len(task.votes) >= task.votes_needed and not task.done:
            task.done = True
            task.completed_at = self.loop.now
            task.result = self._vote(task)
            # terminate the losers (straggler mitigation pay + reroute)
            for other in task.assignments:
                if other is not a and not other.completed and not other.canceled:
                    other.canceled = True
                    ow = other.worker
                    self.pool.pay_work(ow, task.n_records)
                    ow.n_terminated += 1
                    ow.terminator_latency_sum += lat
                    if self.maintainer:
                        self.maintainer.observe(ow)
                    self.loop.after(SWITCH_DELAY_S, self._free, ow)
            if task in self.queue:
                self.queue.remove(task)
            if len(task.votes) > 1:   # agreement evidence for quality EM
                self.completed_votes.append(
                    [(l, wid) for l, wid, _ in task.votes])
                self.n_classes_seen = max(self.n_classes_seen, task.n_classes)
                if len(self.completed_votes) > 200:
                    self.completed_votes.pop(0)
            if self.on_task_done:
                self.on_task_done(task)
        if self.maintainer:
            self.maintainer.observe(w)
        self._free(w)
        self._check_batch()

    def _free(self, w: Worker):
        self.pool.mark_available(w)

    def _vote(self, task: Task) -> int:
        counts = np.zeros(task.n_classes)
        for label, _, _ in task.votes:
            counts[label] += 1
        return int(counts.argmax())

    def _check_batch(self):
        if self._batch and all(t.done for t in self._batch):
            batch, self._batch = self._batch, []
            cb, self.on_batch_done = self.on_batch_done, None
            if cb:
                cb(batch)
