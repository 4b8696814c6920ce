"""CLAMShell façade: wires Batcher/TaskSelector, LifeGuard (Mitigator),
Maintainer and the learner into the paper's full system, and provides the two
top-level entry points used by benchmarks, examples and tests:

  * run_labeling  — acquire labels for a fixed task set (per-batch metrics)
  * run_learning  — hybrid/active/passive learning to an accuracy target
                    (full-run metrics; async retraining hides decision latency)

Baselines (§6.6): Base-NR (no retainer pool, cold recruitment, passive) and
Base-R (retainer pool + pure batch-mode active learning) are configs of the
same machinery.

Port of ``src/repro/core/clamshell.py``: the same host Python and numpy
draws, so a labeling run's :class:`LabelResult` is the reference's. The
device work is the quality sweep's Dawid-Skene EM (``ds_estep`` on the
card) and the learner's fits, scores and entropies (``entropy_scores`` on
the card); :class:`ClamShell` runs them on ``device``, the card unless the
caller passes ``device="cpu"``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from repro_torch.core.crowd import RetainerPool, Task
from repro_torch.core.events import EventLoop
from repro_torch.core.lifeguard import LifeGuard
from repro_torch.core.maintenance import Maintainer
from repro_torch.core.workers import Population
from repro_torch.device import resolve_device
from repro_torch.learning.compat import LogisticLearner


@dataclass
class CSConfig:
    pool_size: int = 15
    batch_ratio: float = 1.0        # R = pool/batch -> batch = pool/R
    n_records: int = 1              # N_g
    votes_needed: int = 1
    straggler: bool = True
    routing: str = "random"
    pm_l: float = float("inf")      # latency threshold (inf = off)
    use_termest: bool = True
    quality_threshold: Optional[float] = None  # EM-accuracy eviction (§7 ext.)
    learner: str = "HL"             # AL | PL | HL | NL
    al_fraction: float = 0.5        # r = k/p for hybrid
    al_batch: int = 10              # batch-mode AL size for pure AL
    decision_latency_s: float = 15.0
    async_retrain: bool = True
    uncertainty_sample: int = 400   # subsample for point selection
    reweight_active: bool = False   # paper §5.1 suggests weighting active
                                    # points by k/p; empirically this HURTS
                                    # under label noise (EXPERIMENTS.md
                                    # §Paper-validation), default off
    retainer: bool = True           # False = Base-NR cold pool
    recruit_mean_s: float = 45.0
    cold_recruit_mean_s: float = 200.0
    session_mean_s: float = 1800.0
    seed: int = 0


@dataclass
class LabelResult:
    total_time: float = 0.0
    n_labels: int = 0
    task_latencies: list = field(default_factory=list)
    batch_latencies: list = field(default_factory=list)
    mpl_per_batch: list = field(default_factory=list)
    emp_mpl_per_batch: list = field(default_factory=list)
    cost_wait: float = 0.0
    cost_work: float = 0.0
    n_replaced: int = 0
    n_assignments: int = 0
    accuracy: float = 0.0           # label accuracy vs ground truth

    @property
    def throughput(self):
        return self.n_labels / max(self.total_time, 1e-9)

    @property
    def latency_std(self):
        return float(np.std(self.task_latencies)) if self.task_latencies else 0.0

    @property
    def cost(self):
        return self.cost_wait + self.cost_work


class ClamShell:
    def __init__(self, cfg, population: Optional[Population] = None,
                 *, seed: int = 0, device="cuda"):
        if not isinstance(cfg, CSConfig):
            # declarative ScenarioSpec (CSConfig carries its seed, so the
            # spec path takes it as a keyword here)
            from repro_torch.scenarios.compile import to_cs_config
            cfg = to_cs_config(cfg, seed=seed)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.loop = EventLoop()
        self.pop = population or Population(seed=cfg.seed)
        self.pool = RetainerPool(
            self.loop, self.pop, cfg.pool_size,
            recruit_mean_s=(cfg.recruit_mean_s if cfg.retainer
                            else cfg.cold_recruit_mean_s),
            session_mean_s=cfg.session_mean_s,
            seed=cfg.seed,
        )
        self.maintainer = Maintainer(self.pool, cfg.pm_l,
                                     use_termest=cfg.use_termest,
                                     quality_threshold=cfg.quality_threshold,
                                     device=self.device)
        self.lifeguard = LifeGuard(
            self.loop, self.pool, straggler=cfg.straggler, routing=cfg.routing,
            maintainer=self.maintainer, seed=cfg.seed)
        self.maintainer.lifeguard = self.lifeguard
        self.rng = np.random.default_rng(cfg.seed + 4242)
        if cfg.retainer:
            self.pool.fill()          # recruitment amortized (paper §6.1)
        else:
            for _ in range(cfg.pool_size):  # Base-NR: workers trickle in
                self.pool._recruit_async()
        self._tid = 0

    # ------------------------------------------------------------ tasks ----
    def _mk_task(self, true_label=0, n_classes=2, payload=None):
        t = Task(self._tid, true_label=true_label, n_classes=n_classes,
                 n_records=self.cfg.n_records,
                 votes_needed=self.cfg.votes_needed)
        t.payload = payload
        self._tid += 1
        return t

    # -------------------------------------------------------- labeling ----
    def run_labeling(self, n_tasks: int, *, true_labels=None, n_classes=2,
                     max_time: float = 10 * 3600.0,
                     trace=None) -> LabelResult:
        """``trace`` takes a :class:`repro_torch.obs.trace.EventsTrace`: a
        purely observational host-side recorder fed after each completed
        batch (the simulation itself is bit-identical with or without
        it)."""
        res = LabelResult()
        batch_size = max(1, int(round(self.cfg.pool_size / self.cfg.batch_ratio)))
        labels = (true_labels if true_labels is not None
                  else np.zeros(n_tasks, dtype=int))
        todo = [self._mk_task(int(labels[i]), n_classes, payload=i)
                for i in range(n_tasks)]
        t_start = self.loop.now
        correct = 0

        while todo and self.loop.now - t_start < max_time:
            batch, todo = todo[:batch_size], todo[batch_size:]
            t0 = self.loop.now
            done_flag = {}
            self.lifeguard.submit_batch(batch, lambda b: done_flag.update(d=1))
            self.loop.run_until(t_start + max_time, stop=lambda: "d" in done_flag)
            if "d" not in done_flag:
                break
            self.maintainer.sweep()   # batch-boundary maintenance pass
            res.batch_latencies.append(self.loop.now - t0)
            res.mpl_per_batch.append(self.pool.mean_pool_latency())
            lat = [t.completed_at - t.created_at for t in batch]
            res.task_latencies.extend(lat)
            emp = [v[2] for t in batch for v in t.votes]
            res.emp_mpl_per_batch.append(float(np.mean(emp)))
            res.n_labels += len(batch) * self.cfg.n_records
            correct += sum(1 for t in batch if t.result == t.true_label)
            if trace is not None:
                trace.record_batch(batch, t0=t0, t_end=self.loop.now)

        res.total_time = self.loop.now - t_start
        res.cost_wait = self.pool.cost_wait
        res.cost_work = self.pool.cost_work
        res.n_replaced = len(self.maintainer.replaced_log)
        res.n_assignments = sum(w.n_started for w in self.pool.workers.values()) \
            + self._tid  # lower bound incl. departed workers
        res.accuracy = correct / max(self._tid, 1)
        return res

    # -------------------------------------------------------- learning ----
    def run_learning(self, X, y, X_test, y_test, *, label_budget: int = 500,
                     max_time: float = 6 * 3600.0):
        """Returns (curve, result): curve = [(sim_time, n_labeled, test_acc)]."""
        cfg = self.cfg
        n, d = X.shape
        n_classes = int(y.max()) + 1
        learner = LogisticLearner(d, n_classes, seed=cfg.seed,
                                  device=self.device)
        stale = LogisticLearner(d, n_classes, seed=cfg.seed,
                                device=self.device)  # selection model
        labeled: dict[int, int] = {}
        is_active: dict[int, bool] = {}
        curve = [(0.0, 0, learner.score(X_test, y_test))]
        res = LabelResult()
        t_start = self.loop.now
        retraining = {"busy": False}

        def retrain_async():
            if retraining["busy"] or not labeled:
                return
            retraining["busy"] = True
            idx = np.fromiter(labeled.keys(), dtype=np.int64)
            yy = np.fromiter((labeled[i] for i in idx), dtype=np.int64)
            if cfg.reweight_active and cfg.learner == "HL":
                sw = np.where([is_active.get(i, False) for i in idx],
                              cfg.al_fraction, 1.0)
            else:
                sw = np.ones(len(idx))

            def done():
                learner.fit(X[idx], yy, sample_weight=sw)
                stale.W, stale.b = learner.W, learner.b
                stale.version = learner.version
                curve.append((self.loop.now - t_start, len(labeled),
                              learner.score(X_test, y_test)))
                retraining["busy"] = False

            if cfg.async_retrain:
                self.loop.after(cfg.decision_latency_s, done)
            else:
                done()  # synchronous: charge latency to the batch below

        while len(labeled) < label_budget and self.loop.now - t_start < max_time:
            p = cfg.pool_size
            unl = np.setdiff1d(np.arange(n), np.fromiter(labeled, np.int64, len(labeled)))
            if len(unl) == 0:
                break
            if cfg.learner == "PL":
                k_active = 0
                batch_n = p
            elif cfg.learner == "AL":
                k_active = min(cfg.al_batch, len(unl))
                batch_n = k_active
            else:  # HL
                k_active = min(int(round(cfg.al_fraction * p)), len(unl))
                batch_n = p
            batch_n = min(batch_n, len(unl), label_budget - len(labeled))
            k_active = min(k_active, batch_n)

            cand = self.rng.choice(unl, min(cfg.uncertainty_sample, len(unl)),
                                   replace=False)
            act = stale.select_uncertain(X, cand, k_active) if k_active else \
                np.array([], dtype=np.int64)
            rest = np.setdiff1d(unl, act)
            n_pass = batch_n - len(act)
            pas = self.rng.choice(rest, min(n_pass, len(rest)), replace=False) \
                if n_pass > 0 else np.array([], dtype=np.int64)
            chosen = np.concatenate([act, pas]).astype(np.int64)
            if len(chosen) == 0:
                break

            if not cfg.async_retrain and cfg.learner in ("AL", "HL"):
                # synchronous decision latency blocks the batch (paper §5.3)
                end = {}
                self.loop.after(cfg.decision_latency_s, lambda: end.update(d=1))
                self.loop.run_until(stop=lambda: "d" in end)

            tasks = [self._mk_task(int(y[i]), n_classes, payload=int(i))
                     for i in chosen]
            for t, i in zip(tasks, chosen):
                is_active[int(i)] = bool(i in act)
            t0 = self.loop.now
            flag = {}
            self.lifeguard.submit_batch(tasks, lambda b: flag.update(d=1))
            self.loop.run_until(t_start + max_time, stop=lambda: "d" in flag)
            if "d" not in flag:
                break
            self.maintainer.sweep()
            res.batch_latencies.append(self.loop.now - t0)
            for t in tasks:
                labeled[t.payload] = t.result
                res.task_latencies.append(t.completed_at - t.created_at)
            res.n_labels = len(labeled)
            retrain_async()

        # drain any pending retrain event so the curve includes the last fit
        self.loop.run_until(self.loop.now + cfg.decision_latency_s + 1)
        res.total_time = self.loop.now - t_start
        res.cost_wait = self.pool.cost_wait
        res.cost_work = self.pool.cost_work
        res.n_replaced = len(self.maintainer.replaced_log)
        return curve, res


def time_to_accuracy(curve, target):
    for t, n, acc in curve:
        if acc >= target:
            return t
    return float("inf")


def acc_at_time(curve, t):
    """Best accuracy reached by sim-time t."""
    best = 0.0
    for tt, n, acc in curve:
        if tt <= t:
            best = max(best, acc)
    return best
