"""Deterministic synthetic token corpus and straggler-mitigated prefetch
(port of ``src/repro/data/corpus.py``, the port's own copy: numpy and the
standard library, no torch).

``make_batch`` is a pure function of (config, step) and gives the
reference's batches bit for bit. ``PrefetchLoader`` prefetches on a
background thread and speculatively duplicates a fetch that outlasts
``straggler_timeout`` (first result wins: CLAMShell's straggler
mitigation applied to the input pipeline). It takes a ``start_step``,
which the reference's loader lacks: a trainer that restores step n starts
its loader at batch n, so a run that crashes and resumes sees the same
batches as a run straight through.
"""
from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass

import numpy as np


@dataclass
class CorpusConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_shards: int = 1
    shard_id: int = 0
    zipf_a: float = 1.3


def make_batch(cfg: CorpusConfig, step: int):
    """Pure function of (cfg, step) -> {'tokens','targets'} for this shard."""
    rng = np.random.default_rng(
        np.random.SeedSequence([cfg.seed, cfg.shard_id, step]))
    b = cfg.global_batch // cfg.n_shards
    # zipf-distributed token ids with a simple bigram structure
    z = rng.zipf(cfg.zipf_a, size=(b, cfg.seq_len + 1))
    toks = (z - 1) % cfg.vocab_size
    drift = rng.integers(0, 7, size=(b, 1))
    toks = ((toks + np.cumsum(toks % 3, axis=1) + drift) % cfg.vocab_size)
    toks = toks.astype(np.int32)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


class PrefetchLoader:
    """Background prefetch with speculative duplicate fetches.

    ``fetch`` (default: make_batch) may be slow/hung (remote storage, feature
    service, crowd labels). After ``straggler_timeout`` a duplicate fetch is
    issued; first completion wins — mirroring CLAMShell straggler mitigation.
    The first batch is the one for ``start_step``.
    """

    def __init__(self, cfg: CorpusConfig, *, fetch=None, depth: int = 2,
                 straggler_timeout: float = 1.0, max_duplicates: int = 2,
                 start_step: int = 0):
        self.cfg = cfg
        self.fetch = fetch or (lambda step: make_batch(self.cfg, step))
        self.depth = depth
        self.timeout = straggler_timeout
        self.max_dup = max_duplicates
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.n_duplicates = 0
        self.n_wins_by_duplicate = 0
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _fetch_mitigated(self, step):
        result = {}
        done = threading.Event()
        lock = threading.Lock()

        def attempt(i):
            try:
                out = self.fetch(step)
            except Exception as e:   # a failed fetch = a failed worker
                out = e
            with lock:
                if "val" not in result and not isinstance(out, Exception):
                    result["val"] = out
                    result["winner"] = i
                    done.set()

        threads = [threading.Thread(target=attempt, args=(0,), daemon=True)]
        threads[0].start()
        attempts = 1
        while not done.wait(self.timeout):
            if attempts < self.max_dup + 1:
                t = threading.Thread(target=attempt, args=(attempts,),
                                     daemon=True)
                t.start()
                threads.append(t)
                self.n_duplicates += 1
                attempts += 1
            if self._stop.is_set():
                return None
        if result.get("winner", 0) > 0:
            self.n_wins_by_duplicate += 1
        return result["val"]

    def _run(self):
        while not self._stop.is_set():
            batch = self._fetch_mitigated(self._step)
            if batch is None:
                return
            self._step += 1
            while not self._stop.is_set():
                try:
                    self.q.put(batch, timeout=0.2)
                    break
                except queue.Full:
                    continue

    def __next__(self):
        return self.q.get()

    def __iter__(self):
        return self

    def stop(self):
        self._stop.set()
