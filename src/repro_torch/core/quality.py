"""Quality control: redundancy voting and Dawid-Skene worker-accuracy EM.

Port of ``src/repro/core/quality.py``. The EM engine is the batched
PyTorch Dawid-Skene in :mod:`repro_torch.labelstream.aggregate`;
:func:`em_worker_accuracy` is its list-of-votes front door. The scalar
dict-based implementation survives as :func:`em_worker_accuracy_ref`, the
parity oracle, not a production path.
"""
from __future__ import annotations

import numpy as np


def majority_vote(votes, n_classes: int) -> int:
    counts = np.zeros(max(n_classes, 1))
    for label, *_ in votes:
        counts[label] += 1
    return int(counts.argmax())


def weighted_vote(votes, n_classes: int, acc_by_worker: dict) -> int:
    """Log-odds weighted vote using estimated worker accuracies.

    Estimated accuracies are clipped away from {0, 1} before the log-odds
    transform, so one worker at the boundary cannot carry an infinite
    weight. An empty vote list returns class 0.
    """
    scores = np.zeros(max(n_classes, 1))
    for label, wid, *_ in votes:
        a = np.clip(acc_by_worker.get(wid, 0.7), 0.51, 0.999)
        scores[label] += np.log(a / (1 - a))
    return int(scores.argmax())


def em_worker_accuracy(task_votes, n_classes: int, *, iters: int = 20,
                       device="cuda"):
    """One-coin Dawid-Skene EM (vectorized engine).

    task_votes: list of [(label, worker_id), ...] per task (empty vote
    lists get a uniform posterior). Returns ``(posterior_labels,
    acc_by_worker)`` like the scalar reference.
    """
    from repro_torch.labelstream.aggregate import aggregate_votes
    labels, acc, _ = aggregate_votes(task_votes, n_classes, iters=iters,
                                     one_coin=True, device=device)
    return labels, acc


def em_worker_accuracy_ref(task_votes, n_classes: int, *, iters: int = 20):
    """Scalar one-coin Dawid-Skene EM — the readable reference the
    vectorized engine is held against.

    Tasks with empty vote lists keep a uniform posterior; estimated
    accuracies are clipped away from 0/1 before entering ``log``;
    degenerate inputs (no votes at all, or fewer than two classes) return
    label 0 everywhere.
    """
    workers = sorted({w for votes in task_votes for _, w in votes})
    if not workers or n_classes < 2:
        return [0] * len(task_votes), {w: 0.8 for w in workers}
    acc = {w: 0.8 for w in workers}
    post = [np.ones(n_classes) / n_classes for _ in task_votes]
    for _ in range(iters):
        # E-step: posterior over true labels
        for i, votes in enumerate(task_votes):
            logp = np.zeros(n_classes)
            for label, w in votes:
                a = np.clip(acc[w], 1e-3, 1 - 1e-3)
                for c in range(n_classes):
                    logp[c] += np.log(a if c == label
                                      else (1 - a) / (n_classes - 1))
            p = np.exp(logp - logp.max())
            post[i] = p / p.sum()
        # M-step: worker accuracies
        num = {w: 1.0 for w in workers}   # +1 smoothing
        den = {w: 2.0 for w in workers}
        for i, votes in enumerate(task_votes):
            for label, w in votes:
                num[w] += post[i][label]
                den[w] += 1.0
        acc = {w: num[w] / den[w] for w in workers}
    labels = [int(p.argmax()) for p in post]
    return labels, acc
