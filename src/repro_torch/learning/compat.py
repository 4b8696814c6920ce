"""Object-style wrapper over the batched learner, for the event loop.

Port of ``src/repro/learning/compat.py``. :class:`LogisticLearner` is the
mutable API the scalar event loop (``core/clamshell.py``) was written
against. Every operation delegates to
:mod:`repro_torch.learning.linear`, so the numerics are the batched
engines': each :meth:`~LogisticLearner.fit` starts Adam from fresh moments
and takes ``steps`` (120) full-batch steps at lr 0.15 and l2 1e-3.

``W`` and ``b`` stay on the learner's ``device`` between calls. The event
loop is host code, so :meth:`~LogisticLearner.predict_proba`,
:meth:`~LogisticLearner.uncertainty` and
:meth:`~LogisticLearner.select_uncertain` return numpy arrays: one copy
from the device per call.

Uncertainty goes through :func:`repro_torch.learning.linear.entropy`: the
Hopper ``entropy_scores`` kernel for CUDA tensors, its plain version for
CPU tensors (``use_kernel=False`` forces the plain version on the card).
The reference forces its jnp oracle here; the port follows its own rule,
so the card's selection goes through the kernel.

``select_uncertain`` breaks equal-entropy ties by ascending candidate
position (a stable argsort of the negated entropies), as the reference
does.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.learning import linear as _linear


@dataclass
class LogisticLearner:
    """Multinomial logistic regression on ``device``, refit from scratch on
    every :meth:`fit`."""
    n_features: int
    n_classes: int
    seed: int = 0
    steps: int = 120
    W: Optional[torch.Tensor] = field(default=None, repr=False)
    b: Optional[torch.Tensor] = field(default=None, repr=False)
    version: int = 0
    device: object = "cuda"
    use_kernel: Optional[bool] = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        st = _linear.init(self.n_features, self.n_classes,
                          device=self.device)
        self.W, self.b = st.W, st.b

    def _x(self, X):
        return torch.as_tensor(np.asarray(X, np.float32), device=self.device)

    def fit(self, X, y, sample_weight=None):
        if len(y) == 0:
            return self
        y = torch.as_tensor(np.asarray(y, np.int64), device=self.device)
        sw = (torch.ones((len(y),), device=self.device)
              if sample_weight is None else
              torch.as_tensor(np.asarray(sample_weight, np.float32),
                              device=self.device))
        st = _linear.fit(_linear.with_params(self.W, self.b), self._x(X), y,
                         sw, steps=self.steps)
        self.W, self.b = st.W, st.b
        self.version += 1
        return self

    def _state(self) -> "_linear.LinearLearner":
        return _linear.with_params(self.W, self.b)

    def predict_proba(self, X):
        return _linear.predict_proba(self._state(), self._x(X)).cpu().numpy()

    def predict(self, X):
        return self.predict_proba(X).argmax(-1)

    def score(self, X, y):
        return float((self.predict(X) == np.asarray(y)).mean())

    def uncertainty(self, X):
        return _linear.entropy(self._state(), self._x(X),
                               use_kernel=self.use_kernel).cpu().numpy()

    def select_uncertain(self, X_pool, candidates: np.ndarray, k: int):
        """Top-k most uncertain among ``candidates`` (row indices into
        ``X_pool``); equal-entropy ties break by ascending candidate
        position."""
        if k <= 0 or len(candidates) == 0:
            return np.array([], dtype=np.int64)
        u = self.uncertainty(X_pool[candidates])
        order = np.argsort(-u, kind="stable")
        return candidates[order[:k]]
