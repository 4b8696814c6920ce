"""The stream's batched linear learner (a frozen copy of the program's
``learning/linear.py``, cut to what the tick's fit uses): a
:class:`LinearLearner` of tensors (params, Adam moments, step counter) with
leading replication dims; bias-corrected Adam, l2 on W only, the weighted
NLL divided by ``max(sum(sw), 1e-9)``, the gradient in closed form. Every
product goes through :func:`ordered_matmul`, which adds its terms in index
order, as the stream's learner does on the card.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class LinearLearner(NamedTuple):
    """Multinomial logistic regression + Adam state, all tensors."""
    W: torch.Tensor         # (..., n_features, n_classes)
    b: torch.Tensor         # (..., n_classes)
    m_W: torch.Tensor       # Adam first moments
    m_b: torch.Tensor
    v_W: torch.Tensor       # Adam second moments
    v_b: torch.Tensor
    t: torch.Tensor         # (...) int32 Adam step counter

    @property
    def n_features(self) -> int:
        return self.W.shape[-2]

    @property
    def n_classes(self) -> int:
        return self.W.shape[-1]


def init(n_features: int, n_classes: int, lead=()) -> LinearLearner:
    """Zero-initialized learner (uniform predictions) with leading dims
    ``lead``."""
    lead = tuple(lead)
    W = torch.zeros(lead + (n_features, n_classes))
    b = torch.zeros(lead + (n_classes,))
    return LinearLearner(W, b, torch.zeros_like(W), torch.zeros_like(b),
                         torch.zeros_like(W), torch.zeros_like(b),
                         torch.zeros(lead, dtype=torch.int32))


def ordered_matmul(A, B) -> torch.Tensor:
    """``A (..., n, k) @ B (..., k, m)``, each output the sum of its k
    products added in index order by one sequential ``segment_reduce``: the
    same rounding on the CPU and the card, for any batch size (cuBLAS picks
    its order by shape). For small contractions; it holds all n·k·m
    products at once."""
    p = A[..., :, :, None] * B[..., None, :, :]
    lead, k, m = p.shape[:-2], p.shape[-2], p.shape[-1]
    return _segment_sum(p.reshape((-1, k, m)), k).reshape(lead + (m,))


def logits(state: LinearLearner, X) -> torch.Tensor:
    return ordered_matmul(X, state.W) + state.b[..., None, :]


def _bias_correction(beta: float, t):
    """``1 - beta ** t`` in float32, as the reference computes it."""
    return 1.0 - torch.pow(beta, t.to(torch.float32))


def _row_sum(g):
    """Sum of ``(..., n, C)`` over rows in the order XLA's CPU reduction
    takes: while 32 or more rows remain, zero-pad them to whole windows of
    32 (``pad // 2`` zeros in front, the rest behind: "same" padding) and
    replace them by the window sums, each window added in order; then add
    what remains in order. Each level is one sequential
    ``segment_reduce``, on the CPU and on the card alike."""
    lead, C = g.shape[:-2], g.shape[-1]
    if g.shape[-2] == 0:
        return g.new_zeros(lead + (C,))
    g = g.reshape((-1,) + g.shape[-2:])
    while g.shape[1] >= 32:
        n = g.shape[1]
        pad = -(-n // 32) * 32 - n
        g = torch.nn.functional.pad(g, (0, 0, pad // 2, pad - pad // 2))
        g = _segment_sum(g, 32)
    return _segment_sum(g, g.shape[1]).reshape(lead + (C,))


def _segment_sum(g, size: int):
    lengths = torch.full((g.shape[0], g.shape[1] // size), size,
                         dtype=torch.int64, device=g.device)
    return torch.segment_reduce(g, "sum", lengths=lengths, axis=1,
                                unsafe=True)


def _step(state: LinearLearner, X, onehot, ws, lr: float, l2: float
          ) -> LinearLearner:
    """One Adam step with the per-row loss weights ``ws = sw / max(sum sw,
    1e-9)`` and one-hot targets precomputed.

    The gradient is the reference's autodiff, op for op: ``g = e * (ws /
    sum e) - onehot * ws`` with ``e = exp(z - max z)``, and the bias
    gradient sums rows in XLA's order (:func:`_row_sum`). That matters where
    a sum is zero in exact arithmetic — a class-balanced label set at
    uniform predictions — and rounds to a residue of ~1e-9 that the
    normalized Adam step turns into a step of up to ``lr``."""
    z = logits(state, X)
    e = torch.exp(z - z.amax(-1, keepdim=True))
    g = e * (ws / e.sum(-1))[..., None] - onehot * ws[..., None]
    gW = ordered_matmul(X.transpose(-1, -2), g) + 2.0 * (l2 * state.W)
    gb = _row_sum(g)
    t = state.t + 1
    m_W = 0.9 * state.m_W + 0.1 * gW
    m_b = 0.9 * state.m_b + 0.1 * gb
    v_W = 0.999 * state.v_W + 0.001 * gW * gW
    v_b = 0.999 * state.v_b + 0.001 * gb * gb
    c1 = _bias_correction(0.9, t)
    c2 = _bias_correction(0.999, t)

    def upd(p, m, v, k):
        shape = c1.shape + (1,) * k
        mh = m / c1.reshape(shape)
        vh = v / c2.reshape(shape)
        return p - lr * mh / (torch.sqrt(vh) + 1e-8)

    return LinearLearner(upd(state.W, m_W, v_W, 2), upd(state.b, m_b, v_b, 1),
                         m_W, m_b, v_W, v_b, t)


def _targets(y, sw, n_classes: int):
    onehot = torch.nn.functional.one_hot(y.long(), n_classes).to(torch.float32)
    ws = (1.0 / torch.clamp(sw.sum(-1, keepdim=True), min=1e-9)) * sw
    return onehot, ws


def fit(state: LinearLearner, X, y, sw, *, steps: int, lr: float,
        l2: float) -> LinearLearner:
    """``steps`` Adam steps that keep the moments of the steps before; a
    no-op for every replication whose rows all have zero weight (``sw`` is
    the per-row weight: zero rows are unlabeled)."""
    onehot, ws = _targets(y, sw, state.n_classes)
    new = state
    for _ in range(steps):
        new = _step(new, X, onehot, ws, lr, l2)
    has = sw.sum(-1) > 0
    k = has.dim()
    return LinearLearner(*(
        torch.where(has.reshape(has.shape + (1,) * (a.dim() - k)), a, b)
        for a, b in zip(new, state)))
