"""Batched linear learner — the model half of hybrid learning.

Port of ``src/repro/learning/linear.py``. The learner is a
:class:`LinearLearner` NamedTuple of tensors (params + Adam moments + step
counter) and every operation is a function of it. Every tensor may carry
leading replication dims in front of the reference's shapes: ``W`` is
``(..., d, C)``, ``b`` ``(..., C)``, ``t`` ``(...)``; a feature matrix
``X`` is ``(n, d)`` shared by all replications (or ``(..., n, d)``).

Optimizer semantics are the reference's: bias-corrected Adam, lr 0.15, l2
on W only, the weighted NLL divided by ``max(sum(sw), 1e-9)``, moments
reset per :func:`fit` call unless ``fresh_opt=False``. The gradient is the
closed form ``X^T (sw (p - onehot)) / max(sum(sw), 1e-9) + 2 l2 W``, in
the reference's autodiff op order (see :func:`_step`).

Uncertainty scoring goes through the Hopper entropy kernel
(:mod:`repro_torch.kernels.uncertainty`) for every class width on the card
— the reference's ``MIN_KERNEL_CLASSES`` gate exists because its TPU
kernel pads the class axis to a 512-lane tile, which a CUDA row kernel does
not — and through the plain version on the CPU. ``use_kernel=False``
forces the plain version.

Matrix products run in full float32, as the reference's: ``logits`` and
the gradient's product run inside :func:`repro_torch.device.full_fp32`
(no TF32). With ``ordered=True`` they go through :func:`ordered_matmul`
instead, which rounds the same on the CPU and the card: the stream's
learner, whose every product decides integers, takes that path.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.device import full_fp32, resolve_device
from repro_torch.kernels.ref import entropy_ref
from repro_torch.kernels.uncertainty import entropy_scores


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


def init(n_features: int, n_classes: int, lead=(), device="cuda"
         ) -> LinearLearner:
    """Zero-initialized learner (uniform predictions) with leading dims
    ``lead``."""
    dev = resolve_device(device)
    lead = tuple(lead)
    W = torch.zeros(lead + (n_features, n_classes), device=dev)
    b = torch.zeros(lead + (n_classes,), device=dev)
    return LinearLearner(W, b, torch.zeros_like(W), torch.zeros_like(b),
                         torch.zeros_like(W), torch.zeros_like(b),
                         torch.zeros(lead, dtype=torch.int32, device=dev))


def with_params(W, b) -> LinearLearner:
    """A learner holding ``W`` and ``b`` with fresh Adam state."""
    return LinearLearner(W, b, torch.zeros_like(W), torch.zeros_like(b),
                         torch.zeros_like(W), torch.zeros_like(b),
                         torch.zeros(W.shape[:-2], dtype=torch.int32,
                                     device=W.device))


def from_numpy(leaves, device="cuda") -> LinearLearner:
    """The port's learner from the reference's ``LinearLearner`` leaves
    (``W, b, m_W, m_b, v_W, v_b, t`` as numpy arrays, in that order, any
    leading dims), on ``device``."""
    dev = resolve_device(device)
    leaves = [np.asarray(a) for a in leaves]
    if len(leaves) != len(LinearLearner._fields):
        raise ValueError(f"expected {len(LinearLearner._fields)} leaves "
                         f"{LinearLearner._fields}, got {len(leaves)}")
    *fl, t = leaves
    return LinearLearner(
        *(torch.tensor(a, dtype=torch.float32, device=dev) for a in fl),
        torch.tensor(t, dtype=torch.int32, device=dev))


def reset_opt(state: LinearLearner) -> LinearLearner:
    """Fresh Adam moments, same params (scratch-refit semantics)."""
    return with_params(state.W, state.b)


def ordered_matmul(A, B) -> torch.Tensor:
    """``A (..., n, k) @ B (..., k, m)``, each output the sum of its k
    products added in index order by one sequential ``segment_reduce``: the
    same rounding on the CPU and the card, for any batch size (cuBLAS picks
    its order by shape). For small contractions; it holds all n·k·m
    products at once."""
    p = A[..., :, :, None] * B[..., None, :, :]
    lead, k, m = p.shape[:-2], p.shape[-2], p.shape[-1]
    return _segment_sum(p.reshape((-1, k, m)), k).reshape(lead + (m,))


def _matmul(A, B, ordered: bool):
    if ordered:
        return ordered_matmul(A, B)
    with full_fp32():
        return torch.matmul(A, B)


def logits(state: LinearLearner, X, ordered: bool = False) -> torch.Tensor:
    return _matmul(X, state.W, ordered) + state.b[..., None, :]


def predict_proba(state: LinearLearner, X) -> torch.Tensor:
    return torch.softmax(logits(state, X), dim=-1)


def predict(state: LinearLearner, X) -> torch.Tensor:
    return logits(state, X).argmax(-1)


def test_accuracy(state: LinearLearner, X, y) -> torch.Tensor:
    """Mean 0/1 accuracy on (X, y), one float32 value per replication."""
    return (predict(state, X) == y).to(torch.float32).mean(-1)


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


def _step(state: LinearLearner, X, onehot, ws, lr: float, l2: float,
          ordered: bool = False) -> LinearLearner:
    """One Adam step with the per-row loss weights ``ws = sw / max(sum sw,
    1e-9)`` and one-hot targets precomputed.

    The gradient is the reference's autodiff, op for op: ``g = e * (ws /
    sum e) - onehot * ws`` with ``e = exp(z - max z)``, and the bias
    gradient sums rows in XLA's order (:func:`_row_sum`). That matters where
    a sum is zero in exact arithmetic — a class-balanced label set at
    uniform predictions — and rounds to a residue of ~1e-9 that the
    normalized Adam step turns into a step of up to ``lr``."""
    z = logits(state, X, ordered)
    e = torch.exp(z - z.amax(-1, keepdim=True))
    g = e * (ws / e.sum(-1))[..., None] - onehot * ws[..., None]
    gW = _matmul(X.transpose(-1, -2), g, ordered) + 2.0 * (l2 * state.W)
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


def fit_step(state: LinearLearner, X, y, sw, *, lr: float = 0.15,
             l2: float = 1e-3) -> LinearLearner:
    """One bias-corrected Adam step on the weighted multinomial NLL; ``y``
    and ``sw`` are ``(..., n)``."""
    onehot, ws = _targets(y, sw, state.n_classes)
    return _step(state, X, onehot, ws, lr, l2)


def fit(state: LinearLearner, X, y, sw, *, steps: int = 120,
        lr: float = 0.15, l2: float = 1e-3,
        fresh_opt: bool = True, ordered: bool = False) -> LinearLearner:
    """``steps`` Adam steps; a no-op for every replication whose rows all
    have zero weight.

    ``sw`` is the per-row weight — zero rows are unlabeled. ``fresh_opt``
    resets the Adam moments first (refit from scratch); pass False for
    online updates that keep momentum across calls. ``ordered`` computes
    the products with :func:`ordered_matmul`.
    """
    if fresh_opt:
        state = reset_opt(state)
    onehot, ws = _targets(y, sw, state.n_classes)
    new = state
    for _ in range(steps):
        new = _step(new, X, onehot, ws, lr, l2, ordered)
    has = sw.sum(-1) > 0
    k = has.dim()
    return LinearLearner(*(
        torch.where(has.reshape(has.shape + (1,) * (a.dim() - k)), a, b)
        for a, b in zip(new, state)))


def entropy(state: LinearLearner, X, *, use_kernel: Optional[bool] = None
            ) -> torch.Tensor:
    """Predictive entropy per row — the hybrid-learning hot path."""
    return entropy_from_logits(logits(state, X), use_kernel=use_kernel)


def entropy_from_logits(lg, *, use_kernel: Optional[bool] = None
                        ) -> torch.Tensor:
    """Entropy of ``(..., V)`` logits: the kernel for CUDA tensors (plain
    version for CPU tensors) unless ``use_kernel`` is False, which forces
    the plain version. ``None`` and True are the same here: the card takes
    every class width."""
    if use_kernel is False:
        return entropy_ref(lg)
    return entropy_scores(lg)
