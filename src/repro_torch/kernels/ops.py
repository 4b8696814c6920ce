"""Public operations over the port's kernels (port of
``src/repro/kernels/ops.py``).

``attention``, ``linear_scan``, ``entropy_scores`` and ``streaming_xent``
dispatch on ``impl``: ``"ref"`` runs the plain version
(:mod:`repro_torch.kernels.ref`), ``"auto"`` the kernel's wrapper, which
launches the Hopper kernel for CUDA tensors (and raises without one) and
runs the plain version for CPU tensors. ``attention`` keeps the
reference's (B, H, S, D) layout. ``uncertainty_topk``: entropy scores
through the wrapper, then the top ``k`` rows with JAX ``top_k``'s tie
order, lower index first.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref as _ref
from repro_torch.kernels.flash_attention import flash_attention as _flash
from repro_torch.kernels.linear_scan import linear_scan as _lscan
from repro_torch.kernels.uncertainty import entropy_scores as _entropy
from repro_torch.kernels.xent import streaming_xent as _xent


def _plain(impl: str) -> bool:
    if impl not in ("auto", "ref"):
        raise ValueError(f"impl must be 'auto' or 'ref', got {impl!r}")
    return impl == "ref"


def attention(q, k, v, *, causal=True, window=0, impl="auto"):
    """GQA attention of q (B, Hq, S, D) over k, v (B, Hkv, S, D) ->
    (B, Hq, S, D) in q's dtype."""
    if _plain(impl):
        return _ref.attention_ref(q, k, v, causal=causal, window=window)
    t = lambda x: x.transpose(1, 2)
    return t(_flash(t(q), t(k), t(v), causal=causal, window=window))


def linear_scan(a, b, h0=None, *, impl="auto"):
    """h_t = a_t * h_{t-1} + b_t over (B, S, D), from h0 (B, D) or zero."""
    if _plain(impl):
        return _ref.linear_scan_ref(a, b, h0)
    return _lscan(a, b, h0)


def entropy_scores(logits, *, impl="auto"):
    """Predictive entropy per row of (N, V) logits -> (N,) float32."""
    if _plain(impl):
        return _ref.entropy_ref(logits)
    return _entropy(logits)


def streaming_xent(logits, targets, *, impl="auto"):
    """Per-row cross entropy LSE(logits) - logits[target] of (N, V) logits
    and (N,) targets -> (N,) float32, differentiable in the logits (the
    Hopper forward and backward kernels on the card)."""
    if _plain(impl):
        return _ref.xent_ref(logits, targets)
    return _xent(logits, targets)


def uncertainty_topk(logits, k: int):
    """``(values, indices)`` of the ``k`` highest-entropy rows of ``(..., N,
    V)`` logits, along the row axis, in descending entropy; equal
    entropies go lower index first (a stable descending sort, since
    ``torch.topk``'s tie order is unspecified)."""
    scores = _entropy(logits)
    if not 0 <= k <= scores.shape[-1]:
        raise ValueError(f"k={k} outside [0, {scores.shape[-1]}]")
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]
