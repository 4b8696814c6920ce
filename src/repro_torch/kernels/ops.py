"""Public operations over the port's kernels (port of
``src/repro/kernels/ops.py``).

``uncertainty_topk``: entropy scores through
:func:`repro_torch.kernels.uncertainty.entropy_scores` (the kernel on the
card, its plain version on the CPU), then the top ``k`` rows with JAX
``top_k``'s tie order, lower index first. ``streaming_xent``: the per-row
cross entropy through :func:`repro_torch.kernels.xent.streaming_xent`.
The reference's ``impl="ref"`` switch is not ported: each wrapper picks
its plain version by the tensor's device alone.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.uncertainty import entropy_scores
from repro_torch.kernels.xent import streaming_xent as _xent


def streaming_xent(logits, targets):
    """Per-row cross entropy LSE(logits) - logits[target] of (N, V) logits
    and (N,) targets -> (N,) float32, differentiable in the logits (the
    Hopper forward and backward kernels on the card)."""
    return _xent(logits, targets)


def uncertainty_topk(logits, k: int):
    """``(values, indices)`` of the ``k`` highest-entropy rows of ``(..., N,
    V)`` logits, along the row axis, in descending entropy; equal
    entropies go lower index first (a stable descending sort, since
    ``torch.topk``'s tie order is unspecified)."""
    scores = entropy_scores(logits)
    if not 0 <= k <= scores.shape[-1]:
        raise ValueError(f"k={k} outside [0, {scores.shape[-1]}]")
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]
