"""Active-learning point selection with deterministic tie-breaking.

Port of ``src/repro/learning/select.py``, batched over leading dims.
Uncertainty sampling takes the top-k highest-entropy unlabeled points;
every selection is a STABLE argsort on masked scores, so ties break by
ascending point index on both devices, as in the reference. Shapes stay
fixed: when fewer eligible points exist than requested, the returned
``take`` mask marks the valid prefix.

The reference's ``passive_select`` draws its uniforms from a key; here the
caller passes them (``u``, one per point), so a test can inject the
reference's draws.
"""
from __future__ import annotations

import torch


def topk_uncertain(scores, eligible, k: int):
    """Indices of the top-``k`` ``(..., n)`` scores among ``eligible``
    points: ``(idx, take)``, both ``(..., k)``. ``idx`` is in descending
    score order, ties by ascending index; ``take`` marks entries backed by
    an eligible point (padding entries point at arbitrary indices and must
    be masked by the caller)."""
    masked = torch.where(eligible, scores, torch.full_like(scores, -torch.inf))
    order = torch.argsort(-masked, dim=-1, stable=True)
    n = order.shape[-1]
    if k > n:
        # more slots than points: pad (masked out by `take`, since at most
        # n < k points are eligible)
        order = torch.nn.functional.pad(order, (0, k - n))
    idx = order[..., :k]
    take = (torch.arange(k, device=scores.device)
            < eligible.sum(-1, keepdim=True))
    return idx, take


def al_select(scores, labeled, k: int):
    """Top-``k`` most-uncertain UNLABELED points (the AL half of hybrid)."""
    return topk_uncertain(scores, ~labeled, k)


def passive_select(u, labeled, exclude, k: int):
    """``k`` unlabeled points outside ``exclude``, uniformly at random:
    the ranks of the caller's iid uniforms ``u`` (same shape as
    ``labeled``)."""
    return topk_uncertain(u, ~(labeled | exclude), k)


def hybrid_select(u, scores, labeled, k_active: int, n_passive: int):
    """Paper §5.1 hybrid batch: ``k_active`` uncertain points + a random
    passive fill drawn with the uniforms ``u``.

    Returns ``(chosen, take, act_mask)``: ``chosen`` ``(..., k_active +
    n_passive)`` with the active picks first, ``take`` the validity mask,
    and ``act_mask`` ``(..., n)`` marking the points chosen actively.
    """
    act_idx, act_take = al_select(scores, labeled, k_active)
    n = labeled.shape[-1]
    # padding entries go to a dump column so they cannot mark a point
    dump = torch.zeros(labeled.shape[:-1] + (n + 1,), dtype=torch.bool,
                       device=labeled.device)
    act_mask = dump.scatter_(
        -1, torch.where(act_take, act_idx, torch.full_like(act_idx, n)),
        True)[..., :n]
    pas_idx, pas_take = passive_select(u, labeled, act_mask, n_passive)
    chosen = torch.cat([act_idx, pas_idx], -1)
    take = torch.cat([act_take, pas_take], -1)
    return chosen, take, act_mask
