"""Pieces of the stream's support modules that the tick needs: the crowd's
pay constants, ``tree_map`` and the bank lookup (frozen copies of the
program's ``core/crowd.py`` constants and ``embed/bank.py``'s
``bank_gather``)."""
from __future__ import annotations

import torch

WAIT_PAY_PER_S = 0.05 / 60.0
WORK_PAY_PER_RECORD = 0.02
SWITCH_DELAY_S = 2.0      # dialog-click delay on termination


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of a tree of dicts and named tuples (a state
    and its learners), with the same-shaped trees ``rest`` alongside; dict
    order and tuple types are kept."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v, *(r[i] for r in rest))
                            for i, v in enumerate(tree)))
    return fn(tree, *rest)


def bank_gather(feats, u, tl, diff):
    """Bank lookup: a uniform ``u`` in [0, 1) picks the variant, ``tl`` the
    class row, ``diff < 1`` the hard half."""
    K = feats.shape[2]
    v = torch.clamp((u * K).to(torch.int64), max=K - 1)
    h = (diff < 1.0).to(torch.int64)
    return feats[h, torch.clamp(tl.to(torch.int64), 0, feats.shape[1] - 1), v]
