"""Posterior-confidence adaptive redundancy (vote-budget policy).

Port of ``src/repro/labelstream/policy.py``. The adaptive policy requests
votes incrementally — at most ``max_outstanding`` concurrent assignments
per task — and finalizes a task as soon as its Dawid-Skene posterior
clears ``conf_threshold`` (with at least ``min_votes`` votes), falling back
to finalize-at-cap for tasks the crowd cannot agree on. All functions are
tensor functions over a trailing window axis (any leading dims):

  * a task never collects more than ``votes_cap`` votes;
  * a task never finalizes below ``conf_threshold`` with fewer than
    ``votes_cap`` votes.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class PolicyConfig:
    adaptive: bool = True
    votes_cap: int = 5           # hard per-task budget (== fixed votes_needed)
    conf_threshold: float = 0.92 # finalize early above this posterior mass
    min_votes: int = 1           # never finalize early with fewer votes
    max_outstanding: int = 1     # adaptive: concurrent vote requests per task


def confidence(log_posterior):
    """Max posterior mass per task from unnormalized log-posteriors."""
    return torch.softmax(log_posterior, dim=-1).max(dim=-1).values


def target_outstanding(n_votes, pol: PolicyConfig, cap=None):
    """How many assignments a task wants concurrently active right now:
    the full remaining budget under the fixed policy, at most
    ``max_outstanding`` under the adaptive one. ``cap`` overrides
    ``pol.votes_cap``."""
    cap = pol.votes_cap if cap is None else cap
    remaining = torch.clamp(cap - n_votes, min=0)
    if not pol.adaptive:
        return remaining
    return torch.clamp(remaining, max=pol.max_outstanding)


def should_finalize(log_posterior, n_votes, pol: PolicyConfig, cap=None):
    """(finalize, conf): early-stop when confident, hard-stop at the cap."""
    cap = pol.votes_cap if cap is None else cap
    conf = confidence(log_posterior)
    if pol.adaptive:
        early = (conf >= pol.conf_threshold) & (n_votes >= pol.min_votes)
    else:
        early = torch.zeros_like(n_votes, dtype=torch.bool)
    at_cap = n_votes >= cap
    return (n_votes > 0) & (early | at_cap), conf


def fuse_posteriors(crowd_logpost, model_logpost, weight):
    """Product-of-experts fusion of crowd and learner log-posteriors; the
    learner's contribution is scaled by ``weight`` (a float32 tensor that
    broadcasts, or a number). Rounded as the reference's CPU build rounds
    it, one fma: the product is exact in float64 and the sum rounds once."""
    w = torch.as_tensor(weight, dtype=torch.float32,
                        device=model_logpost.device).double()
    return (crowd_logpost.double() + w * model_logpost.double()).float()


def learner_known(fused_logpost, n_votes, *, threshold: float,
                  min_votes_known: int):
    """Tasks the fused posterior already decides: ``known`` clears
    ``threshold``; ``finalizable`` also has ``min_votes_known`` crowd
    votes."""
    known = confidence(fused_logpost) >= threshold
    return known, known & (n_votes >= min_votes_known)
