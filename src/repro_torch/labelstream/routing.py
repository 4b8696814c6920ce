"""Worker-aware task routing (FROG-style) for the streaming router.

Port of ``src/repro/labelstream/routing.py``:

  * :func:`route_scores` builds a (pool, window) score matrix from the
    online per-worker accuracy estimate and a completion-latency EWMA:
    uncertain tasks rank workers by accuracy, easy tasks by speed;
  * :func:`scored_match` greedily assigns workers, in descending priority,
    to their best still-free task, tier-1 before tier-2; under a constant
    score matrix it is ``priority_match`` bit for bit;
  * :func:`admit_select` admits the most uncertain queued tasks first;
  * :func:`learnability_features` and :func:`admit_scores` weight that
    uncertainty by the learnability head's estimate
    (``admission="uncertain_learnable"``).

Every function takes a leading batch dim ``B = n_reps * n_shards`` in place
of the reference's ``vmap``s. Nothing calls ``.item()``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.learning.linear import _segment_sum, ordered_matmul


@dataclasses.dataclass(frozen=True)
class RoutingConfig:
    """Static knobs for worker-aware routing and backlog admission; fields
    and defaults as in the reference."""
    enabled: bool = False
    w_acc: float = 3.0
    w_speed: float = 0.5
    ewma_alpha: float = 0.25
    # "fifo" | "uncertain" | "uncertain_learnable"
    admission: str = "fifo"


def _pool_sum(x):
    """Sum of ``(..., P)`` over the pool axis, one element after another: the
    order of the reference's CPU reduction, on the CPU and the card alike."""
    P = x.shape[-1]
    return _segment_sum(x.reshape(-1, P, 1), P).reshape(x.shape[:-1])


def _standardize(x):
    """Zero mean, unit population standard deviation over the pool axis
    (last), floored at 1e-6, rounded as the reference rounds on the CPU.

    That matters at cold start: a pool of equal values does not standardize
    to zeros, because the sequential mean rounds and the floor scales the
    ulp-sized residue up to ~0.1 — whose sign sets every worker's
    preference. The reference's CPU reduction adds in index order and
    fuses the variance's squares into the sum (an ``fma`` per element);
    the squares here are exact in float64 and each partial sum is rounded
    back to float32, which is that ``fma`` but for a double rounding once
    in ~2^29 steps. The same code runs on the CPU and the card."""
    P = x.shape[-1]
    mu = _pool_sum(x) / P
    c = (x - mu[..., None]).double()
    sq = c * c
    acc = torch.zeros_like(mu)
    for i in range(P):
        acc = (sq[..., i] + acc.double()).float()
    # a correctly rounded square root, as the reference's (torch's own
    # float32 one on the CPU is not always)
    sd = torch.sqrt((acc / P).double()).float()
    return (x - mu[..., None]) / torch.clamp(sd, min=1e-6)[..., None]


def route_scores(acc_hat, lat_ewma, unc, rcfg: RoutingConfig):
    """(B, pool, window) scores ``w_acc * u_t * A_w + w_speed * (1 - u_t) *
    S_w``, with A / S the standardized accuracy log-odds and negative
    log-latency of ``acc_hat`` / ``lat_ewma`` (B, pool) and u the task
    uncertainty ``unc`` (B, window) clipped to [0, 1]."""
    a = _standardize(torch.log(acc_hat) - torch.log1p(-acc_hat))
    s = _standardize(-torch.log(lat_ewma))
    u = torch.clamp(unc, 0.0, 1.0)
    speed = (rcfg.w_speed * (1.0 - u))[:, None, :] * s[:, :, None]
    # the reference's CPU build fuses the first product into the sum (one
    # fma); in float64 that product is exact and the sum rounds once
    return ((rcfg.w_acc * u)[:, None, :].double() * a[:, :, None].double()
            + speed.double()).float()


def scored_match(scores, avail, tier1, tier2, shift):
    """Greedy worker-aware matching over ``scores`` (B, P, W): workers in
    descending priority (their best score on an eligible task; ties by
    slot), each available one taking its best-scoring still-free task,
    tier-1 tasks strictly before tier-2, task ties broken in slot order
    rotated by ``shift`` (B,). ``tier1`` and ``tier2`` (B, W) are disjoint.

    The reference's scan over worker slots is a loop over the P priority
    ranks, each step batched over B. Returns ``(take, task_for_w,
    took_tier1, n_tier1)`` as ``priority_match`` does."""
    Bn, P, W = scores.shape
    dev = scores.device
    rot = torch.arange(W, device=dev)
    # rotated task space: rotated index i is window slot (i + shift) % W
    perm = (rot + shift[:, None]) % W
    t1r = torch.gather(tier1, 1, perm)
    t2r = torch.gather(tier2, 1, perm)
    sr = torch.gather(scores, 2, perm[:, None, :].expand(Bn, P, W))
    neg = -float("inf")          # a host number: no copy to the device
    prio = torch.where((t1r | t2r)[:, None, :], sr, neg).amax(-1)
    # stable: equal priorities keep slot order, which makes constant scores
    # collapse to priority_match
    worder = torch.argsort(-prio, dim=1, stable=True)
    s_o = torch.gather(sr, 1, worder[..., None].expand(Bn, P, W))
    av_o = torch.gather(avail, 1, worder)
    taken = torch.zeros((Bn, W), dtype=torch.bool, device=dev)
    take_o, j_o, took1_o = [], [], []
    for p in range(P):
        c1 = t1r & ~taken
        c2 = t2r & ~taken
        any1 = c1.any(-1)
        cand = torch.where(any1[:, None], c1, c2)
        take_w = av_o[:, p] & cand.any(-1)
        # the first maximum wins ties, as jnp.argmax
        j = torch.argmax(torch.where(cand, s_o[:, p], neg), dim=-1)
        taken = taken | ((rot == j[:, None]) & take_w[:, None])
        take_o.append(take_w)
        j_o.append(j)
        took1_o.append(take_w & any1)
    # scatter the priority-ordered outputs back to worker slots
    back = lambda vals: torch.empty_like(vals).scatter(1, worder, vals)
    take = back(torch.stack(take_o, 1))
    took_tier1 = back(torch.stack(took1_o, 1))
    task_for_w = back((torch.stack(j_o, 1) + shift[:, None]) % W)
    return take, task_for_w, took_tier1, tier1.sum(-1)


def admit_select(unc, occupied, n_adm):
    """Most-uncertain-first backlog admission: ranks occupied slots of ``unc``
    (B, Q) by descending value (ties by slot) and admits the first
    ``n_adm`` (B,). Returns ``(admit, order)``: the per-slot admit mask and
    the ranking, ``order[:, r]`` the slot of the r-th admitted task."""
    Q = unc.shape[-1]
    key = torch.where(occupied, unc, -float("inf"))   # empty slots last
    order = torch.argsort(-key, dim=-1, stable=True)
    ranks = torch.arange(Q, device=unc.device).expand_as(order)
    rank = torch.empty_like(order).scatter(1, order, ranks)
    return occupied & (rank < n_adm[:, None]), order


def learnability_features(feat):
    """Square-augmented features ``[x, x^2]`` (..., 2F) for the
    learnability head."""
    return torch.cat([feat, feat * feat], dim=-1)


def admit_scores(unc, feat, gW, gb):
    """``uncertainty x learnability``: ``unc`` (..., Q) times the
    learnability head's class-1 probability on ``feat`` (..., Q, F) under
    ``gW`` (..., 2F, 2) / ``gb`` (..., 2). An untrained (zero) head scores
    0.5 everywhere. The head's product is ``ordered_matmul``: the same
    rounding on the CPU and the card."""
    logits = ordered_matmul(learnability_features(feat), gW) \
        + gb[..., None, :]
    return unc * torch.softmax(logits, dim=-1)[..., 1]
