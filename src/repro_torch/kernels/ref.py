"""Plain PyTorch versions of the port's kernels: what the wrappers run for
CPU tensors, and what the kernels are held against on the card."""
from __future__ import annotations

import math

import torch


def ds_estep_ref(rows, idx):
    """Dawid-Skene E-step. rows: ([B,] R, C) float32 log-confusion row table
    with a trailing all-zero null row; idx: ([B,] T, V) per-vote row indices
    (null row for padded votes). Returns (logp, post), both ([B,] T, C),
    with the uniform -log C prior included in logp.

    The votes are summed in order (v = 0, 1, ...) before -log C is
    subtracted; the CUDA kernel sums in the same order."""
    C = rows.shape[-1]
    if idx.dim() == 2:
        g = rows[idx.long()]                                 # (T, V, C)
    else:
        b = torch.arange(idx.shape[0], device=idx.device)[:, None, None]
        g = rows[b, idx.long()]                              # (B, T, V, C)
    acc = torch.zeros(g.shape[:-2] + (C,), dtype=rows.dtype,
                      device=rows.device)
    for v in range(g.shape[-2]):
        acc = acc + g[..., v, :]
    logp = acc - math.log(C)
    return logp, torch.softmax(logp, dim=-1)


def entropy_ref(logits):
    """Predictive entropy per row: (..., V) float32 or bfloat16 logits ->
    (...) float32. Same op order as the JAX package's oracle: log-softmax
    in float32, then ``-(exp(logp) * logp).sum(-1)``."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    return -(torch.exp(logp) * logp).sum(-1)


def attention_ref(q, k, v, *, causal=True, window=0):
    """Materialized GQA attention in float32. q: (B, Hq, Sq, D); k, v:
    (B, Hkv, Sk, D); q head h reads kv head h // (Hq // Hkv). Masks by
    index: causal keeps k <= q, a window keeps q - k < window; a masked
    score is -1e30 (a row with no valid key averages v); scores are
    scaled by 1 / sqrt(D). Returns (B, Hq, Sq, D) in q's dtype."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    G = Hq // Hkv
    kk = k.repeat_interleave(G, dim=1).to(torch.float32)
    vv = v.repeat_interleave(G, dim=1).to(torch.float32)
    s = (torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32), kk)
         * (1.0 / math.sqrt(D)))
    qp = torch.arange(Sq, device=q.device)[:, None]
    kp = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kp <= qp
    if window > 0:
        mask &= qp - kp < window
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vv).to(q.dtype)


def linear_scan_ref(a, b, h0=None):
    """The diagonal recurrence h_t = a_t * h_{t-1} + b_t over (B, S, D),
    from h0 (B, D) or zero, in float32 (a multiply, then an add, both
    rounded, step by step in order, as the CUDA kernel does). Returns
    (B, S, D) in a's dtype."""
    B, S, D = a.shape
    af, bf = a.to(torch.float32), b.to(torch.float32)
    h = (torch.zeros((B, D), dtype=torch.float32, device=a.device)
         if h0 is None else h0.to(torch.float32))
    out = torch.empty((B, S, D), dtype=torch.float32, device=a.device)
    for t in range(S):
        h = af[:, t] * h + bf[:, t]
        out[:, t] = h
    return out.to(a.dtype)
