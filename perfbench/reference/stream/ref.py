"""The plain Dawid-Skene E-step that the stream reference's EM calls."""
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
