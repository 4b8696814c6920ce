"""Shared feature-space transforms for the learning stack (port of
``src/repro/learning/features.py``)."""
from __future__ import annotations

import torch


def standardize(X, eps: float = 1e-6):
    """Per-feature zero-mean / unit-std standardization in float32 (the
    population std, floored at ``eps`` so constant features map to 0)."""
    X = torch.as_tensor(X).to(torch.float32)
    mu = X.mean(dim=0, keepdim=True)
    sd = X.std(dim=0, correction=0, keepdim=True)
    return (X - mu) / torch.clamp(sd, min=eps)
