"""Device resolution for the port's entry points, and the one switch for
full float32 products on the card."""
from __future__ import annotations

import contextlib

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a :class:`torch.device`. Asking for CUDA without a card
    raises: the port never runs on the CPU in place of the card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but torch reports "
                           "no CUDA device; pass device='cpu' to run the "
                           "plain PyTorch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    return dev


@contextlib.contextmanager
def full_fp32():
    """Matrix products on the card as the reference computes them, restored
    after: float32 products in full float32 (no TF32), and bfloat16
    products accumulated in float32 (no reduced-precision split-K
    reductions)."""
    mm = torch.backends.cuda.matmul
    old = (mm.allow_tf32, mm.allow_bf16_reduced_precision_reduction)
    mm.allow_tf32 = False
    mm.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        mm.allow_tf32, mm.allow_bf16_reduced_precision_reduction = old
