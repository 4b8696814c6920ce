"""Gradient compression (port of ``src/repro/distributed/compression.py``):
symmetric per-tensor int8 quantize/dequantize, with error feedback.

Applied as the train step's ``grad_transform`` hook it models a compressed
gradient exchange: the dequantized values are what the optimizer sees.
It runs on one device's gradient tree (a mesh's train step takes none).
"""
from __future__ import annotations

import torch

from repro_torch.models.params import leaves, tree_map, with_leaves


def quantize_int8(g):
    """(q int8, scale float32): q = clip(round(g / scale), -127, 127) with
    scale = max(max |g|, 1e-12) / 127 (round half to even, as jnp.round)."""
    scale = torch.clamp(torch.max(torch.abs(g)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q, scale):
    return q.to(torch.float32) * scale


def compress_tree(grads):
    """Pure QDQ of every leaf: int8 + a float32 scale per tensor on the
    wire, returned dequantized in each leaf's dtype."""
    def qdq(g):
        q, s = quantize_int8(g.to(torch.float32))
        return dequantize_int8(q, s).to(g.dtype)
    return tree_map(qdq, grads, is_leaf=torch.is_tensor)


def make_error_feedback():
    """(init, transform): ``transform(grads, residual)`` ->
    ``(compressed_grads, new_residual)``, the residual g - deq(q(g)) added
    back into the next step's gradient."""

    def init(params):
        return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device),
                        params, is_leaf=torch.is_tensor)

    def transform(grads, residual):
        def one(g, r):
            gf = g.to(torch.float32) + r
            q, s = quantize_int8(gf)
            deq = dequantize_int8(q, s)
            return deq.to(g.dtype), gf - deq
        pairs = [one(g, r) for g, r in zip(leaves(grads, torch.is_tensor),
                                           leaves(residual, torch.is_tensor))]
        return (with_leaves(grads, [p[0] for p in pairs]),
                with_leaves(grads, [p[1] for p in pairs]))

    return init, transform

