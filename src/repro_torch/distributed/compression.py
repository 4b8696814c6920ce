"""Gradient compression (port of ``src/repro/distributed/compression.py``):
symmetric per-tensor int8 quantize/dequantize, with error feedback.

Applied as the train step's ``grad_transform`` hook it models a compressed
gradient exchange: the dequantized values are what the optimizer sees.
:func:`compress_tree` takes a one-device gradient tree or a mesh's, whose
leaves are :class:`~repro_torch.distributed.sharding.Sharded`; error
feedback (:func:`make_error_feedback`) runs on one device only.
"""
from __future__ import annotations

import torch

from repro_torch.distributed.sharding import Sharded
from repro_torch.models.params import leaves, tree_map, with_leaves


def int8_scale(amax):
    """The int8 scale of a tensor whose largest |g| is ``amax``:
    max(amax, 1e-12) / 127."""
    return torch.clamp(amax, min=1e-12) / 127.0


def quantize_int8(g, scale=None):
    """(q int8, scale float32): q = clip(round(g / scale), -127, 127) with
    scale = :func:`int8_scale` of max |g| unless given (round half to even,
    as jnp.round)."""
    if scale is None:
        scale = int8_scale(torch.max(torch.abs(g)))
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q, scale):
    return q.to(torch.float32) * scale


def _qdq(g, scale=None):
    q, s = quantize_int8(g.to(torch.float32), scale)
    return dequantize_int8(q, s).to(g.dtype)


def _sharded_qdq(g: Sharded) -> Sharded:
    """A mesh leaf's QDQ with the whole tensor's scale: max |g| over the
    distinct shards (max is exact in any order), taken on the mesh's lead
    device, then every slot's piece QDQ'd on its own device. Gathered, it
    is the whole tensor's QDQ bit for bit."""
    lead = g.mesh.lead
    amax = None
    for i, j in g.holders():
        m = torch.max(torch.abs(g.pieces[i][j].to(torch.float32))).to(lead)
        amax = m if amax is None else torch.maximum(amax, m)
    scale = int8_scale(amax)
    return g.with_pieces([_qdq(t, scale.to(t.device)) for t in g.flat()])


def compress_tree(grads):
    """Pure QDQ of every leaf: int8 + a float32 scale per tensor on the
    wire, returned dequantized in each leaf's dtype. A Sharded leaf keeps
    its layout and takes its whole tensor's scale (:func:`_sharded_qdq`)."""
    return tree_map(lambda g: _sharded_qdq(g) if isinstance(g, Sharded)
                    else _qdq(g), grads, is_leaf=torch.is_tensor)


def make_error_feedback():
    """(init, transform): ``transform(grads, residual)`` ->
    ``(compressed_grads, new_residual)``, the residual g - deq(q(g)) added
    back into the next step's gradient. One device's gradient tree only:
    the reference's trainer does not use it (its residual tree fails on
    the model's ``tail``), so nothing needs it on a mesh."""

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

