"""The stream reference one precision down, for the control of the stream
cells. The stream states float32; the control keeps every float of the
tick's state (workers, window, backlog) in bfloat16 between ticks, rounds
the operands of every learner product (``ordered_matmul``: the fused
learner's logits and its fit) and the E-step's
log-confusion table to bfloat16, and computes on in float32: what storing
the state or running the products in bfloat16 would give."""
from __future__ import annotations

import contextlib

import torch

from perfbench.reference.stream import aggregate, linear, router
from perfbench.reference.stream.shared import tree_map


def _bf16(x):
    if torch.is_tensor(x) and x.dtype == torch.float32:
        return x.to(torch.bfloat16).to(torch.float32)
    return x


@contextlib.contextmanager
def lower_precision():
    """While open, the reference runs one precision down (see the module
    docstring)."""
    mm, estep, tick = (linear.ordered_matmul, aggregate.ds_estep,
                       router._shard_tick)

    def ordered_matmul(A, B):
        return mm(_bf16(A), _bf16(B))

    def ds_estep(rows, idx):
        return estep(_bf16(rows), idx)

    def shard_tick(*args, **kw):
        ws, win, bl, m, train = tick(*args, **kw)
        return (tree_map(_bf16, ws), tree_map(_bf16, win),
                tree_map(_bf16, bl), m, train)

    saved = [(m, "ordered_matmul", m.ordered_matmul)
             for m in (linear, router)]
    try:
        for m, name, _ in saved:
            setattr(m, name, ordered_matmul)
        aggregate.ds_estep = ds_estep
        router._shard_tick = shard_tick
        yield
    finally:
        for m, name, fn in saved:
            setattr(m, name, fn)
        aggregate.ds_estep = estep
        router._shard_tick = tick
