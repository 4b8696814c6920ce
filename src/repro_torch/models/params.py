"""Parameter templates (port of ``src/repro/models/params.py``).

A model is described as a tree of ``PSpec`` leaves in nested dicts and
tuples. :func:`init_params` maps the template to tensors drawn from a
``torch.Generator``, from the reference's distributions (its numbers come
from ``jax.random`` and differ); :func:`params_from_numpy` carries the
reference's own parameter tree across, as numpy arrays, so that both
packages compute the same function in the tests; :func:`logical_axes`
maps the template to the logical-axis tuples that
:mod:`repro_torch.distributed.sharding` lays out over a mesh, and
:func:`abstract_params` to ``meta`` tensors (shapes and dtypes, nothing
allocated). Leaves are visited in the reference's flatten order: dict
keys sorted, tuples in order.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.device import resolve_device


class PSpec(NamedTuple):
    shape: tuple
    axes: tuple           # logical axis names, len(axes) == len(shape)
    init: str = "fan_in"  # fan_in | embed | zeros | ones | lru_lambda | conv

    def stacked(self, n: int) -> "PSpec":
        """Add a leading ``layers`` axis (the stacked-group layout)."""
        return PSpec((n,) + self.shape, ("layers",) + self.axes, self.init)


def is_pspec(x) -> bool:
    return isinstance(x, PSpec)


def tree_map(fn, tree, is_leaf=lambda x: isinstance(x, PSpec)):
    """``fn`` applied to every leaf of a tree of dicts and tuples."""
    if is_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], is_leaf) for k in sorted(tree)}
    if isinstance(tree, tuple):
        return tuple(tree_map(fn, v, is_leaf) for v in tree)
    return fn(tree)


def leaves(tree, is_leaf=lambda x: isinstance(x, PSpec)) -> list:
    """The leaves in flatten order (dict keys sorted, tuples in order)."""
    out = []
    tree_map(out.append, tree, is_leaf)
    return out


def with_leaves(tree, values):
    """``tree`` with its tensor leaves replaced, in flatten order, by
    ``values``."""
    it = iter(values)
    return tree_map(lambda _: next(it), tree, is_leaf=torch.is_tensor)


def tree_stack_template(template, n: int):
    return tree_map(lambda p: p.stacked(n), template)


def logical_axes(template):
    """The template with each leaf replaced by its logical-axis tuple."""
    return tree_map(lambda p: p.axes, template)


def abstract_params(template, dtype=torch.float32):
    """The template as ``meta`` tensors of ``dtype``: the shapes and dtypes
    of the parameters, nothing drawn or allocated (the reference's
    ``ShapeDtypeStruct`` tree)."""
    return tree_map(lambda p: torch.empty(p.shape, dtype=dtype,
                                          device="meta"), template)


def count_params(template) -> int:
    return int(sum(math.prod(p.shape) for p in leaves(template)))


def _init_leaf(p: PSpec, gen: torch.Generator):
    """One leaf, drawn on the generator's device."""
    f32 = dict(dtype=torch.float32, device=gen.device)
    if p.init == "zeros":
        return torch.zeros(p.shape, **f32)
    if p.init == "ones":
        return torch.ones(p.shape, **f32)
    if p.init == "lru_lambda":
        # RG-LRU Lambda: the decay a = exp(-c softplus(lam)) lies in
        # [0.9, 0.999] at init: lam = softplus^-1(-log(u) / (2 c)) with
        # u ~ U[0.9^2, 0.999^2) and c = 8
        lo, hi = 0.9 ** 2, 0.999 ** 2
        u = torch.rand(p.shape, generator=gen, **f32)
        u = u * (hi - lo) + lo
        return torch.log(torch.expm1(-torch.log(u) / (2 * 8.0)))
    z = torch.randn(p.shape, generator=gen, **f32)
    if p.init == "embed":
        return z * 0.02
    # fan_in (conv too): normal scaled by 1/sqrt(fan_in)
    fan_in = p.shape[-2] if len(p.shape) >= 2 else p.shape[-1]
    return z * float(1.0 / np.sqrt(max(fan_in, 1)))


def init_params(template, generator: torch.Generator, device="cuda"):
    """float32 tensors for every leaf of ``template``, drawn in flatten
    order from ``generator`` (a CPU generator, so that a seed gives the
    same parameters on every device) and moved to ``device`` (the card
    unless told otherwise; raises without one) leaf by leaf."""
    if generator.device.type != "cpu":
        raise ValueError("init_params draws from a CPU generator so that "
                         "parameters do not depend on the device")
    dev = resolve_device(device)
    return tree_map(lambda p: _init_leaf(p, generator).to(dev), template)


def params_from_numpy(tree, device="cuda"):
    """The reference's parameter tree (``jax.tree_util.tree_map(np.asarray,
    params)``: dicts, tuples, numpy arrays) as the port's parameters: the
    ``groups`` stacked on their leading ``n_full`` axis, ``tail`` a tuple
    of block dicts, every array a tensor on ``device`` (the card unless
    told otherwise; raises without one) with its dtype."""
    dev = resolve_device(device)
    def leaf(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":       # ml_dtypes' bfloat16
            t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(a))          # a writable copy
        return t.to(dev)
    return tree_map(leaf, tree, is_leaf=lambda x: not isinstance(
        x, (dict, tuple)))
