"""Shard groups of the labeling service's state (port of the stream part
of ``src/repro/distributed/sharding.py``).

A leaf's shard axis is split into the mesh's D equal groups, group ``g`` on
``mesh.devices[g]``, and gathered back in group order: the counterparts of
the reference's ``leading_axis_specs`` / ``shard_put`` and of
``all_gather(tiled=True)``.

Left for the LM stack on a mesh (ROADMAP A13b): the parameter and
activation rules (``PARAM_RULES`` / ``ACT_RULES``, ``param_specs``,
``constrain``) and the cache and batch specs.
"""
from __future__ import annotations

import torch

from repro_torch.launch.mesh import StreamMesh


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of a tree of dicts and named tuples (a state
    and its learners), with the same-shaped trees ``rest`` alongside; dict
    order and tuple types are kept."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v, *(r[i] for r in rest))
                            for i, v in enumerate(tree)))
    return fn(tree, *rest)


def leading_axis_specs(tree, axis: int = 0):
    """Per leaf, the axis :func:`shard_put` splits: ``axis`` for a tensor
    with more than ``axis`` dims, None (replicated) otherwise. The stream's
    state keeps its shards on one dimension: leading for per-shard state,
    axis 1 behind a replication axis."""
    return tree_map(lambda x: axis if torch.is_tensor(x) and x.dim() > axis
                     else None, tree)


def shard_put(tree, mesh: StreamMesh, axis: int = 0):
    """``tree`` as ``mesh.size`` trees, tree ``g`` on ``mesh.devices[g]``:
    each leaf's ``axis`` split into equal consecutive groups (the size must
    divide), replicated leaves copied. One group on the leaves' own device
    moves nothing."""
    specs = leading_axis_specs(tree, axis)
    D = mesh.size

    def part(g):
        def leaf(x, ax):
            if not torch.is_tensor(x):
                return x
            if ax is not None:
                n = x.shape[ax]
                if n % D:
                    raise ValueError(f"shard_put: axis {ax} of size {n} does "
                                     f"not split into {D} groups")
                x = x.narrow(ax, g * (n // D), n // D)
            return x.to(mesh.devices[g])
        return tree_map(leaf, tree, specs)

    return [part(g) for g in range(D)]


def shard_gather(trees, mesh: StreamMesh, axis: int = 0):
    """The inverse of :func:`shard_put`: each leaf of the groups' trees
    concatenated along ``axis`` in group order on ``mesh.devices[0]``
    (a leaf that is not a tensor is taken from the first group)."""
    return tree_map(lambda *xs: mesh.gather(xs, axis)
                     if torch.is_tensor(xs[0]) else xs[0], *trees)


def _rows(tree, lead):
    # (lead * rest, ...) leaves as (lead, rest, ...) and back (lead=None)
    def f(x):
        if not torch.is_tensor(x):
            return x
        if lead is None:
            return x.reshape((-1,) + tuple(x.shape[2:]))
        return x.reshape((lead, -1) + tuple(x.shape[1:]))
    return tree_map(f, tree)


def shard_rows(tree, mesh: StreamMesh, n_reps: int):
    """:func:`shard_put` for the port's row layout, where a leaf's leading
    dim is ``n_reps * n_shards`` rows, replication-major: the shard axis
    behind the replication axis is split, and each group's leaves lead
    with its ``n_reps * n_shards / D`` rows."""
    return [_rows(p, None) for p in shard_put(_rows(tree, n_reps), mesh, 1)]


def gather_rows(trees, mesh: StreamMesh, n_reps: int):
    """The inverse of :func:`shard_rows`: the groups' rows back in
    canonical shard order (``all_gather`` over the shard axis), on
    ``mesh.devices[0]``. One group is returned as it is."""
    if mesh.size == 1:
        return trees[0]
    return _rows(shard_gather([_rows(t, n_reps) for t in trees], mesh, 1),
                 None)
