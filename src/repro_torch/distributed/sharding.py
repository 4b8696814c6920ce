"""Sharding (port of ``src/repro/distributed/sharding.py``): the LM
stack's layout over a ``("data", "model")`` mesh, and the shard groups of
the labeling service's state.

The LM rules are the reference's, literally: logical parameter and
activation axes map to mesh axes (``PARAM_RULES``, ``ACT_RULES``),
resolved left to right, a mesh axis claimed once per spec, and a mapping
that does not divide its dimension dropped to replication
(:func:`param_pspecs`, :func:`sanitize`; :func:`make_constrain` keeps an
activation mapping whose padding wastes at most 34%). The layout is
FSDP over ``data`` and TP over ``model`` for the parameters, and the
optimizer state takes the parameters' specs (ZeRO-3). A spec is a
:class:`P`, the counterpart of ``PartitionSpec``.

PyTorch has no GSPMD: :func:`put` lays a tree out over an
:class:`~repro_torch.launch.mesh.LMMesh` as :class:`Sharded` leaves (slot
``(i, j)`` holds its shard of each leaf on ``devices[i][j]``: the bytes
the reference's ``NamedSharding`` would put there) and :func:`gather` is
its inverse. :func:`gather_copies` is the differentiable all-gather the
sharded forward runs before each block: its backward adds the copies'
gradients in target order and hands each slot its shard of the sum (a
reduce-scatter in a fixed order).

A leaf's shard axis is split into the stream mesh's D equal groups, group
``g`` on ``mesh.devices[g]``, and gathered back in group order: the
counterparts of the reference's ``leading_axis_specs`` / ``shard_put`` and
of ``all_gather(tiled=True)``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.launch.mesh import LMMesh, StreamMesh
from repro_torch.models import params as _params

# logical axis -> mesh axis (or None)
PARAM_RULES = {
    "vocab": "model",
    "embed": "data",          # FSDP
    "heads": "model",
    "kv": "model",
    "ffn": "model",
    "experts": None,
    "experts_dim": None,
    "lru": "model",
    "lru_out": "data",
    "gates": "model",
    "conv": None,
    "layers": None,
    "sheads": None,
    "shead_dim": None,
}

ACT_RULES = {
    "batch": ("pod", "data"),
    "seq": None,
    "embed_act": None,
    "vocab_act": "model",
    "experts_act": None,
    "ffn_act": "model",
    "heads_act": "model",     # Megatron-style attention head sharding
    "kv_act": None,           # kv heads replicated across TP
    "head_dim": None,
}


def _norm_entry(m):
    if isinstance(m, (tuple, list)):
        m = tuple(m)
        return None if not m else (m[0] if len(m) == 1 else m)
    return m


class P(tuple):
    """A partition spec: per dimension a mesh axis, a tuple of axes (split
    over their product, major to minor) or None (replicated). Equal by
    value; a one-axis tuple is stored as the axis and an empty one as None,
    as ``jax.sharding.PartitionSpec`` stores them."""

    def __new__(cls, *parts):
        return super().__new__(cls, tuple(_norm_entry(m) for m in parts))

    def __repr__(self):
        return "P(" + ", ".join(repr(m) for m in self) + ")"


def is_spec(x) -> bool:
    return isinstance(x, P)


def _axis_size(mesh, m):
    if isinstance(m, tuple):
        n = 1
        for a in m:
            n *= mesh.shape[a]
        return n
    return mesh.shape[m]


def _resolve(axes, rules, mesh, shape=None):
    """Logical axes -> :class:`P`, left to right: a mesh axis is claimed
    once, later claims and axes the mesh lacks fall back to replication,
    and (with ``shape``) a mapping whose mesh-axis product does not divide
    the dimension is dropped."""
    mesh_axes = set(mesh.axis_names)
    spec, used = [], set()
    for i, ax in enumerate(axes):
        m = rules.get(ax) if not isinstance(ax, (tuple, type(None))) else ax
        if isinstance(ax, tuple):  # already a concrete mesh-axis tuple
            m = ax
        if isinstance(m, tuple):
            m = tuple(a for a in m if a in mesh_axes and a not in used)
            m = m or None
        elif m is not None and (m in used or m not in mesh_axes):
            m = None
        if m is not None and shape is not None:
            if shape[i] % _axis_size(mesh, m) != 0:
                m = None
        if m is not None:
            used.update(m if isinstance(m, tuple) else [m])
        spec.append(m)
    return P(*spec)


def param_pspecs(template, mesh, rules=None):
    """The :class:`P` tree mirroring the parameter template
    (shape-checked)."""
    rules = rules or PARAM_RULES
    return _params.tree_map(lambda p: _resolve(p.axes, rules, mesh, p.shape),
                            template)


def sanitize(pspec_tree, abstract_tree, mesh):
    """Drop mesh axes that do not divide their dimension (or that the mesh
    lacks, or that an earlier dimension claimed) from an existing spec
    tree, each spec checked against the matching abstract leaf's shape."""
    def fix(spec, leaf):
        out, used = [], set()
        spec = tuple(spec) + (None,) * (len(leaf.shape) - len(spec))
        for i, m in enumerate(spec):
            if isinstance(m, tuple):
                m = tuple(a for a in m
                          if a in mesh.shape and a not in used) or None
            elif m is not None and (m not in mesh.shape or m in used):
                m = None
            if m is not None and leaf.shape[i] % _axis_size(mesh, m) != 0:
                m = None
            if m is not None:
                used.update(m if isinstance(m, tuple) else [m])
            out.append(m)
        return P(*out)

    has_shape = lambda x: hasattr(x, "shape")
    specs = _params.leaves(pspec_tree, is_spec)
    abstract = _params.leaves(abstract_tree, has_shape)
    if len(specs) != len(abstract):
        raise ValueError(f"sanitize: {len(specs)} specs for "
                         f"{len(abstract)} leaves")
    it = iter(fix(s, leaf) for s, leaf in zip(specs, abstract))
    return _params.tree_map(lambda _: next(it), abstract_tree, has_shape)


# ------------------------------------------------- placement on a mesh ----


def _slot_coords(i, j):
    return {"data": i, "model": j}


def _region(shape, spec, mesh, i, j):
    """The index of slot (i, j)'s shard in a tensor of ``shape``."""
    coords = _slot_coords(i, j)
    out = []
    for k, n in enumerate(shape):
        m = spec[k] if k < len(spec) else None
        if m is None:
            out.append(slice(None))
            continue
        c = 0
        for a in (m if isinstance(m, tuple) else (m,)):
            c = c * mesh.shape[a] + coords[a]
        size = n // _axis_size(mesh, m)
        out.append(slice(c * size, (c + 1) * size))
    return tuple(out)


def _holders(spec, mesh):
    """The slots, in slot order, that hold distinct shards under ``spec``:
    index 0 on every mesh axis the spec does not name."""
    used = set()
    for m in spec:
        if m is not None:
            used.update(m if isinstance(m, tuple) else (m,))
    return [(i, j) for i, j in mesh.slots()
            if ("data" in used or i == 0) and ("model" in used or j == 0)]


class Sharded:
    """A tensor of ``shape`` laid out over ``mesh`` by ``spec``: slot
    ``(i, j)`` holds ``pieces[i][j]``, its own copy of its shard, on
    ``mesh.devices[i][j]`` (a dimension the spec does not split is whole in
    every slot; a mesh axis the spec does not name holds replicas)."""
    __slots__ = ("mesh", "spec", "shape", "pieces")

    def __init__(self, mesh: LMMesh, spec: P, shape, pieces):
        self.mesh, self.spec, self.shape = mesh, P(*spec), tuple(shape)
        self.pieces = tuple(tuple(row) for row in pieces)

    @property
    def dtype(self):
        return self.pieces[0][0].dtype

    def flat(self) -> list:
        """The pieces in slot order."""
        return [self.pieces[i][j] for i, j in self.mesh.slots()]

    def with_pieces(self, flat) -> "Sharded":
        """The same layout holding ``flat`` (pieces in slot order)."""
        nm = self.mesh.shape["model"]
        rows = [flat[i * nm:(i + 1) * nm]
                for i in range(self.mesh.shape["data"])]
        return Sharded(self.mesh, self.spec, self.shape, rows)

    def holders(self) -> list:
        return _holders(self.spec, self.mesh)

    def full(self, device) -> torch.Tensor:
        """The whole tensor on ``device`` (no gradient)."""
        return _assemble(self.pieces, self.spec, self.shape, self.mesh,
                         torch.device(device), self.dtype)

    def unbind(self, dim: int = 0) -> list:
        """The slices along an unsplit leading dimension (``dim`` 0, as a
        tensor's ``unbind(0)``), as Sharded leaves (the pieces' ``unbind``
        views)."""
        if dim != 0:
            raise ValueError("unbind: only the leading dimension")
        if self.spec and self.spec[0] is not None:
            raise ValueError("unbind: the leading dimension is split")
        parts = [[p.unbind(0) for p in row] for row in self.pieces]
        return [Sharded(self.mesh, self.spec[1:], self.shape[1:],
                        [[p[k] for p in row] for row in parts])
                for k in range(self.shape[0])]

    def __repr__(self):
        return (f"Sharded({self.shape}, {self.dtype}, {self.spec}, "
                f"{self.mesh.shape})")


def _assemble(pieces, spec, shape, mesh, device, dtype):
    out = torch.empty(shape, dtype=dtype, device=device)
    for i, j in _holders(spec, mesh):
        out[_region(shape, spec, mesh, i, j)].copy_(pieces[i][j])
    return out


def shard(x: torch.Tensor, spec: P, mesh: LMMesh) -> Sharded:
    """``x`` laid out over ``mesh`` by ``spec``: every slot gets its own
    contiguous copy of its shard (the size must divide)."""
    spec = P(*spec)
    for k, m in enumerate(spec):
        if m is not None and x.shape[k] % _axis_size(mesh, m):
            raise ValueError(f"shard: dim {k} of size {x.shape[k]} does "
                             f"not split over {m!r} ({mesh.shape})")
    rows = []
    for i in range(mesh.shape["data"]):
        row = []
        for j in range(mesh.shape["model"]):
            part = x.detach()[_region(x.shape, spec, mesh, i, j)]
            row.append(torch.empty(part.shape, dtype=x.dtype,
                                   device=mesh.devices[i][j]).copy_(part))
        rows.append(row)
    return Sharded(mesh, spec, x.shape, rows)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the counterpart of ``jax.sharding.NamedSharding``):
    :meth:`put` lays a tensor out by it."""
    mesh: LMMesh
    spec: P

    def put(self, x) -> Sharded:
        return shard(x, self.spec, self.mesh)


def named(tree_of_pspecs, mesh):
    """The spec tree as a tree of :class:`NamedSharding`."""
    return _params.tree_map(lambda s: NamedSharding(mesh, s), tree_of_pspecs,
                            is_spec)


def put(tree, specs, mesh: LMMesh):
    """``tree``'s tensors laid out over ``mesh`` by the matching specs of
    ``specs`` (a :class:`P` tree of the same structure), as
    :class:`Sharded` leaves."""
    xs = _params.leaves(tree, torch.is_tensor)
    ss = _params.leaves(specs, is_spec)
    if len(xs) != len(ss):
        raise ValueError(f"put: {len(ss)} specs for {len(xs)} leaves")
    return _params.with_leaves(tree, [shard(x, s, mesh)
                                      for x, s in zip(xs, ss)])


def gather(tree, device):
    """The inverse of :func:`put`: every :class:`Sharded` leaf whole on
    ``device``; other leaves are returned as they are."""
    return _params.tree_map(
        lambda x: x.full(device) if isinstance(x, Sharded) else x, tree,
        lambda x: isinstance(x, Sharded))


def is_sharded(tree) -> bool:
    """Whether any leaf of ``tree`` is :class:`Sharded`."""
    return any(isinstance(x, Sharded)
               for x in _params.leaves(tree, torch.is_tensor))


class _GatherCopies(torch.autograd.Function):
    """Copies of a sharded tensor (or of a region of it) on target devices;
    the backward adds the copies' gradients in target order into one
    gradient on the mesh's lead device and gives every slot its shard of
    it (replicas each get their own)."""

    @staticmethod
    def forward(ctx, layout, targets, *pieces):
        mesh, spec, shape = layout
        rows = [pieces[i * mesh.shape["model"]:(i + 1) * mesh.shape["model"]]
                for i in range(mesh.shape["data"])]
        ctx.layout, ctx.targets = layout, targets
        outs = []
        for dev, region in targets:
            full = _assemble(rows, spec, shape, mesh, dev, pieces[0].dtype)
            outs.append(full if region is None else full[region].clone())
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        mesh, spec, shape = ctx.layout
        total = None
        for (dev, region), g in zip(ctx.targets, grads):
            if g is None:
                continue
            if total is None:
                total = torch.zeros(shape, dtype=g.dtype, device=mesh.lead)
            if region is None:
                total += g.to(mesh.lead)
            else:
                total[region] += g.to(mesh.lead)
        out = []
        for i, j in mesh.slots():
            if total is None:
                out.append(None)
                continue
            part = total[_region(shape, spec, mesh, i, j)]
            out.append(torch.empty(part.shape, dtype=part.dtype,
                                   device=mesh.devices[i][j]).copy_(part))
        return (None, None) + tuple(out)


def gather_copies(x: Sharded, targets) -> list:
    """Differentiable all-gather of ``x``: for each ``(device, region)`` of
    ``targets`` (``region`` an index tuple, or None for the whole tensor)
    a copy on that device. Gradients reach the pieces as described in
    :class:`_GatherCopies`."""
    return list(_GatherCopies.apply((x.mesh, x.spec, x.shape),
                                    tuple(targets), *x.flat()))


class Constrain:
    """The activation-sharding hook ``forward`` takes (``make_constrain``):
    :meth:`spec` resolves an activation's spec by the reference's rule (a
    non-divisible mapping kept where the padding wastes at most 34%, e.g.
    40 q-heads over 16 ranks; dropped otherwise, e.g. batch 1 over 16
    ranks). There is no compiler to hand the spec to: calling the hook
    returns ``x``. Bound to a data group (:meth:`bind`, as the sharded
    forward does), it checks that a ``batch`` dimension holds the group's
    rows."""

    def __init__(self, mesh, rules=None, rows=None):
        self.mesh, self.rules, self.rows = mesh, rules or ACT_RULES, rows

    def spec(self, shape, axes) -> P:
        ndim = len(shape)
        axes = tuple(axes[:ndim]) + (None,) * (ndim - len(axes))
        spec0 = _resolve(axes, self.rules, self.mesh, shape=None)
        fixed = []
        for i, m in enumerate(spec0):
            if m is not None:
                n = _axis_size(self.mesh, m)
                d = shape[i]
                pad = (-(-d // n) * n - d) / max(d, 1)
                if d % n != 0 and pad > 0.34:
                    m = None
            fixed.append(m)
        return P(*fixed)

    def bind(self, rows: int) -> "Constrain":
        return Constrain(self.mesh, self.rules, rows)

    def __call__(self, x, axes):
        self.spec(tuple(x.shape), axes)
        if (self.rows is not None and axes and axes[0] == "batch"
                and x.shape[0] != self.rows):
            raise ValueError(f"constrain: the batch dimension holds "
                             f"{x.shape[0]} rows, the data group {self.rows}")
        return x


def make_constrain(mesh, rules=None) -> Constrain:
    """The activation-sharding hook for ``forward`` (see
    :class:`Constrain`)."""
    return Constrain(mesh, rules)


# ------------------------------------------------------ cache / batch ----


def batch_axes(mesh):
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def block_cache_pspec(cfg, kind, mesh, kv_shard="kv_heads"):
    """The spec tree of ``init_block_cache``'s structure. ``kv_shard``:
    ``"kv_heads"`` (cache heads over ``model``) or ``"seq"`` (the KV cache
    split along its sequence)."""
    ba = batch_axes(mesh)
    if kv_shard == "seq":
        kv = lambda: {"k": P(ba, "model", None, None),
                      "v": P(ba, "model", None, None),
                      "pos": P(ba, "model")}
    else:
        kv = lambda: {"k": P(ba, None, "model", None),
                      "v": P(ba, None, "model", None),
                      "pos": P(ba, None)}
    if kind in ("attn", "moe"):
        return kv()
    if kind == "xattn":
        c = kv()
        c["ck"] = P(ba, None, "model", None)
        c["cv"] = P(ba, None, "model", None)
        return c
    if kind == "mlstm":
        return {"C": P(ba, "model", None, None), "n": P(ba, "model", None),
                "m": P(ba, "model")}
    if kind == "slstm":
        return {k: P(ba, "model") for k in ("c", "n", "h", "m")}
    if kind == "rglru":
        return {"h": P(ba, "model"), "conv": P(ba, None, "model")}
    raise ValueError(kind)


def cache_pspecs(cfg, mesh, kv_shard="kv_heads"):
    """The spec tree of ``init_cache``: the groups' specs lead with the
    (unsplit) layer axis."""
    group, n_full, rem = cfg.layer_groups()
    gc = tuple({k: P(None, *s) for k, s in
                block_cache_pspec(cfg, kind, mesh, kv_shard).items()}
               for kind in group)
    tail = tuple(block_cache_pspec(cfg, k, mesh, kv_shard) for k in rem)
    return {"groups": gc, "tail": tail}


def input_pspecs(cfg, shape_kind, mesh):
    ba = batch_axes(mesh)
    d = {"tokens": P(ba, None)}
    if shape_kind == "train":
        d["targets"] = P(ba, None)
    if shape_kind == "decode":
        d["positions"] = P(ba)
    if cfg.is_encoder_decoder or cfg.n_img_tokens:
        if shape_kind != "decode":
            d["cross_src"] = P(ba, None, None)
    return d


# ------------------------------------------------ stream shard groups ----


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
