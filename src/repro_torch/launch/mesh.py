"""Device meshes (port of ``src/repro/launch/mesh.py``).

PyTorch has no GSPMD and no ``shard_map``: the port runs a single
controller over an ordered grid of device slots. :class:`StreamMesh` is
the sharded labeling service's list of shard groups, with the two
collectives its tick needs; :class:`LMMesh` is the LM stack's
``("data", "model")`` grid (:func:`make_local_mesh`), with the collectives
its sharded train, prefill and decode steps need. Every collective runs in
slot order and lands on a stated device, so a run repeats bit for bit.
Functions, not module constants: importing this module touches no device.

``make_production_mesh`` (the reference's 16x16 and 2x16x16 TPU pod
meshes) has no counterpart on one host's cards and raises. The dry-run
(:mod:`repro_torch.launch.dryrun`) reads those layouts' shapes only:
:class:`MeshLayout`, :func:`production_layout`, :func:`layout_of`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class StreamMesh:
    """D shard groups, group ``g`` on ``devices[g]`` (a card may repeat).
    Results of the collectives land on ``devices[0]``, where the run's
    replicated state (arrivals, learner, outputs) lives."""
    devices: tuple

    @property
    def size(self) -> int:
        return len(self.devices)

    def gather(self, xs: Sequence[torch.Tensor], dim: int = 0):
        """``all_gather(tiled=True)``: the groups' tensors concatenated
        along ``dim`` in group order, on ``devices[0]``."""
        if len(xs) == 1:
            return xs[0]
        d0 = self.devices[0]
        return torch.cat([x.to(d0) for x in xs], dim)

    def psum(self, xs: Sequence[torch.Tensor]):
        """``psum``: the groups' tensors added in group order, on
        ``devices[0]`` (used for integers, whose sum is exact in any
        order)."""
        out = xs[0].to(self.devices[0])
        for x in xs[1:]:
            out = out + x.to(out.device)
        return out

    def replicate(self, x):
        """``x`` on every group's device (the same tensor where the device
        is the same)."""
        return [x.to(d) for d in self.devices]


@dataclasses.dataclass(frozen=True)
class LMMesh:
    """An ``n_data x n_model`` grid of device slots: slot ``(i, j)`` on
    ``devices[i][j]`` (a card may repeat). ``axis_names`` and ``shape`` are
    the two attributes the sharding rules read, as on a ``jax`` mesh.

    The collectives take the tensors of the slots along a named axis (or
    axes), in slot order, and put the result on ``device``."""
    devices: tuple
    axis_names = ("data", "model")

    @property
    def shape(self) -> dict:
        return {"data": len(self.devices), "model": len(self.devices[0])}

    @property
    def size(self) -> int:
        return len(self.devices) * len(self.devices[0])

    @property
    def lead(self) -> torch.device:
        """Slot (0, 0)'s device, where replicated results land."""
        return self.devices[0][0]

    def slots(self):
        """Every slot ``(i, j)`` in slot order (data-major)."""
        return [(i, j) for i in range(self.shape["data"])
                for j in range(self.shape["model"])]

    def _count(self, axes, xs):
        n = math.prod(self.shape[a] for a in axes)
        if len(xs) != n:
            raise ValueError(f"a collective over {axes} takes {n} tensors, "
                             f"got {len(xs)}")

    def all_gather(self, xs, axis: str, dim: int, device):
        """``all_gather(tiled=True)``: the tensors of the slots along
        ``axis`` concatenated along ``dim``, on ``device``."""
        self._count((axis,), xs)
        return torch.cat([x.to(device) for x in xs], dim)

    def psum(self, xs, axis: str, device):
        """``psum``: the tensors of the slots along ``axis`` added in slot
        order, on ``device``."""
        self._count((axis,), xs)
        return _sum_in_order(xs, device)

    def pmean(self, xs, axes, device):
        """``pmean`` over ``axes`` (a name or a tuple of names): the slots'
        tensors added in slot order, then divided by their number."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        self._count(axes, xs)
        return _sum_in_order(xs, device) / len(xs)


def _sum_in_order(xs, device):
    out = xs[0].to(device)
    for x in xs[1:]:
        out = out + x.to(device)
    return out


@dataclasses.dataclass(frozen=True)
class MeshLayout:
    """A mesh's shape and nothing else: ``axis_names`` and their sizes
    ``dims``, no devices. ``axis_names``, ``shape`` and ``size`` are all
    the sharding rules read (``_resolve``, ``sanitize``,
    ``Constrain.spec``, ``batch_axes``, ``cache_pspecs``,
    ``input_pspecs``), so a layout stands for a mesh of more chips than
    one host holds."""
    axis_names: tuple
    dims: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.dims))

    @property
    def size(self) -> int:
        return math.prod(self.dims)


def production_layout(*, multi_pod: bool = False) -> MeshLayout:
    """The reference's production meshes as layouts: ``("data", "model")``
    16 x 16 (256 chips), or ``("pod", "data", "model")`` 2 x 16 x 16."""
    if multi_pod:
        return MeshLayout(("pod", "data", "model"), (2, 16, 16))
    return MeshLayout(("data", "model"), (16, 16))


def layout_of(mesh_shape: str) -> MeshLayout:
    """A layout from the dry-run's ``--mesh-shape`` (``"128x2"``: two
    dimensions are ``("data", "model")``, three ``("pod", "data",
    "model")``), named as the reference names it."""
    dims = tuple(int(x) for x in mesh_shape.split("x"))
    names = (("data", "model") if len(dims) == 2
             else ("pod", "data", "model"))
    if len(dims) != len(names):
        raise ValueError(f"--mesh-shape {mesh_shape!r}: give 2 or 3 sizes")
    return MeshLayout(names, dims)


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's 16x16 (256-chip) and 2x16x16 (512-chip) TPU pod
    meshes have no counterpart on one host's cards: raises
    (:func:`production_layout` is their shape for the dry-run)."""
    raise NotImplementedError(
        "make_production_mesh: the reference's 16x16 and 2x16x16 meshes are "
        "TPU pod layouts (256 / 512 chips joined by ICI); the port runs on "
        "one host's cards: use make_local_mesh, or production_layout() for "
        "the dry-run's shape-only layout")


def make_local_mesh(n_data: int = 1, n_model: int = 1, device="cuda",
                    devices=None) -> LMMesh:
    """The ``("data", "model")`` mesh of ``n_data x n_model`` slots.

    ``devices`` (``n_data * n_model`` devices in slot order, data-major; a
    card may repeat) wins over ``device``. Otherwise a CUDA ``device``
    takes the cards ``cuda:0 ..`` (one slot: ``device`` itself) and raises
    when fewer are visible; ``device="cpu"`` puts every slot on the CPU
    (the reference forces host devices with ``XLA_FLAGS`` for that).
    Nothing falls back to fewer slots."""
    if n_data < 1 or n_model < 1:
        raise ValueError(f"make_local_mesh: n_data and n_model must be >= "
                         f"1, got {n_data}, {n_model}")
    n = n_data * n_model
    if devices is not None:
        devs = [resolve_device(d) for d in devices]
        if len(devs) != n:
            raise ValueError(f"make_local_mesh: devices= lists {len(devs)} "
                             f"device(s) for {n_data} x {n_model} slots")
    else:
        dev = resolve_device(device)
        if n == 1 or dev.type == "cpu":
            devs = [dev] * n
        else:
            _require_devices("make_local_mesh", n)
            devs = [torch.device("cuda", i) for i in range(n)]
    return LMMesh(tuple(tuple(devs[i * n_model:(i + 1) * n_model])
                        for i in range(n_data)))


def _require_devices(fn: str, n: int):
    avail = torch.cuda.device_count()
    if n > avail:
        raise ValueError(
            f"{fn}: needs {n} devices but only {avail} CUDA device(s) are "
            f"visible; pass devices= (e.g. ['cuda:0'] * {n} to run the "
            "groups on one card) or device='cpu'")


def check_stream_sharding(n_shards: int, n_devices: int):
    """Validate the shard-group layout of the device-sharded stream tick."""
    if n_devices < 1:
        raise ValueError(
            f"ShardingSpec.n_devices: must be >= 1, got {n_devices}")
    if n_shards % n_devices != 0:
        raise ValueError(
            f"ShardingSpec.n_devices={n_devices} does not divide "
            f"PoolSpec.n_shards={n_shards}: each device must hold an equal "
            "number of pool shards (pick n_shards a multiple of n_devices)")


def make_stream_mesh(n_devices: int, device="cuda", devices=None
                     ) -> StreamMesh:
    """The mesh of ``n_devices`` shard groups.

    ``devices`` (a list of ``n_devices`` devices; a card may repeat) wins
    over ``device``. Otherwise a CUDA ``device`` takes the first
    ``n_devices`` cards ``cuda:0 ..`` (one group: ``device`` itself) and
    raises when fewer are visible; ``device="cpu"`` puts every group on
    the CPU (the reference forces host devices with ``XLA_FLAGS`` for
    that). Nothing falls back to fewer groups."""
    if n_devices < 1:
        raise ValueError(f"make_stream_mesh: n_devices must be >= 1, got "
                         f"{n_devices}")
    if devices is not None:
        devs = tuple(resolve_device(d) for d in devices)
        if len(devs) != n_devices:
            raise ValueError(
                f"make_stream_mesh: devices= lists {len(devs)} device(s) "
                f"for {n_devices} shard group(s)")
        return StreamMesh(devs)
    dev = resolve_device(device)
    if n_devices == 1:
        return StreamMesh((dev,))
    if dev.type == "cpu":
        return StreamMesh((dev,) * n_devices)
    _require_devices("make_stream_mesh", n_devices)
    return StreamMesh(tuple(torch.device("cuda", i)
                            for i in range(n_devices)))
