"""The device mesh of the sharded labeling service (port of
``src/repro/launch/mesh.py``'s stream part).

PyTorch has no ``shard_map``: the port runs a single controller over an
ordered list of devices, one per shard group, and :class:`StreamMesh`
carries that list and the two collectives the tick needs, each in canonical
group order. Functions, not module constants: importing this module touches
no device.

Left for the LM stack on a mesh (ROADMAP A13b): ``make_local_mesh`` and
``make_production_mesh`` (the reference's 16x16 and 2x16x16 TPU pod meshes;
the TPU pod layout has no counterpart on one host's cards).
"""
from __future__ import annotations

import dataclasses
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
