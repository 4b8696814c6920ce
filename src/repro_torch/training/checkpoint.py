"""Checkpoints with atomic writes (port of
``src/repro/training/checkpoint.py``), interchangeable with the
reference's.

Format: one ``step_<N>.npz`` per save, the flattened tree under the
reference's keys (dict keys and tuple indices joined by ``/``, e.g.
``params/groups/0/attn/wq``, ``opt_state/mu/embed``, ``step``), and a
``latest`` pointer written last by atomic rename, so a crash mid-write
never corrupts the restore path. A checkpoint written by either package
restores in the other. A sharded state
(:class:`~repro_torch.distributed.sharding.Sharded` leaves) is saved
gathered, in the same format as one device's, so a checkpoint written on a
mesh restores on one device and the other way round: ``restore``'s
``shardings`` lays the restored leaves out over a mesh (the reference
reshards onto the current mesh there too).
"""
from __future__ import annotations

import os
import re
import threading

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import Sharded


def _paths(tree, prefix=()):
    """(path, leaf) pairs in the reference's flatten order: dict keys
    sorted, tuples and lists in order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], prefix + (str(k),))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _paths(v, prefix + (str(i),))
    else:
        yield "/".join(prefix), tree


def _rebuild(tree, fn, prefix=()):
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], fn, prefix + (str(k),))
                for k in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(v, fn, prefix + (str(i),))
                          for i, v in enumerate(tree))
    return fn("/".join(prefix), tree)


def _host(v):
    if isinstance(v, Sharded):
        v = v.full("cpu")
    return v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)


def _flatten(tree):
    """path -> numpy array for every leaf (tensors copied to the host, a
    Sharded leaf gathered whole)."""
    return {k: _host(v) for k, v in _paths(tree)}


def save(ckpt_dir: str, step: int, state, *, background: bool = False):
    """Write ``state`` as ``step_<step>.npz`` and point ``latest`` at it.
    The host copy happens on the caller's thread; with ``background`` the
    file is written on a thread, which is returned (join it)."""
    os.makedirs(ckpt_dir, exist_ok=True)
    flat = _flatten(state)

    def _write():
        tmp = os.path.join(ckpt_dir, f".tmp_step_{step}.npz")
        final = os.path.join(ckpt_dir, f"step_{step}.npz")
        with open(tmp, "wb") as f:
            np.savez(f, **flat)
        os.replace(tmp, final)
        ptr = os.path.join(ckpt_dir, ".latest_tmp")
        with open(ptr, "w") as f:
            f.write(str(step))
        os.replace(ptr, os.path.join(ckpt_dir, "latest"))

    if background:
        t = threading.Thread(target=_write, daemon=True)
        t.start()
        return t
    _write()
    return None


def latest_step(ckpt_dir: str):
    """The step ``latest`` points at, else the highest ``step_<N>.npz``,
    else None."""
    try:
        with open(os.path.join(ckpt_dir, "latest")) as f:
            return int(f.read().strip())
    except (FileNotFoundError, ValueError):
        steps = [int(m.group(1)) for fn in os.listdir(ckpt_dir)
                 if (m := re.match(r"step_(\d+)\.npz$", fn))] if \
            os.path.isdir(ckpt_dir) else []
        return max(steps) if steps else None


def restore(ckpt_dir: str, template, *, step: int = None, shardings=None,
            device="cuda"):
    """``(state, step)``: the checkpoint at ``step`` (default: the latest)
    in the structure of ``template`` (a tree whose leaves have ``.shape``,
    e.g. tensors on the ``meta`` device), every leaf a tensor on ``device``
    with the file's dtype; ``(None, None)`` when there is none.
    ``shardings`` (a tree of the template's structure whose leaves are
    :class:`~repro_torch.distributed.sharding.NamedSharding` or None) lays
    each leaf with a sharding out over its mesh instead."""
    dev = resolve_device(device)
    layout = dict(_paths(shardings)) if shardings is not None else {}
    if step is None:
        step = latest_step(ckpt_dir)
    if step is None:
        return None, None
    with np.load(os.path.join(ckpt_dir, f"step_{step}.npz")) as data:
        def leaf(key, t):
            arr = data[key]
            if tuple(arr.shape) != tuple(t.shape):
                raise ValueError(f"shape mismatch for {key}: {arr.shape} vs "
                                 f"{tuple(t.shape)}")
            t = torch.from_numpy(np.array(arr))
            s = layout.get(key)
            return t.to(dev) if s is None else s.put(t)
        state = _rebuild(template, leaf)
    return state, step
