"""Fused Dawid-Skene E-step: the Hopper kernels of ``csrc/ds_estep.cu``
behind a checked wrapper.

Replaces ``src/repro/kernels/ds_estep.py::ds_estep`` (Pallas body
``_ds_estep_kernel``). ``ds_estep(rows, idx)`` takes ``(R, C)/(T, V)`` or
batched ``(B, R, C)/(B, T, V)`` tensors and returns ``(logp, post)`` of
shape ``([B,] T, C)``. For CPU tensors it runs the plain version
:func:`repro_torch.kernels.ref.ds_estep_ref`; for CUDA tensors it launches
the kernel of the route :func:`estep_route` gives for the shape, on the
current stream, or raises. ``ds_estep.launches`` counts kernel launches of
any route, one per call, so a run can show that its path went through the
kernel; ``ds_estep.task_launches`` counts those of the ``task`` route.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ds_estep_ref

# the task kernels take C <= TASK_MAX_C classes and V <= TASK_MAX_V votes
TASK_MAX_C = 8
TASK_MAX_V = 32
# route -> code of ds_estep_f32
ROUTES = {"task": 0, "group": 1, "wide": 2}
# the task route's placements, as csrc/ds_estep.cu::ds_estep_task_plan
# reports them: one warp per batch element; the table in a block's shared
# memory; its first rows there and the rest in L2
TASK_MODES = ("warp", "smem", "l2")
_fn = None


def estep_route(B: int, R: int, C: int, T: int, V: int) -> str:
    """The route for an E-step of B batch elements, R table rows, C
    classes, T tasks and V votes: ``"task"`` (one task per thread, the
    table resident) where C <= 8 and V <= 32, ``"group"`` (a group of
    lanes per task) for other C <= 32, ``"wide"`` (a block per task) above.
    A pure function of the shape: it never looks at a device."""
    if C <= TASK_MAX_C and V <= TASK_MAX_V:
        return "task"
    return "group" if C <= 32 else "wide"


def _launcher():
    global _fn
    if _fn is None:
        lib = _build.load("ds_estep")
        fn = lib.ds_estep_f32
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.ds_estep_smem_budget.restype = ctypes.c_int
        lib.ds_estep_task_plan.argtypes = [ctypes.c_int] * 5 + [
            ctypes.POINTER(ctypes.c_int)]
        lib.ds_estep_task_plan.restype = ctypes.c_int
        _fn = fn
    return _fn


def smem_budget() -> int:
    """Bytes of row table a block stages in shared memory; the group and
    wide kernels gather larger tables from global memory (L2)."""
    _launcher()
    return int(_build.load("ds_estep").ds_estep_smem_budget())


def task_plan(B, R, C, T, V):
    """Where the task route puts a shape: ``(mode, split, stages, smem)``
    with ``mode`` one of ``TASK_MODES``, the rows staged in shared memory,
    the idx ring's stages and a block's shared memory in bytes; None where
    the route cannot take the shape. Builds the kernel library."""
    _launcher()
    out = (ctypes.c_int * 4)()
    if _build.load("ds_estep").ds_estep_task_plan(B, R, C, T, V, out):
        return None
    return TASK_MODES[out[0]], out[1], out[2], out[3]


def _check(rows, idx):
    """Raise on shapes or devices the E-step does not take; returns the
    tensors' device."""
    if rows.dim() not in (2, 3) or idx.dim() != rows.dim():
        raise ValueError("ds_estep takes rows (R, C) with idx (T, V), or "
                         "rows (B, R, C) with idx (B, T, V); got "
                         f"{tuple(rows.shape)} and {tuple(idx.shape)}")
    if rows.dim() == 3 and rows.shape[0] != idx.shape[0]:
        raise ValueError(f"batch sizes differ: rows {tuple(rows.shape)}, "
                         f"idx {tuple(idx.shape)}")
    if rows.shape[-2] < 1 or rows.shape[-1] < 1:
        raise ValueError(f"rows must have R >= 1 and C >= 1, got "
                         f"{tuple(rows.shape)}")
    dev = rows.device
    if idx.device != dev:
        raise ValueError(f"rows on {dev}, idx on {idx.device}")
    return dev


def ds_estep(rows, idx, *, _route=None):
    """Fused DS log-posterior + softmax.

    rows: ([B,] R, C) float32 log-confusion row table, R = n_workers*C + 1
    with a trailing all-zero null row for padded votes. idx: ([B,] T, V)
    int32 per-vote row indices (``w*C + label``; the null row for padded
    votes). Returns ``(logp, post)``, both ([B,] T, C) float32; ``logp``
    includes the uniform ``-log C`` prior. On the card, indices outside
    [0, R) read as the null row (checking them would synchronise), and the
    kernel is the one of :func:`estep_route`'s route; ``_route`` (a key of
    ``ROUTES``) forces another, for comparisons on the card. CPU tensors
    take the plain version whatever ``_route`` says.
    """
    dev = _check(rows, idx)
    if dev.type == "cpu":
        return ds_estep_ref(rows, idx)
    if dev.type != "cuda":
        raise ValueError(f"ds_estep runs on cpu or cuda, not {dev}")
    if rows.dtype != torch.float32 or idx.dtype != torch.int32:
        raise TypeError(f"ds_estep needs float32 rows and int32 idx, got "
                        f"{rows.dtype} and {idx.dtype}")
    if not (rows.is_contiguous() and idx.is_contiguous()):
        raise ValueError("ds_estep needs contiguous rows and idx")
    B = rows.shape[0] if rows.dim() == 3 else 1
    R, C = rows.shape[-2:]
    T, V = idx.shape[-2:]
    if max(B * R * C, B * T * V, B * T * C) >= 2 ** 31:
        raise ValueError("ds_estep indexes with 32-bit ints: "
                         f"B={B}, R={R}, C={C}, T={T}, V={V} is too large")
    route = estep_route(B, R, C, T, V) if _route is None else _route
    if route not in ROUTES:
        raise ValueError(f"unknown ds_estep route {route!r}")
    out_shape = idx.shape[:-1] + (C,)
    logp = torch.empty(out_shape, dtype=torch.float32, device=dev)
    post = torch.empty(out_shape, dtype=torch.float32, device=dev)
    if T == 0 or B == 0:
        return logp, post
    fn = _launcher()
    args = (rows.data_ptr(), idx.data_ptr(), logp.data_ptr(),
            post.data_ptr(), B, R, C, T, V, math.log(C), ROUTES[route])
    err = _build.launch(fn, dev, *args)
    if err != 0:
        raise RuntimeError(f"ds_estep {route} kernel launch failed: CUDA "
                           f"error {err} (B={B}, R={R}, C={C}, T={T}, "
                           f"V={V})")
    ds_estep.launches += 1
    if route == "task":
        ds_estep.task_launches += 1
    return logp, post


ds_estep.launches = 0
ds_estep.task_launches = 0
