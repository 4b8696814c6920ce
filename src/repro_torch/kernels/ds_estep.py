"""Fused Dawid-Skene E-step: the Hopper kernel ``csrc/ds_estep.cu`` behind a
checked wrapper.

Replaces ``src/repro/kernels/ds_estep.py::ds_estep`` (Pallas body
``_ds_estep_kernel``). ``ds_estep(rows, idx)`` takes ``(R, C)/(T, V)`` or
batched ``(B, R, C)/(B, T, V)`` tensors and returns ``(logp, post)`` of
shape ``([B,] T, C)``. For CPU tensors it runs the plain version
:func:`repro_torch.kernels.ref.ds_estep_ref`; for CUDA tensors it launches
the kernel on the current stream or raises. ``ds_estep.launches`` counts
kernel launches, so a run can show that its path went through the kernel.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ds_estep_ref

_fn = None


def _launcher():
    global _fn
    if _fn is None:
        lib = _build.load("ds_estep")
        fn = lib.ds_estep_f32
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.ds_estep_smem_budget.restype = ctypes.c_int
        _fn = fn
    return _fn


def smem_budget() -> int:
    """Bytes of row table a block stages in shared memory; larger tables
    are gathered from global memory (L2)."""
    _launcher()
    return int(_build.load("ds_estep").ds_estep_smem_budget())


def _check(rows, idx):
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
    if rows.device != idx.device:
        raise ValueError(f"rows on {rows.device}, idx on {idx.device}")


def ds_estep(rows, idx):
    """Fused DS log-posterior + softmax.

    rows: ([B,] R, C) float32 log-confusion row table, R = n_workers*C + 1
    with a trailing all-zero null row for padded votes. idx: ([B,] T, V)
    int32 per-vote row indices (``w*C + label``; the null row for padded
    votes). Returns ``(logp, post)``, both ([B,] T, C) float32; ``logp``
    includes the uniform ``-log C`` prior. On the card, indices outside
    [0, R) read as the null row (checking them would synchronise).
    """
    _check(rows, idx)
    if rows.device.type == "cpu":
        return ds_estep_ref(rows, idx)
    if rows.device.type != "cuda":
        raise ValueError(f"ds_estep runs on cpu or cuda, not {rows.device}")
    if rows.dtype != torch.float32 or idx.dtype != torch.int32:
        raise TypeError(f"ds_estep needs float32 rows and int32 idx, got "
                        f"{rows.dtype} and {idx.dtype}")
    if not (rows.is_contiguous() and idx.is_contiguous()):
        raise ValueError("ds_estep needs contiguous rows and idx")
    batched = rows.dim() == 3
    B = rows.shape[0] if batched else 1
    R, C = rows.shape[-2:]
    T, V = idx.shape[-2:]
    if max(B * R * C, B * T * V, B * T * C) >= 2 ** 31:
        raise ValueError("ds_estep indexes with 32-bit ints: "
                         f"B={B}, R={R}, C={C}, T={T}, V={V} is too large")
    out_shape = idx.shape[:-1] + (C,)
    logp = torch.empty(out_shape, dtype=torch.float32, device=rows.device)
    post = torch.empty(out_shape, dtype=torch.float32, device=rows.device)
    if T == 0 or B == 0:
        return logp, post
    fn = _launcher()
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream(rows.device).cuda_stream
        err = fn(rows.data_ptr(), idx.data_ptr(), logp.data_ptr(),
                 post.data_ptr(), B, R, C, T, V, math.log(C), stream)
    if err != 0:
        raise RuntimeError(f"ds_estep kernel launch failed: CUDA error {err} "
                           f"(B={B}, R={R}, C={C}, T={T}, V={V})")
    ds_estep.launches += 1
    return logp, post


ds_estep.launches = 0
