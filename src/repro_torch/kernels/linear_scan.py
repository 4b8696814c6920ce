"""Diagonal linear recurrence: the Hopper kernel ``csrc/linear_scan.cu``
behind a checked wrapper.

Replaces ``src/repro/kernels/linear_scan.py::linear_scan`` (Pallas body
``_scan_kernel``), the RG-LRU state update h_t = a_t * h_{t-1} + b_t.
``linear_scan(a, b, h0)`` takes ``(B, S, D)`` float32 or bfloat16 a and b
and an optional ``(B, D)`` h0, keeps the state in float32 and returns h in
a's dtype. For CPU tensors it runs the plain version
:func:`repro_torch.kernels.ref.linear_scan_ref`; for CUDA tensors it
launches the kernel on the current stream or raises.
``linear_scan.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import linear_scan_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_fn = None


def _launcher():
    global _fn
    if _fn is None:
        fn = _build.load("linear_scan").linear_scan_fwd_c
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def linear_scan(a, b, h0=None):
    """h_t = a_t * h_{t-1} + b_t over (B, S, D), from ``h0`` (B, D) or
    zero. a and b share a dtype (float32 or bfloat16); on the card they
    must be contiguous."""
    if a.dim() != 3 or tuple(b.shape) != tuple(a.shape):
        raise ValueError(f"linear_scan takes a, b of one (B, S, D) shape, "
                         f"got {tuple(a.shape)} and {tuple(b.shape)}")
    B, S, D = a.shape
    if h0 is not None and tuple(h0.shape) != (B, D):
        raise ValueError(f"h0 must be (B, D) = {(B, D)}, got "
                         f"{tuple(h0.shape)}")
    if a.dtype != b.dtype or a.dtype not in _DTYPES:
        raise TypeError(f"linear_scan needs float32 or bfloat16 a and b of "
                        f"one dtype, got {a.dtype} and {b.dtype}")
    devs = {a.device, b.device} | ({h0.device} if h0 is not None else set())
    if len(devs) != 1:
        raise ValueError(f"a, b, h0 on different devices: {devs}")
    if a.device.type == "cpu":
        return linear_scan_ref(a, b, h0)
    if a.device.type != "cuda":
        raise ValueError(f"linear_scan runs on cpu or cuda, not {a.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("linear_scan needs contiguous a and b on the card")
    if B >= 65536 or B * S * D >= 2 ** 62:
        raise ValueError(f"linear_scan: B={B} too large (< 65536)")
    out = torch.empty_like(a)
    if B == 0 or S == 0 or D == 0:
        return out
    h0f = None if h0 is None else h0.to(torch.float32).contiguous()
    fn = _launcher()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(a.data_ptr(), b.data_ptr(),
                 None if h0f is None else h0f.data_ptr(), out.data_ptr(),
                 B, S, D, _DTYPES[a.dtype], stream)
    if err != 0:
        raise RuntimeError(f"linear_scan kernel launch failed: CUDA error "
                           f"{err} (B={B}, S={S}, D={D}, {a.dtype})")
    linear_scan.launches += 1
    return out


linear_scan.launches = 0
