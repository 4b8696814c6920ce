"""Diagonal linear recurrence: the Hopper kernels of ``csrc/linear_scan.cu``
(forward and backward) behind a checked, differentiable wrapper.

Replaces ``src/repro/kernels/linear_scan.py::linear_scan`` (Pallas body
``_scan_kernel``), the RG-LRU state update h_t = a_t * h_{t-1} + b_t.
``linear_scan(a, b, h0)`` takes ``(B, S, D)`` float32 or bfloat16 a and b
and an optional ``(B, D)`` h0, keeps the state in float32 and returns h in
a's dtype. It is a ``torch.autograd.Function``: the backward kernel walks t
in reverse from the saved output h (da, db, and dh0 when h0 needs one).
For CPU tensors both directions run the plain versions
:func:`repro_torch.kernels.ref.linear_scan_ref` and
:func:`~repro_torch.kernels.ref.linear_scan_bwd_ref`; for CUDA tensors they
launch the kernels on the current stream or raise.
``linear_scan.launches`` and ``linear_scan.bwd_launches`` count kernel
launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import linear_scan_bwd_ref, linear_scan_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_fns: dict = {}


def _launcher(name):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(_build.load("linear_scan"), name)
        ptrs = 4 if name == "linear_scan_fwd_c" else 7
        fn.argtypes = ([ctypes.c_void_p] * ptrs + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _ptr(t):
    return None if t is None else t.data_ptr()


def _fwd_kernel(a, b, h0f):
    B, S, D = a.shape
    out = torch.empty_like(a)
    if B == 0 or S == 0 or D == 0:
        return out
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = _launcher("linear_scan_fwd_c")(
            a.data_ptr(), b.data_ptr(), _ptr(h0f), out.data_ptr(), B, S, D,
            _DTYPES[a.dtype], stream)
    if err != 0:
        raise RuntimeError(f"linear_scan kernel launch failed: CUDA error "
                           f"{err} (B={B}, S={S}, D={D}, {a.dtype})")
    linear_scan.launches += 1
    return out


def _bwd_kernel(a, h, h0f, g, want_dh0):
    B, S, D = a.shape
    da, db = torch.empty_like(a), torch.empty_like(a)
    dh0 = (torch.empty((B, D), dtype=torch.float32, device=a.device)
           if want_dh0 else None)
    if B == 0 or S == 0 or D == 0:
        return da, db, None if dh0 is None else dh0.zero_()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = _launcher("linear_scan_bwd_c")(
            a.data_ptr(), h.data_ptr(), _ptr(h0f), g.data_ptr(),
            da.data_ptr(), db.data_ptr(), _ptr(dh0), B, S, D,
            _DTYPES[a.dtype], stream)
    if err != 0:
        raise RuntimeError(f"linear_scan backward launch failed: CUDA error "
                           f"{err} (B={B}, S={S}, D={D}, {a.dtype})")
    linear_scan.bwd_launches += 1
    return da, db, dh0


class _LinearScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, h0):
        ctx.h0_dtype = None if h0 is None else h0.dtype
        if a.device.type == "cpu":
            h = linear_scan_ref(a, b, h0)
        else:
            h0 = None if h0 is None else h0.to(torch.float32).contiguous()
            h = _fwd_kernel(a, b, h0)
        ctx.save_for_backward(a, h, h0)
        return h

    @staticmethod
    def backward(ctx, g):
        a, h, h0 = ctx.saved_tensors
        g = g.to(a.dtype).contiguous()
        want_dh0 = ctx.needs_input_grad[2]
        if a.device.type == "cpu":
            da, db, dh0 = linear_scan_bwd_ref(a, h, g, h0)
        else:
            da, db, dh0 = _bwd_kernel(a, h, h0, g, want_dh0)
        if want_dh0:
            dh0 = dh0.to(ctx.h0_dtype)
        return da, db, dh0 if want_dh0 else None


def linear_scan(a, b, h0=None):
    """h_t = a_t * h_{t-1} + b_t over (B, S, D), from ``h0`` (B, D) or
    zero, differentiable in a, b and h0. a and b share a dtype (float32 or
    bfloat16); on the card they must be contiguous."""
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
    if a.device.type != "cpu":
        if a.device.type != "cuda":
            raise ValueError(f"linear_scan runs on cpu or cuda, not "
                             f"{a.device}")
        if not (a.is_contiguous() and b.is_contiguous()):
            raise ValueError("linear_scan needs contiguous a and b on the "
                             "card")
        if B >= 65536 or B * S * D >= 2 ** 62:
            raise ValueError(f"linear_scan: B={B} too large (< 65536)")
    return _LinearScan.apply(a, b, h0)


linear_scan.launches = 0
linear_scan.bwd_launches = 0
