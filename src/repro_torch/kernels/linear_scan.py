"""Diagonal linear recurrence: the Hopper kernels of ``csrc/linear_scan.cu``
(forward and backward, sequential and chunked) behind a checked,
differentiable wrapper.

Replaces ``src/repro/kernels/linear_scan.py::linear_scan`` (Pallas body
``_scan_kernel``), the RG-LRU state update h_t = a_t * h_{t-1} + b_t.
``linear_scan(a, b, h0)`` takes ``(B, S, D)`` float32 or bfloat16 a and b
and an optional ``(B, D)`` h0, keeps the state in float32 and returns h in
a's dtype. It is a ``torch.autograd.Function``: the backward kernel walks t
in reverse from the saved output h (da, db, and dh0 when h0 needs one).

Two routes compute it, each a forward and a backward kernel with a plain
version in :mod:`repro_torch.kernels.ref` that rounds in the same order:
``sequential`` (one thread per channel walks all of S:
:func:`~repro_torch.kernels.ref.linear_scan_ref`,
:func:`~repro_torch.kernels.ref.linear_scan_bwd_ref`) and ``chunked``
(chunks of ``SCAN_CHUNK`` steps, their carries composed in order:
:func:`~repro_torch.kernels.ref.linear_scan_chunked_ref`,
:func:`~repro_torch.kernels.ref.linear_scan_chunked_bwd_ref`).
:func:`scan_route` picks one from the shape and dtype alone, so a CPU run
and a card run of the same shapes round alike. For CPU tensors both
directions run the route's plain versions; for CUDA tensors they launch
the route's kernels on the current stream or raise.
``linear_scan.launches`` and ``linear_scan.bwd_launches`` count kernel
launches of either route, one per call; ``linear_scan.chunked_launches``
and ``linear_scan.chunked_bwd_launches`` count those of the chunked route.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import (
    SCAN_CHUNK, linear_scan_bwd_ref, linear_scan_chunked_bwd_ref,
    linear_scan_chunked_ref, linear_scan_ref,
)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# up to this many steps (one segment of the chunked kernel: 8 chunks of
# SCAN_CHUNK) the sequential kernel is as fast; past it the chunked one is
# faster on an H100 at every B measured (PERF.md)
SEQUENTIAL_MAX_STEPS = 8 * SCAN_CHUNK
# route -> (forward plain version, backward plain version, forward C
# function, backward C function)
ROUTES = {
    "sequential": (linear_scan_ref, linear_scan_bwd_ref,
                   "linear_scan_fwd_c", "linear_scan_bwd_c"),
    "chunked": (linear_scan_chunked_ref, linear_scan_chunked_bwd_ref,
                "linear_scan_chunked_fwd_c", "linear_scan_chunked_bwd_c"),
}
_fns: dict = {}


def scan_route(B: int, S: int, D: int, dtype) -> str:
    """The route for a (B, S, D) scan of ``dtype``: ``"chunked"`` where S
    is longer than ``SEQUENTIAL_MAX_STEPS`` (one segment of the chunked
    kernel), else ``"sequential"``. On an H100 the chunked kernels are
    4-5x faster at (4, 512, 2560) and (2, 4096, 2560) and no slower at any
    B at S = 512, while at the encoder's (64, 48, 2560) the sequential
    kernel is as fast. A pure function of the shape and dtype (B, D and
    the dtype do not move the rule today): it never looks at a device."""
    if dtype not in _DTYPES:
        raise TypeError(f"linear_scan takes float32 or bfloat16, not {dtype}")
    return "chunked" if S > SEQUENTIAL_MAX_STEPS else "sequential"


def _launcher(name):
    fn = _fns.get(name)
    if fn is None:
        lib = _build.load("linear_scan")
        if "chunked" in name:
            lib.linear_scan_chunk_c.restype = ctypes.c_int
            kl = lib.linear_scan_chunk_c()
            if kl != SCAN_CHUNK:
                raise RuntimeError(f"csrc/linear_scan.cu's chunk is {kl} "
                                   f"steps, ref.SCAN_CHUNK {SCAN_CHUNK}")
        fn = getattr(lib, name)
        ptrs = 4 if "fwd" in name else 7
        fn.argtypes = ([ctypes.c_void_p] * ptrs + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _ptr(t):
    return None if t is None else t.data_ptr()


def _fwd_kernel(a, b, h0f, route="sequential"):
    """Launch the ``route``'s forward kernel on contiguous card tensors
    (h0f float32 or None)."""
    B, S, D = a.shape
    out = torch.empty_like(a)
    if B == 0 or S == 0 or D == 0:
        return out
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = _launcher(ROUTES[route][2])(
            a.data_ptr(), b.data_ptr(), _ptr(h0f), out.data_ptr(), B, S, D,
            _DTYPES[a.dtype], stream)
    if err != 0:
        raise RuntimeError(f"linear_scan {route} kernel launch failed: CUDA "
                           f"error {err} (B={B}, S={S}, D={D}, {a.dtype})")
    linear_scan.launches += 1
    if route == "chunked":
        linear_scan.chunked_launches += 1
    return out


def _bwd_kernel(a, h, h0f, g, want_dh0, route="sequential"):
    """Launch the ``route``'s backward kernel on contiguous card tensors;
    returns (da, db, dh0 or None)."""
    B, S, D = a.shape
    da, db = torch.empty_like(a), torch.empty_like(a)
    dh0 = (torch.empty((B, D), dtype=torch.float32, device=a.device)
           if want_dh0 else None)
    if B == 0 or S == 0 or D == 0:
        return da, db, None if dh0 is None else dh0.zero_()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = _launcher(ROUTES[route][3])(
            a.data_ptr(), h.data_ptr(), _ptr(h0f), g.data_ptr(),
            da.data_ptr(), db.data_ptr(), _ptr(dh0), B, S, D,
            _DTYPES[a.dtype], stream)
    if err != 0:
        raise RuntimeError(f"linear_scan {route} backward launch failed: "
                           f"CUDA error {err} (B={B}, S={S}, D={D}, "
                           f"{a.dtype})")
    linear_scan.bwd_launches += 1
    if route == "chunked":
        linear_scan.chunked_bwd_launches += 1
    return da, db, dh0


class _LinearScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, h0):
        ctx.h0_dtype = None if h0 is None else h0.dtype
        ctx.route = scan_route(*a.shape, a.dtype)
        if a.device.type == "cpu":
            h = ROUTES[ctx.route][0](a, b, h0)
        else:
            h0 = None if h0 is None else h0.to(torch.float32).contiguous()
            h = _fwd_kernel(a, b, h0, ctx.route)
        # both routes' backwards read a, the output h and h0
        ctx.save_for_backward(a, h, h0)
        return h

    @staticmethod
    def backward(ctx, g):
        a, h, h0 = ctx.saved_tensors
        g = g.to(a.dtype).contiguous()
        want_dh0 = ctx.needs_input_grad[2]
        if a.device.type == "cpu":
            da, db, dh0 = ROUTES[ctx.route][1](a, h, g, h0)
        else:
            da, db, dh0 = _bwd_kernel(a, h, h0, g, want_dh0, ctx.route)
        if want_dh0:
            dh0 = dh0.to(ctx.h0_dtype)
        return da, db, dh0 if want_dh0 else None


def linear_scan(a, b, h0=None):
    """h_t = a_t * h_{t-1} + b_t over (B, S, D), from ``h0`` (B, D) or
    zero, differentiable in a, b and h0, on the route :func:`scan_route`
    gives for the shape and dtype. a and b share a dtype (float32 or
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
linear_scan.chunked_launches = 0
linear_scan.chunked_bwd_launches = 0
