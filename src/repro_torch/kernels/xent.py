"""Streaming-vocab cross entropy: the Hopper kernels ``csrc/xent.cu``
(forward and backward) behind a checked, differentiable wrapper.

Replaces ``src/repro/kernels/xent.py::streaming_xent`` (Pallas body
``_xent_kernel``): per-row loss LSE(logits) - logits[target], streaming over
the vocabulary without materializing probabilities. ``streaming_xent(logits,
targets)`` takes ``(N, V)`` float32 or bfloat16 logits and ``(N,)`` integer
targets in [0, V) and returns the ``(N,)`` float32 loss; it is a
``torch.autograd.Function`` whose backward is the second kernel, dlogits =
g (softmax(logits) - onehot(target)) in the logits' dtype, from the row
log-sum-exp that the forward saves. For CPU tensors both directions run the
plain versions :func:`repro_torch.kernels.ref.xent_ref` and
:func:`~repro_torch.kernels.ref.xent_bwd_ref`; for CUDA tensors they launch
the kernels on the current stream or raise. ``streaming_xent.launches``
and ``streaming_xent.bwd_launches`` count kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import xent_bwd_ref, xent_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_fns: dict = {}


def _launcher(name):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(_build.load("xent"), name)
        ptrs = 4 if name == "xent_fwd_c" else 5
        fn.argtypes = ([ctypes.c_void_p] * ptrs
                       + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def _fwd_kernel(x, t):
    N, V = x.shape
    loss = torch.empty((N,), dtype=torch.float32, device=x.device)
    lse = torch.empty_like(loss)
    if N == 0:
        return loss, lse
    with torch.cuda.device(x.device):
        err = _launcher("xent_fwd_c")(x.data_ptr(), t.data_ptr(),
                                      loss.data_ptr(), lse.data_ptr(), N, V,
                                      _DTYPES[x.dtype], _stream(x))
    if err != 0:
        raise RuntimeError(f"streaming_xent kernel launch failed: CUDA error "
                           f"{err} (N={N}, V={V}, {x.dtype})")
    streaming_xent.launches += 1
    return loss, lse


def _bwd_kernel(x, t, lse, g):
    N, V = x.shape
    dx = torch.empty_like(x, memory_format=torch.contiguous_format)
    if N == 0:
        return dx
    with torch.cuda.device(x.device):
        err = _launcher("xent_bwd_c")(x.data_ptr(), t.data_ptr(),
                                      lse.data_ptr(), g.data_ptr(),
                                      dx.data_ptr(), N, V, _DTYPES[x.dtype],
                                      _stream(x))
    if err != 0:
        raise RuntimeError(f"streaming_xent backward kernel launch failed: "
                           f"CUDA error {err} (N={N}, V={V}, {x.dtype})")
    streaming_xent.bwd_launches += 1
    return dx


class _StreamingXent(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, targets):
        if logits.device.type == "cpu":
            loss = xent_ref(logits, targets)
            lse = torch.logsumexp(logits.to(torch.float32), dim=-1)
        else:
            targets = targets.to(torch.int32).contiguous()
            loss, lse = _fwd_kernel(logits, targets)
        ctx.save_for_backward(logits, targets, lse)
        ctx.mark_non_differentiable(lse)
        return loss

    @staticmethod
    def backward(ctx, g):
        logits, targets, lse = ctx.saved_tensors
        g = g.to(torch.float32).contiguous()
        if logits.device.type == "cpu":
            return xent_bwd_ref(logits, targets, lse, g), None
        return _bwd_kernel(logits, targets, lse, g), None


def streaming_xent(logits, targets):
    """Per-row cross entropy of ``(N, V)`` logits (float32 or bfloat16)
    against ``(N,)`` integer targets in [0, V) -> ``(N,)`` float32,
    differentiable in the logits. On the card the logits must be
    contiguous; a target outside [0, V) gives NaN there (the CPU raises)."""
    if logits.dim() != 2 or targets.dim() != 1 or \
            targets.shape[0] != logits.shape[0]:
        raise ValueError(f"streaming_xent takes (N, V) logits and (N,) "
                         f"targets, got {tuple(logits.shape)} and "
                         f"{tuple(targets.shape)}")
    if logits.dtype not in _DTYPES:
        raise TypeError(f"streaming_xent needs float32 or bfloat16 logits, "
                        f"got {logits.dtype}")
    if targets.dtype.is_floating_point or targets.dtype == torch.bool:
        raise TypeError(f"streaming_xent needs integer targets, got "
                        f"{targets.dtype}")
    if logits.device != targets.device:
        raise ValueError("logits and targets must be on one device")
    if logits.device.type != "cpu":
        if logits.device.type != "cuda":
            raise ValueError(f"streaming_xent runs on cpu or cuda, not "
                             f"{logits.device}")
        if not logits.is_contiguous():
            raise ValueError("streaming_xent needs contiguous logits on the "
                             "card")
        if logits.shape[1] < 1 or logits.shape[1] >= 2 ** 27 or \
                logits.shape[0] >= 2 ** 31:
            raise ValueError(f"streaming_xent: (N, V) = "
                             f"{tuple(logits.shape)} out of range")
    return _StreamingXent.apply(logits, targets)


streaming_xent.launches = 0
streaming_xent.bwd_launches = 0
