"""Flash attention: the Hopper kernels ``csrc/flash_attention.cu`` (forward)
and ``csrc/flash_attention_bwd.cu`` (backward) behind a checked,
differentiable wrapper.

Replaces ``src/repro/kernels/flash_attention.py::flash_attention`` (Pallas
body ``_flash_kernel``): online-softmax attention with GQA, causal and
sliding-window masks by index, fully masked tiles skipped.
``flash_attention(q, k, v)`` takes the model's ``(B, S, H, D)`` tensors,
read through their strides (a ``(B, H, S, D)`` tensor is passed as its
``transpose(1, 2)`` view, with no copy), and returns the output in q's
shape and dtype. It is a ``torch.autograd.Function``: when a gradient is
wanted the forward kernel also writes each row's log-sum-exp, and the
backward kernels recompute P from it (no float atomics: dq, and dk/dv per
kv head, come from separate kernels). For CPU tensors both directions run
the plain versions :func:`repro_torch.kernels.ref.attention_ref` and
:func:`~repro_torch.kernels.ref.attention_bwd_ref`; for CUDA tensors they
launch the kernels on the current stream or raise.
``flash_attention.launches`` and ``flash_attention.bwd_launches`` count
kernel launches (a backward launch runs its three or four kernels).
bfloat16 operands go to the tensor-core kernels, float32 operands to the
FMA kernels (see the sources).
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import attention_bwd_ref, attention_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256
_fns: dict = {}
_TAIL = ([ctypes.c_int] * 6
         + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
# name -> (library, C function, argument types, return type)
_SIGS = {
    "fwd": ("flash_attention", "flash_attention_fwd",
            [ctypes.c_void_p] * 5 + _TAIL, ctypes.c_int),
    "bwd": ("flash_attention_bwd", "flash_attention_bwd",
            [ctypes.POINTER(ctypes.c_void_p)] + _TAIL, ctypes.c_int),
    "scratch": ("flash_attention_bwd", "flash_attention_bwd_scratch",
                [ctypes.c_int] * 6, ctypes.c_longlong),
}


def _launcher(name):
    fn = _fns.get(name)
    if fn is None:
        lib, cname, argtypes, restype = _SIGS[name]
        fn = getattr(_build.load(lib), cname)
        fn.argtypes, fn.restype = argtypes, restype
        _fns[name] = fn
    return fn


def _strides(x):
    """The (batch, head, sequence) element strides of a (B, S, H, D)
    tensor."""
    return x.stride(0), x.stride(2), x.stride(1)


def _dims(q, k):
    B, Sq, Hq, D = q.shape
    return B, Hq, k.shape[2], Sq, k.shape[1], D


def _fwd_kernel(q, k, v, causal, window, want_lse):
    B, Hq, Hkv, Sq, Sk, D = _dims(q, k)
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
           if want_lse else None)
    if B == 0 or Sq == 0:
        return o, lse
    strides = (ctypes.c_longlong * 12)(*_strides(q), *_strides(k),
                                         *_strides(v), *_strides(o))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _launcher("fwd")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            None if lse is None else lse.data_ptr(), B, Hq, Hkv, Sq, Sk, D,
            strides, int(bool(causal)), int(window), 1.0 / math.sqrt(D),
            _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err} (B={B}, Hq={Hq}, Hkv={Hkv}, "
                           f"Sq={Sq}, Sk={Sk}, D={D}, {q.dtype})")
    flash_attention.launches += 1
    return o, lse


def _bwd_kernel(q, k, v, o, lse, do, causal, window):
    B, Hq, Hkv, Sq, Sk, D = _dims(q, k)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    if B == 0 or Sq == 0:
        return dq, dk.zero_(), dv.zero_()
    delta = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    ops = (q, k, v, o, do, dq, dk, dv)
    strides = (ctypes.c_longlong * 24)(*(x for t in ops
                                         for x in _strides(t)))
    with torch.cuda.device(q.device):
        # the bf16 dk/dv kernel's float32 partials when it splits the query
        # heads of a kv head into groups (the kernel's own rule)
        nbytes = _launcher("scratch")(B, Hq, Hkv, Sk, D, _DTYPES[q.dtype])
        scratch = (torch.empty(nbytes, dtype=torch.uint8, device=q.device)
                   if nbytes else None)
        ts = (q, k, v, o, do, lse, delta, dq, dk, dv)
        ptrs = (ctypes.c_void_p * 11)(*(t.data_ptr() for t in ts),
                                      scratch.data_ptr() if nbytes else None)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _launcher("bwd")(ptrs, B, Hq, Hkv, Sq, Sk, D, strides,
                               int(bool(causal)), int(window),
                               1.0 / math.sqrt(D), _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_attention backward launch failed: CUDA "
                           f"error {err} (B={B}, Hq={Hq}, Hkv={Hkv}, "
                           f"Sq={Sq}, Sk={Sk}, D={D}, {q.dtype})")
    flash_attention.bwd_launches += 1
    return dq, dk, dv


def _t(x):
    return x.transpose(1, 2)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        if q.device.type == "cpu":
            o, lse = _t(attention_ref(_t(q), _t(k), _t(v), causal=causal,
                                      window=window)), None
        else:
            o, lse = _fwd_kernel(q, k, v, causal, window,
                                 any(ctx.needs_input_grad[:3]))
        ctx.causal, ctx.window = causal, window
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if q.device.type == "cpu":
            dq, dk, dv = attention_bwd_ref(_t(q), _t(k), _t(v), _t(o),
                                           _t(do), causal=ctx.causal,
                                           window=ctx.window)
            return _t(dq), _t(dk), _t(dv), None, None
        do = do.to(q.dtype)
        if do.stride(-1) != 1:
            do = do.contiguous()
        dq, dk, dv = _bwd_kernel(q, k, v, o, lse, do, ctx.causal, ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal=True, window=0):
    """Attention of q (B, Sq, Hq, D) over k, v (B, Sk, Hkv, D), scaled by
    1 / sqrt(D), differentiable in q, k and v. q head h reads kv head
    h // (Hq // Hkv). float32 or bfloat16 (all three alike), D <= 256; the
    output is (B, Sq, Hq, D) in q's dtype. On the card the last dim of each
    operand must be contiguous."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention takes 4-d q, k, v")
    B, Sq, Hq, D = q.shape
    Bk, Sk, Hkv, Dk = k.shape
    if tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    if Bk != B or Dk != D or Hkv < 1 or Hq % Hkv != 0:
        raise ValueError(f"incompatible q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention needs float32 or bfloat16 q, k, v "
                        f"of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must be on one device")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if q.device.type != "cpu":
        if q.device.type != "cuda":
            raise ValueError(f"flash_attention runs on cpu or cuda, not "
                             f"{q.device}")
        if not 1 <= D <= MAX_HEAD_DIM:
            raise ValueError(f"flash_attention takes head dims "
                             f"1..{MAX_HEAD_DIM}, got {D}")
        if any(x.stride(-1) != 1 for x in (q, k, v)):
            raise ValueError("flash_attention needs the last dim of q, k, v "
                             "contiguous on the card")
        if B * Hq >= 2 ** 31 or Sq > 65535 * 32 or Sk > 65535 * 16:
            raise ValueError(f"flash_attention: B*Hq={B * Hq}, Sq={Sq} or "
                             f"Sk={Sk} too large")
        if Sk == 0 and B > 0 and Sq > 0:
            raise ValueError("flash_attention needs Sk >= 1")
    return _FlashAttention.apply(q, k, v, bool(causal), int(window))


flash_attention.launches = 0
flash_attention.bwd_launches = 0
