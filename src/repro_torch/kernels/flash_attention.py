"""Flash attention forward: the Hopper kernel ``csrc/flash_attention.cu``
behind a checked wrapper.

Replaces ``src/repro/kernels/flash_attention.py::flash_attention`` (Pallas
body ``_flash_kernel``): online-softmax attention with GQA, causal and
sliding-window masks by index, fully masked tiles skipped.
``flash_attention(q, k, v)`` takes the model's ``(B, S, H, D)`` tensors,
read through their strides (a ``(B, H, S, D)`` tensor is passed as its
``transpose(1, 2)`` view, with no copy), and returns the output in q's
shape and dtype. For CPU tensors it runs the plain version
:func:`repro_torch.kernels.ref.attention_ref`; for CUDA tensors it launches
the kernel on the current stream or raises. ``flash_attention.launches``
counts kernel launches.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import attention_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256
_fn = None


def _launcher():
    global _fn
    if _fn is None:
        fn = _build.load("flash_attention").flash_attention_fwd
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                       + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
                          ctypes.c_int, ctypes.c_float, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _strides(x):
    """The (batch, head, sequence) element strides of a (B, S, H, D)
    tensor."""
    return x.stride(0), x.stride(2), x.stride(1)


def flash_attention(q, k, v, *, causal=True, window=0):
    """Attention of q (B, Sq, Hq, D) over k, v (B, Sk, Hkv, D), scaled by
    1 / sqrt(D). q head h reads kv head h // (Hq // Hkv). float32 or
    bfloat16 (all three alike), D <= 256; the output is (B, Sq, Hq, D) in
    q's dtype. On the card the last dim of each operand must be
    contiguous."""
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
    if q.device.type == "cpu":
        t = lambda x: x.transpose(1, 2)
        return t(attention_ref(t(q), t(k), t(v), causal=causal,
                               window=window))
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not "
                         f"{q.device}")
    if not 1 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention takes head dims 1..{MAX_HEAD_DIM}"
                         f", got {D}")
    if any(x.stride(-1) != 1 for x in (q, k, v)):
        raise ValueError("flash_attention needs the last dim of q, k, v "
                         "contiguous on the card")
    if B * Hq >= 2 ** 31 or Sq > 65535 * 64:
        raise ValueError(f"flash_attention: B*Hq={B * Hq} or Sq={Sq} too "
                         "large")
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if B == 0 or Sq == 0:
        return o
    if Sk == 0:
        raise ValueError("flash_attention needs Sk >= 1")
    strides = (ctypes.c_longlong * 12)(*_strides(q), *_strides(k),
                                         *_strides(v), *_strides(o))
    scale = 1.0 / math.sqrt(D)
    fn = _launcher()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 B, Hq, Hkv, Sq, Sk, D, strides, int(bool(causal)),
                 int(window), scale, _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err} (B={B}, Hq={Hq}, Hkv={Hkv}, "
                           f"Sq={Sq}, Sk={Sk}, D={D}, {q.dtype})")
    flash_attention.launches += 1
    return o


flash_attention.launches = 0
