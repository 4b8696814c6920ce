"""Predictive entropy per row: the Hopper kernel ``csrc/entropy.cu`` behind a
checked wrapper.

Replaces ``src/repro/kernels/uncertainty.py::entropy_scores`` (Pallas body
``_entropy_kernel``), the uncertainty scorer of point selection (paper
§5.1). ``entropy_scores(logits)`` takes ``(..., V)`` float32 or bfloat16
logits and returns the ``(...)`` float32 entropies, reading each row once.
For CPU tensors it runs the plain version
:func:`repro_torch.kernels.ref.entropy_ref`; for CUDA tensors it launches
the kernel on the current stream or raises. ``entropy_scores.launches``
counts kernel launches.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import entropy_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_fn = None


def _launcher():
    global _fn
    if _fn is None:
        fn = _build.load("entropy").entropy_rows
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def entropy_scores(logits):
    """Per-row predictive entropy of ``(..., V)`` logits -> ``(...)``
    float32, in [0, log V]. Logits must be finite. On the card the tensor
    must be contiguous; its leading dims are flattened to rows."""
    if logits.dim() < 1:
        raise ValueError("entropy_scores takes (..., V) logits, got a scalar")
    if logits.dtype not in _DTYPES:
        raise TypeError(f"entropy_scores needs float32 or bfloat16 logits, "
                        f"got {logits.dtype}")
    if logits.device.type == "cpu":
        return entropy_ref(logits)
    if logits.device.type != "cuda":
        raise ValueError(f"entropy_scores runs on cpu or cuda, not "
                         f"{logits.device}")
    if not logits.is_contiguous():
        raise ValueError("entropy_scores needs contiguous logits on the card")
    lead, V = logits.shape[:-1], logits.shape[-1]
    N = math.prod(lead)
    if V >= 2 ** 31:
        raise ValueError(f"entropy_scores: V={V} does not fit a 32-bit int")
    out = torch.empty(lead, dtype=torch.float32, device=logits.device)
    if N == 0 or V == 0:
        return out.zero_()
    fn = _launcher()
    with torch.cuda.device(logits.device):
        stream = torch.cuda.current_stream(logits.device).cuda_stream
        err = fn(logits.data_ptr(), out.data_ptr(), N, V,
                 _DTYPES[logits.dtype], stream)
    if err != 0:
        raise RuntimeError(f"entropy kernel launch failed: CUDA error {err} "
                           f"(N={N}, V={V}, {logits.dtype})")
    entropy_scores.launches += 1
    return out


entropy_scores.launches = 0
