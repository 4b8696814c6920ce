"""In-order float32 sums: the Hopper kernel ``csrc/ordered_sum.cu`` behind a
checked wrapper.

Replaces no TPU kernel: the JAX package leaves these sums to XLA. The
stream learner's products and row sums (:mod:`repro_torch.learning.linear`)
add their terms in index order so that the CPU and the card round alike;
their plain versions, :func:`repro_torch.kernels.ref.ordered_matmul_ref` and
:func:`~repro_torch.kernels.ref.segment_sum_ref`, build a product tensor and
call ``torch.segment_reduce(lengths=...)``, which on the card scans its
lengths into offsets once per product row. The kernel reads its operands
once and writes only the sums, so it is bound by bytes.

``ordered_matmul(A, B)`` takes ``A (..., n, k)`` and ``B (..., k, m)``
float32 with broadcast leading dims and any strides; ``segment_sum(g,
size)`` takes ``g (R, S*size, C)`` float32 and returns the ``(R, S, C)``
sums of each run of ``size`` rows. For CPU tensors they run the plain
versions; for CUDA tensors they launch the kernel on the current stream, or
raise. The bits are the plain versions' on either device. Each function's
``launches`` counts its kernel launches, one per call with a nonempty
output.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ordered_matmul_ref, segment_sum_ref

_INT_MAX = 2 ** 31 - 1
_fns = None


def _launchers():
    global _fns
    if _fns is None:
        lib = _build.load("ordered_sum")
        ll, i32, p = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p
        mm = lib.ordered_matmul_f32
        mm.argtypes = [p, ll, ll, ll, p, ll, ll, ll, p, ll, i32, i32, i32, p]
        mm.restype = ctypes.c_int
        ss = lib.segment_sum_f32
        ss.argtypes = [p, ll, ll, ll, p, ll, i32, i32, i32, p]
        ss.restype = ctypes.c_int
        _fns = (mm, ss)
    return _fns


def _check_float32(name, *xs):
    for x in xs:
        if x.dtype != torch.float32:
            raise TypeError(f"{name} takes float32, got {x.dtype}")
    dev = xs[0].device
    if any(x.device != dev for x in xs):
        raise ValueError(f"{name}: operands on {[str(x.device) for x in xs]}"
                         f", not one device")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda, not {dev}")
    return dev


def _fits(name, **dims):
    for k, v in dims.items():
        if v > _INT_MAX:
            raise ValueError(f"{name}: {k}={v} does not fit a 32-bit int")


def _broadcast(a, b):
    """The broadcast of shapes ``a`` and ``b``, or None. (Not
    ``torch.broadcast_shapes``: its first call imports sympy, seconds of a
    process's start-up.)"""
    n = max(len(a), len(b))
    a, b = (1,) * (n - len(a)) + tuple(a), (1,) * (n - len(b)) + tuple(b)
    if any(x != y and 1 not in (x, y) for x, y in zip(a, b)):
        return None
    return torch.Size(y if x == 1 else x for x, y in zip(a, b))


def ordered_matmul(A, B):
    """``A (..., n, k) @ B (..., k, m)`` -> ``(..., n, m)`` float32, each
    output ``((0 + A[.., i, 0] B[.., 0, j]) + A[.., i, 1] B[.., 1, j]) + ...``
    with every product and add rounded on its own: the same bits on the CPU
    and the card, for any batch size (cuBLAS picks its order by shape).
    Leading dims broadcast; k and m must be at least 1."""
    dev = _check_float32("ordered_matmul", A, B)
    if A.dim() < 2 or B.dim() < 2:
        raise ValueError(f"ordered_matmul takes (..., n, k) @ (..., k, m), "
                         f"got {tuple(A.shape)} and {tuple(B.shape)}")
    n, k, m = A.shape[-2], A.shape[-1], B.shape[-1]
    if B.shape[-2] != k or k == 0 or m == 0:
        raise ValueError(f"ordered_matmul: {tuple(A.shape)} @ "
                         f"{tuple(B.shape)} needs k = B's rows >= 1 and "
                         f"m >= 1")
    lead = _broadcast(A.shape[:-2], B.shape[:-2])
    if lead is None:
        raise ValueError(f"ordered_matmul: leading dims of "
                         f"{tuple(A.shape)} and {tuple(B.shape)} do not "
                         f"broadcast")
    if dev.type == "cpu":
        return ordered_matmul_ref(A, B)
    _fits("ordered_matmul", n=n, k=k, m=m)
    out = torch.empty(lead + (n, m), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    a = A.expand(lead + (n, k)).reshape((-1, n, k))
    b = B.expand(lead + (k, m)).reshape((-1, k, m))
    mm, _ = _launchers()
    err = _build.launch(mm, dev, a.data_ptr(), *a.stride(), b.data_ptr(),
                        *b.stride(), out.data_ptr(), a.shape[0], n, k, m)
    if err != 0:
        raise RuntimeError(f"ordered_matmul kernel launch failed: CUDA error "
                           f"{err} ({tuple(a.shape)} @ {tuple(b.shape)})")
    ordered_matmul.launches += 1
    return out


def segment_sum(g, size: int):
    """``g (R, S*size, C)`` -> ``(R, S, C)`` float32: each run of ``size``
    rows summed in index order from 0, every add rounded on its own, the
    same bits on the CPU and the card."""
    dev = _check_float32("segment_sum", g)
    if g.dim() != 3:
        raise ValueError(f"segment_sum takes (R, S*size, C), got "
                         f"{tuple(g.shape)}")
    R, n, C = g.shape
    if size < 1 or n % size:
        raise ValueError(f"segment_sum: {n} rows are not runs of size "
                         f"{size}")
    if dev.type == "cpu":
        return segment_sum_ref(g, size)
    S = n // size
    _fits("segment_sum", S=S, size=size, C=C)
    out = torch.empty((R, S, C), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    _, ss = _launchers()
    err = _build.launch(ss, dev, g.data_ptr(), *g.stride(), out.data_ptr(),
                        R, S, size, C)
    if err != 0:
        raise RuntimeError(f"segment_sum kernel launch failed: CUDA error "
                           f"{err} ({tuple(g.shape)}, size {size})")
    segment_sum.launches += 1
    return out


ordered_matmul.launches = 0
segment_sum.launches = 0
