"""Predictive entropy per row: the Hopper kernel ``csrc/entropy.cu`` behind a
checked wrapper.

Replaces ``src/repro/kernels/uncertainty.py::entropy_scores`` (Pallas body
``_entropy_kernel``), the uncertainty scorer of point selection (paper
§5.1). ``entropy_scores(logits)`` takes ``(..., V)`` float32 or bfloat16
logits and returns the ``(...)`` float32 entropies, reading each row once.
For CPU tensors it runs the plain version
:func:`repro_torch.kernels.ref.entropy_ref`; for CUDA tensors it launches
the kernel of the route :func:`entropy_route` gives (``narrow`` for
V <= 64, or ``wide``) on the current stream, or
raises. ``entropy_scores.launches`` counts kernel launches, one per call.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import entropy_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# rows up to this wide take the narrow kernels (a lane per row)
NARROW_MAX = 64
# route -> code of entropy_rows. "narrow_v1" forces the narrow kernel of
# the wider rows (a warp per tile of 32 rows staged in shared memory) at
# any V <= 64, for comparison on the card; entropy_route never returns it.
ROUTES = {"narrow": 0, "wide": 1, "narrow_v1": 2}
_fn = None


def entropy_route(V: int, dtype) -> str:
    """The route for rows of V ``dtype`` logits: ``"narrow"`` where V <= 64,
    else ``"wide"``. A function of V and the dtype alone; it never looks at
    a device."""
    if dtype not in _DTYPES:
        raise TypeError(f"entropy_scores takes float32 or bfloat16, not "
                        f"{dtype}")
    return "narrow" if V <= NARROW_MAX else "wide"


def _launcher():
    global _fn
    if _fn is None:
        fn = _build.load("entropy").entropy_rows
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def entropy_scores(logits, *, _route=None):
    """Per-row predictive entropy of ``(..., V)`` logits -> ``(...)``
    float32, in [0, log V]. Logits must be finite. On the card the tensor
    must be contiguous; its leading dims are flattened to rows, and the
    kernel is the one of :func:`entropy_route`'s route; ``_route`` (a key
    of ``ROUTES``) forces another, for comparisons on the card. CPU tensors
    take the plain version whatever ``_route`` says."""
    if logits.dim() < 1:
        raise ValueError("entropy_scores takes (..., V) logits, got a scalar")
    if logits.dtype not in _DTYPES:
        raise TypeError(f"entropy_scores needs float32 or bfloat16 logits, "
                        f"got {logits.dtype}")
    dev = logits.device
    if dev.type == "cpu":
        return entropy_ref(logits)
    if dev.type != "cuda":
        raise ValueError(f"entropy_scores runs on cpu or cuda, not {dev}")
    if not logits.is_contiguous():
        raise ValueError("entropy_scores needs contiguous logits on the card")
    lead, V = logits.shape[:-1], logits.shape[-1]
    N = math.prod(lead)
    if V >= 2 ** 31:
        raise ValueError(f"entropy_scores: V={V} does not fit a 32-bit int")
    out = torch.empty(lead, dtype=torch.float32, device=dev)
    if N == 0 or V == 0:
        return out.zero_()
    route = entropy_route(V, logits.dtype) if _route is None else _route
    if route not in ROUTES:
        raise ValueError(f"unknown entropy_scores route {route!r}")
    fn = _launcher()
    args = (logits.data_ptr(), out.data_ptr(), N, V, _DTYPES[logits.dtype],
            ROUTES[route])
    err = _build.launch(fn, dev, *args)
    if err != 0:
        raise RuntimeError(f"entropy {route} kernel launch failed: CUDA "
                           f"error {err} (N={N}, V={V}, {logits.dtype})")
    entropy_scores.launches += 1
    return out


entropy_scores.launches = 0
