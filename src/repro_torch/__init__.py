"""PyTorch/CUDA port of the CLAMShell reproduction (``src/repro``).

Module names mirror ``src/repro``. The port imports torch, numpy and the
standard library only; it shares no code with the JAX package. Every entry
point takes a ``device`` argument that defaults to ``"cuda"`` and raises
when no card is present (see :mod:`repro_torch.device`); pass
``device="cpu"`` to run the plain PyTorch versions of the kernels.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
