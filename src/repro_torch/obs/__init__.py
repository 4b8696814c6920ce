"""repro_torch.obs: observability of the port. Only the wall-clock registry
(``timing``) is ported; the in-loop trace buffers, export and report of
``src/repro/obs`` are ROADMAP A5e."""
from repro_torch.obs import timing

__all__ = ["timing"]
