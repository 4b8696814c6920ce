"""Worker-aware routing configuration.

Only :class:`RoutingConfig` is ported so far, because
:class:`repro_torch.labelstream.router.StreamConfig` holds one; the scored
matcher and learner-driven admission of ``src/repro/labelstream/routing.py``
are not, and the router refuses configs that turn them on.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RoutingConfig:
    """Static knobs for worker-aware routing and backlog admission; fields
    and defaults as in the reference."""
    enabled: bool = False
    w_acc: float = 3.0
    w_speed: float = 0.5
    ewma_alpha: float = 0.25
    # "fifo" | "uncertain" | "uncertain_learnable"
    admission: str = "fifo"
