"""Task-arrival processes — the open-world side of labelstream.

Port of ``src/repro/labelstream/arrivals.py``. Three generators, all
returning per-tick arrival counts for a batch of replications, drawn with
the run's ``torch.Generator`` on the run's device:

  * ``poisson``  — homogeneous Poisson(rate * dt) per tick;
  * ``mmpp``     — 2-state Markov-modulated Poisson (bursty): exponential
    dwell in a calm state at ``rate`` and a burst state at ``rate_hi``;
  * ``diurnal``  — inhomogeneous Poisson with a sinusoidal day curve:
    ``rate * (1 + amplitude * sin(2*pi*t/period))``.

State is a dict of ``(n_reps,)`` tensors; configs are frozen dataclasses.
"""
from __future__ import annotations

import dataclasses
import math

import torch



@dataclasses.dataclass(frozen=True)
class ArrivalConfig:
    kind: str = "poisson"        # poisson | mmpp | diurnal
    rate: float = 0.05           # tasks/s (poisson; mmpp calm state;
                                 # diurnal mean)
    rate_hi: float = 0.2         # mmpp burst-state rate
    dwell_mean_s: float = 600.0  # mmpp mean dwell time per state
    period_s: float = 86400.0    # diurnal period
    amplitude: float = 0.8       # diurnal modulation depth in [0, 1)


def init_arrival_state(cfg: ArrivalConfig, n_reps: int = 1,
                       device="cuda"):
    """mmpp mode per replication (unused by the other kinds), on ``device``
    (the card unless the caller asks for the CPU)."""
    return dict(mode=torch.zeros((n_reps,), dtype=torch.int64,
                                 device=torch.device(device)))


def rate_at(cfg: ArrivalConfig, state, t, rate=None):
    """Instantaneous offered rate (tasks/s) at time ``t`` (host float), one
    value per replication. ``rate`` (a number) optionally replaces
    ``cfg.rate``: the poisson rate, mmpp calm rate or diurnal mean (the
    mmpp burst rate stays)."""
    base = cfg.rate if rate is None else rate
    mode = state["mode"]
    if cfg.kind == "poisson":
        return torch.full(mode.shape, base, dtype=torch.float32,
                          device=mode.device)
    if cfg.kind == "mmpp":
        return torch.where(mode == 0,
                           torch.full(mode.shape, base, dtype=torch.float32,
                                      device=mode.device),
                           torch.full(mode.shape, cfg.rate_hi,
                                      dtype=torch.float32, device=mode.device))
    if cfg.kind == "diurnal":
        val = base * (1.0 + cfg.amplitude
                      * math.sin(2.0 * math.pi * t / cfg.period_s))
        return torch.full(mode.shape, val, dtype=torch.float32,
                          device=mode.device)
    raise ValueError(f"unknown arrival kind: {cfg.kind}")


def sample_arrivals(cfg: ArrivalConfig, state, gen: torch.Generator, t, dt,
                    scale=1.0, rate_abs=None):
    """Draw the number of arrivals in [t, t+dt) for every replication.

    Returns ``(n, state, rate)`` with ``n`` an int64 ``(n_reps,)`` tensor.
    The mmpp mode flips with probability ``1 - exp(-dt/dwell)`` per tick —
    the discretized 2-state chain. ``scale`` (a number, or one value per
    replication) multiplies the offered rate; ``rate_abs`` (a number)
    instead replaces the base rate (see :func:`rate_at`; exact for mmpp
    too, whose burst rate stays). Nothing here waits for the device.
    """
    rate = rate_at(cfg, state, t, rate_abs) * scale
    n = torch.poisson(torch.clamp(rate, min=0.0) * dt,
                      generator=gen).to(torch.int64)
    if cfg.kind == "mmpp":
        p_switch = 1.0 - math.exp(-dt / cfg.dwell_mean_s)
        flip = torch.rand(rate.shape, generator=gen,
                          device=rate.device) < p_switch
        state = dict(mode=torch.where(flip, 1 - state["mode"], state["mode"]))
    return n, state, rate
