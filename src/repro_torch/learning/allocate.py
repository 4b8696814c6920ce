"""Budget allocation between active and passive labeling (paper §5.1/§6.5).

The port's own copy of ``src/repro/learning/allocate.py`` (host floats,
no framework).

The hybrid strategy splits each crowd batch of ``p`` points into
``k = r * p`` actively-selected and ``p - k`` passively-sampled points.
:func:`split_budget` is the deterministic static split, decided in Python
once per run or per round.

:class:`AccEst` is the adaptive allocator: per round it takes the two
arms' ESTIMATED accuracy gain per label and steers the fraction ``r``
toward the better arm. The scalar ``simulate_learning`` loop feeds it
leave-one-arm-out counterfactuals — refit the learner without the round's
active (resp. passive) points and credit each arm the test accuracy its
labels actually bought — so the signal can favor either arm (active picks
that bought label noise come out NEGATIVE and push r down). Gains are
exponentially decayed and compared relatively (shift by the minimum), and
``r`` is bounded to [r_min, r_max] so the passive arm (which keeps the
fit unbiased, paper §5.1) is never starved. Splits change between rounds
at the Python level; the batched engine uses the static split for the
whole run.
"""
from __future__ import annotations

import dataclasses


def split_budget(budget: int, al_fraction: float) -> "tuple[int, int]":
    """Deterministic (k_active, n_passive) split of a batch budget."""
    if budget <= 0:
        return 0, 0
    r = min(1.0, max(0.0, float(al_fraction)))
    k = min(budget, int(round(r * budget)))
    return k, budget - k


@dataclasses.dataclass
class AccEst:
    """Estimated-gain allocator steering the active fraction ``r``.

    ``update(gain_active, gain_passive)`` takes the two arms' estimated
    accuracy gain per label for the last round (possibly negative — see
    the module docstring) and moves ``r`` a ``step`` fraction toward the
    relative target, with decayed smoothing so one noisy round cannot
    whipsaw the split.
    """
    r: float = 0.5
    r_min: float = 0.1
    r_max: float = 0.9
    decay: float = 0.6
    step: float = 0.5           # how far r moves toward the target per update
    gain_active: float = 0.0
    gain_passive: float = 0.0
    n_updates: int = 0

    def update(self, gain_active: float, gain_passive: float) -> float:
        ga, gp = float(gain_active), float(gain_passive)
        if self.n_updates == 0:
            self.gain_active, self.gain_passive = ga, gp
        else:
            self.gain_active = self.decay * self.gain_active \
                + (1 - self.decay) * ga
            self.gain_passive = self.decay * self.gain_passive \
                + (1 - self.decay) * gp
        self.n_updates += 1
        # relative comparison: shift both decayed gains to non-negative so
        # the split reflects WHICH arm is buying more accuracy even when
        # both (or either) gains are negative
        lo = min(self.gain_active, self.gain_passive)
        a, p = self.gain_active - lo, self.gain_passive - lo
        denom = a + p
        target = 0.5 if denom <= 1e-12 else a / denom
        self.r += self.step * (target - self.r)
        self.r = min(self.r_max, max(self.r_min, self.r))
        return self.r

    def al_fraction(self) -> float:
        return self.r

    def split(self, budget: int) -> "tuple[int, int]":
        return split_budget(budget, self.r)
