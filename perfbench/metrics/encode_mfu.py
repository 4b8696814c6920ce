"""The encoder's share of the card's bfloat16 peak over the traced
requests: the model FLOPs of their real tokens
(``perfbench.bounds.encoder_flops``) over the traced wall time, against
989 TFLOP/s, in %."""
import numpy as np

from perfbench.bounds import H100_BF16_FLOPS, encoder_flops


def read(run):
    n = run.get("traced_calls", 0)
    calls = [c for c in run.get("calls", [])[:n] if "lengths" in c]
    if not calls or not run.get("kernels") or not run.get("traced_wall_s"):
        return None
    lengths = np.concatenate([c["lengths"] for c in calls])
    flops = encoder_flops(lengths, **run["model"])
    return 100.0 * flops / run["traced_wall_s"] / H100_BF16_FLOPS
