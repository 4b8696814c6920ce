"""The attention kernel's share of its roofline in the traced requests:
the least time of one launch at the encoder's micro-batch shape (causal,
bfloat16; ``perfbench.bounds.flash_bound_ms``) over the mean device time of
the ``flash_fwd`` kernels the profiler recorded, in %."""
from perfbench.bounds import flash_bound_ms


def read(run):
    times = [k.dur_us for k in run.get("kernels") or ()
             if "flash_fwd" in k.name]
    if not times or not run.get("model"):
        return None
    m = run["model"]
    B, S = run["micro_batch"]
    bound_us = 1e3 * flash_bound_ms(B, m["n_heads"], m["n_kv_heads"], S, S,
                                    m["head_dim"], 2, True, 0)[0]
    return 100.0 * bound_us / (sum(times) / len(times))
