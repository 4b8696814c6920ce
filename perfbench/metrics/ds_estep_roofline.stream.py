"""The refresh E-step kernel's share of its roofline in the traced sweep
call: the mean least time of the launches at the shapes the call made
(``perfbench.bounds.estep_bound_ms``) over the mean device time of the
``ds_estep`` kernels the profiler recorded, in %. Nothing to read where the
call ran no refresh."""
from perfbench.bounds import estep_bound_ms


def read(run):
    times = [k.dur_us for k in run.get("kernels") or ()
             if "ds_estep" in k.name]
    shapes = run.get("estep_shapes_traced") or []
    if not times or not shapes:
        return None
    bound_us = 1e3 * sum(estep_bound_ms(*s)[0] for s in shapes) / len(shapes)
    return 100.0 * bound_us / (sum(times) / len(times))
