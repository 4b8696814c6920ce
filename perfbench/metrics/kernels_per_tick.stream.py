"""Device operations a tick of the traced sweep call launched: every
operation the profiler recorded in the call (the draws ahead of the loop
included) over the call's ticks."""
from perfbench.profiling import ops_per_tick


def read(run):
    return ops_per_tick(run)
