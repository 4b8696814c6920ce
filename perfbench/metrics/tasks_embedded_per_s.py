"""Real texts embedded (pad rows not counted) over the window's time."""
from perfbench.profiling import per_window_s


def read(run):
    return per_window_s(run, "texts")
