"""Replication-ticks the window's sweeps completed, over all the window's
time (until the last call that started inside it ended)."""
from perfbench.profiling import per_window_s


def read(run):
    return per_window_s(run, "rep_ticks")
