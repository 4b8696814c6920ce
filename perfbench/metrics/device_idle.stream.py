"""Share of the traced sweep call's wall time in which no operation ran on the
device (100 - busy / wall, in %)."""
from perfbench.profiling import idle_pct


def read(run):
    return idle_pct(run)
