"""Share of the tick's device time spent in admission: the device intervals
of the program's ``tick.admit`` spans (backlog push, admission, the bank
gather) over those of its ``tick`` spans, in the traced sweep call, in %."""
from perfbench.spans import share_of


def read(run):
    return share_of(("tick.admit",), "tick")
