"""Share of the tick's device time spent in assignment: the device intervals
of the program's ``tick.assign`` spans (the two ``priority_match`` calls and
what surrounds them) over those of its ``tick`` spans, in the traced sweep
call, in %."""
from perfbench.spans import share_of


def read(run):
    return share_of(("tick.assign",), "tick")
