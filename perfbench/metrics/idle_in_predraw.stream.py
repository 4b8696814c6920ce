"""Share of the traced wall in which the device was idle while the host was
inside the program's ``sweep.predraw`` span (each point's start state and
arrivals drawn ahead of the tick loop), in %."""
from perfbench.spans import idle_share


def read(run):
    return idle_share(run, ("sweep.predraw",))
