"""Share of the traced wall in which the device was idle while the host was
inside one of the program's ``tick`` spans, in %."""
from perfbench.spans import idle_share


def read(run):
    return idle_share(run, ("tick",))
