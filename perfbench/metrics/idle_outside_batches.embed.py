"""Share of the traced wall in which the device was idle while the host was
inside none of the program's ``encode.batch`` spans (request set-up, the
wait for features, the submitter), in %."""
from perfbench.spans import idle_outside_share


def read(run):
    return idle_outside_share(run, ("encode.batch",))
