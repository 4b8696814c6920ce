"""Share of the tick's device time spent in the learner: the device
intervals of the program's ``tick.fuse`` spans (learner fusion) and
``tick.learner_fit`` spans (its parameters and ring push / fit) over those
of its ``tick`` spans, in the traced sweep call, in %."""
from perfbench.spans import share_of


def read(run):
    return share_of(("tick.fuse", "tick.learner_fit"), "tick")
