"""Share of the encoder's micro-batch device time spent in the MoE's
combine: the device intervals of the program's ``moe.combine`` spans
(slot weights, the gather back to tokens, the ordered sum) inside
``encode.batch`` over those of its ``encode.batch`` spans, over the traced
requests, in %."""
from perfbench.spans import share_of


def read(run):
    return share_of(("moe.combine",), "encode.batch")
