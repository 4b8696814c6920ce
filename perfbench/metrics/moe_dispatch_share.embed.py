"""Share of the encoder's micro-batch device time spent routing the MoE:
the device intervals of the program's ``moe.dispatch`` spans (router
softmax, top-k sort, argsort, searchsorted, the ``index_put`` into expert
slots) inside ``encode.batch`` over those of its ``encode.batch`` spans, over
the traced requests, in %."""
from perfbench.spans import share_of


def read(run):
    return share_of(("moe.dispatch",), "encode.batch")
