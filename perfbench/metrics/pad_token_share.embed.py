"""Share of the encoder's token slots that hold no real token, over the
traced requests: 100 x (1 - the real lengths / the micro-batches' slots),
pad rows of a last micro-batch and pad positions past each text's length
both counted, in %."""
from perfbench.spans import pad_share


def read(run):
    return pad_share(run)
