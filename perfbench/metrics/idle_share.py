"""Share of the traced stretch with no operation on the card (a pass
cell's traces hold its blocks' SRR, not their scalings)."""
from perfbench import readers


def read(s):
    return readers.idle_share(s)
