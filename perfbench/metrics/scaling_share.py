"""Share of the window inside the qera-exact scalings: the benchmark's span
around each block's ``CalibStats.scaling`` calls (the offline pass's
``core/scaling.py``: one ``eigh`` a statistics group); moves
``ptq_weights_per_s``."""
from perfbench import readers


def read(s):
    w0, w1 = s.window
    return readers.share(sum(b - a for a, b in s.scaling_spans), w1 - w0)
