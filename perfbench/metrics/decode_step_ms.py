"""Mean host time of an engine step that decoded and admitted nothing, over
the window (the engine layer: ``Engine.step``)."""
from perfbench import readers


def read(s):
    return readers.mean_ms(readers.decode_only(readers.window_steps(s)))
