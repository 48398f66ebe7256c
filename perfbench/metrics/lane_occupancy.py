"""Decoding lanes summed over the window's decode steps, over steps times
``decode_batch`` (the scheduler layer); moves ``out_tok_s``."""
from perfbench import readers


def read(s):
    steps = [st for st in readers.window_steps(s) if st.lanes]
    if not steps:
        return None
    return readers.share(sum(st.lanes for st in steps),
                         len(steps) * s.sc.decode_batch)
