"""Share of the window spent in engine steps that admitted a request (its
prefill at the padded width runs inside that step); moves ``out_tok_s``."""
from perfbench import readers


def read(s):
    steps = [st for st in readers.window_steps(s) if st.admitted]
    w0, w1 = s.window
    return readers.share(sum(st.t1 - st.t0 for st in steps), w1 - w0)
