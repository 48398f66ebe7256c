"""K6's roofline share in the traced decode-only steps: the routed expert
stacks' bound (every expert live, ``top_k`` rows a lane) over the device
time of ``qlr_stacked_kernel`` in those steps; moves ``out_tok_s``."""
from perfbench import readers


def read(s):
    steps = readers.traced(s, readers.decode_only(readers.window_steps(s)))
    return readers.roofline(s, "K6", steps, readers.decode_bound_s(s, "K6"))
