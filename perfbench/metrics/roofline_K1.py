"""K1's roofline share in the traced decode-only steps: their K1 bound
(every plain projection at ``decode_batch`` rows, frozen formulas, H100
peaks) over the device time of the K1 kernels they launched; moves
``out_tok_s``."""
from perfbench import readers


def read(s):
    steps = readers.traced(s, readers.decode_only(readers.window_steps(s)))
    return readers.roofline(s, "K1", steps, readers.decode_bound_s(s, "K1"))
