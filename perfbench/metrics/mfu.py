"""The whole window's model FLOPs (decoded tokens and admitted prompts, by
the frozen formulas) over the window's seconds times the bf16 peak; it
bounds every kernel's roofline share in the cell."""
from perfbench import readers
from perfbench.work import peaks


def read(s):
    w0, w1 = s.window
    return readers.share(readers.window_flops(s), (w1 - w0) * peaks.PEAK_MFU)
