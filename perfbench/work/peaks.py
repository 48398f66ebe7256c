"""Published peaks of one NVIDIA H100 SXM (data sheet, dense rates, at its
700 W limit): a copy of ``repro_torch/launch/roofline.py``'s. Every share
read against them is printed beside the card's ``power.limit``."""
from __future__ import annotations

PEAK_FLOPS = {"bfloat16": 989e12,   # tensor cores, dense
              "float32": 67e12}     # outside the tensor cores
HBM_BW = 3.35e12                    # bytes/s
PEAK_MFU = PEAK_FLOPS["bfloat16"]   # the denominator of every MFU


def bound_s(flops: float, nbytes: float, dtype: str = "bfloat16") -> float:
    """The least time the chip could take: the larger of the bytes at the
    HBM rate and the operations at ``dtype``'s peak."""
    return max(nbytes / HBM_BW, flops / PEAK_FLOPS[dtype])
