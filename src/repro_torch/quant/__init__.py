"""Quantizer substrate of the port (MXINT only in this slice)."""
from repro_torch.quant.mxint import (MXIntPacked, MXIntQuantizer,
                                     pack_codes_4bit, unpack_codes_4bit)

__all__ = ["MXIntPacked", "MXIntQuantizer", "pack_codes_4bit",
           "unpack_codes_4bit"]
