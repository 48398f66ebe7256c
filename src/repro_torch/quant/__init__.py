"""Quantizer substrate of the port: MXINT, uniform-int, GPTQ-style
(``repro/quant/__init__.py``)."""
from repro_torch.quant.base import (Quantizer, QuantizerConfig,
                                    effective_bits, quant_error, tree_bytes)
from repro_torch.quant.gptq import (BoundGPTQ, GPTQQuantizer,
                                    hessian_from_activations)
from repro_torch.quant.mxint import (MXIntPacked, MXIntQuantizer,
                                     pack_codes_4bit, unpack_codes_4bit)
from repro_torch.quant.uniform import UniformPacked, UniformQuantizer

__all__ = ["Quantizer", "QuantizerConfig", "effective_bits", "quant_error",
           "tree_bytes", "MXIntPacked", "MXIntQuantizer", "pack_codes_4bit",
           "unpack_codes_4bit", "UniformPacked", "UniformQuantizer",
           "GPTQQuantizer", "BoundGPTQ", "hessian_from_activations",
           "make_quantizer"]


def make_quantizer(config: QuantizerConfig, hessian=None):
    """Factory from a serializable config (+ an optional calibration
    Hessian, which GPTQ needs)."""
    if config.kind == "mxint":
        return MXIntQuantizer(bits=config.bits, block_size=config.block_size)
    if config.kind == "uniform":
        return UniformQuantizer(bits=config.bits,
                                group_size=config.block_size,
                                symmetric=config.symmetric)
    if config.kind == "gptq":
        if hessian is None:
            raise ValueError("gptq quantizer needs a calibration Hessian")
        return GPTQQuantizer(bits=config.bits, group_size=config.block_size,
                             symmetric=config.symmetric,
                             damping=config.damping).make_bound(hessian)
    raise ValueError(f"unknown quantizer kind {config.kind!r}")
