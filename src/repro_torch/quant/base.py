"""Quantizer protocol and its serializable config (port of
``repro/quant/base.py``).

A quantizer maps a full-precision weight matrix ``W`` to a *simulated*
quantized matrix ``Q = dequant(quant(W))`` plus an opaque packed
representation for deployment. All SRR/QER math operates on the
simulated ``Q``, as the paper does; the packed form of MXINT feeds the
serving path and the kernels.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Protocol

import torch
from torch import nn


class Quantizer(Protocol):
    """Protocol implemented by all weight quantizers."""

    #: effective bits per weight including side info (3.25 for MXINT3/b32)
    effective_bits: float

    def quantize(self, w: torch.Tensor) -> Any:
        """An opaque packed representation of ``w``."""
        ...

    def dequantize(self, packed: Any) -> torch.Tensor:
        """Inverse of :meth:`quantize` up to rounding."""
        ...

    def fake_quant(self, w: torch.Tensor) -> torch.Tensor:
        """``dequantize(quantize(w))``: the simulated quantized weights."""
        ...


@dataclasses.dataclass(frozen=True)
class QuantizerConfig:
    """Serializable description of a quantizer choice."""

    kind: str = "mxint"  # mxint | uniform | gptq | none
    bits: int = 3
    block_size: int = 32  # MXINT block / uniform group size
    symmetric: bool = True
    # GPTQ-specific
    damping: float = 0.01

    def key(self) -> str:
        return f"{self.kind}{self.bits}b{self.block_size}"


def quant_error(quantizer: Quantizer, w: torch.Tensor) -> torch.Tensor:
    """E_Q(W) = W − Q(W): the paper's quantization error operator."""
    return w - quantizer.fake_quant(w)


def effective_bits(config: QuantizerConfig) -> float:
    """Average bits a weight including shared side information: MXINT
    adds one 8-bit exponent a block (3 + 8/32 = 3.25, the paper's
    accounting); uniform group quantization (and GPTQ, which stores its
    codes that way) one fp16 scale a group, plus an fp16 zero point when
    asymmetric."""
    if config.kind == "none":
        return 16.0
    if config.kind == "mxint":
        return config.bits + 8.0 / config.block_size
    if config.kind in ("uniform", "gptq"):
        side = 16.0 if config.symmetric else 32.0
        return config.bits + side / config.block_size
    raise ValueError(f"unknown quantizer kind {config.kind!r}")


def tree_bytes(tree: Any) -> int:
    """Total bytes of the tensors in a nested dict / list / tuple (a
    packed NamedTuple too) or of a module's buffers, for memory
    accounting; non-tensor leaves count 0, as JAX's ``tree_bytes`` skips
    them."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, nn.Module):
        tree = list(tree.buffers())
    elif isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(x) for x in tree)
    return 0
