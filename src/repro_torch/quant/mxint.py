"""MXINT block quantizer — the port of ``repro.quant.mxint``.

A block of ``block_size`` consecutive weights along the *reduction* axis
(axis 0 of an ``(m, n)`` weight used as ``y = x @ W``) shares one 8-bit
power-of-two exponent; each element stores a signed ``bits``-bit integer
mantissa. The exponent is ``ceil(log2(amax / qmax))``, computed exactly,
and rounding is half-to-even (``torch.round``, like ``jnp.round``); codes
and exponents match the JAX quantizer bit for bit except where its
``log2`` rounds across an integer (quotients at or a few ulps above a
power of two, ROADMAP §3). ``quantize`` runs K7
(``kernels/mxint_quantize.py``) on a CUDA tensor and its plain version
on a CPU tensor. ``quantize`` and ``dequantize`` run under
``torch.profiler`` ranges named ``mxint.quantize`` and
``mxint.dequantize``, which a profile of the SRR pass reads by stage.

``pack_codes_4bit`` / ``unpack_codes_4bit`` are the deployment container
for ``bits <= 4``: two codes per uint8 byte, even rows in the low nibble.
The CUDA matmul and decode-attention kernels read it as is.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
from torch.profiler import record_function

from repro_torch.kernels import work
from repro_torch.kernels.mxint_quantize import mxint_quantize


class MXIntPacked(NamedTuple):
    """Quantized weight: int8 codes + per-block int8 exponents.

    ``codes``     int8  (m_pad, n)       mantissas in [-qmax-1, qmax]
    ``exponents`` int8  (m_pad//block, n) shared power-of-2 exponent
    """

    codes: torch.Tensor
    exponents: torch.Tensor
    block_size: int
    bits: int
    orig_rows: int  # m before padding


@dataclasses.dataclass(frozen=True)
class MXIntQuantizer:
    """Symmetric MXINT quantizer with shared power-of-2 block exponents."""

    bits: int = 3
    block_size: int = 32

    @property
    def effective_bits(self) -> float:
        """Bits a weight including the shared 8-bit block exponent."""
        return self.bits + 8.0 / self.block_size

    def quantize(self, w: torch.Tensor) -> MXIntPacked:
        if w.ndim != 2:
            raise ValueError(f"MXInt expects 2-D weights, got {tuple(w.shape)}")
        m = w.shape[0]
        b = self.block_size
        with record_function("mxint.quantize"):
            wp = torch.nn.functional.pad(w.float(), (0, 0, 0, (-m) % b))
            codes, exps = work.kernel(
                lambda: work.mxint_quantize_work(*wp.shape), mxint_quantize,
                wp.contiguous(), self.bits, b)
        return MXIntPacked(codes=codes, exponents=exps, block_size=b,
                           bits=self.bits, orig_rows=m)

    def dequantize(self, packed: MXIntPacked) -> torch.Tensor:
        b = packed.block_size
        with record_function("mxint.dequantize"):
            codes = packed.codes.float()
            nb, n = codes.shape[0] // b, codes.shape[1]
            scale = torch.exp2(packed.exponents.float())
            out = (codes.reshape(nb, b, n)
                   * scale[:, None, :]).reshape(codes.shape)
        return out[: packed.orig_rows]

    def fake_quant(self, w: torch.Tensor) -> torch.Tensor:
        return self.dequantize(self.quantize(w)).to(w.dtype)


def pack_codes_4bit(codes: torch.Tensor) -> torch.Tensor:
    """Pack int8 codes in [-8, 7] two per byte (even rows = low nibble).

    Rows live on axis -2; leading dims (the (B, KV) dims of a head-major
    KV cache) pass through. (..., m, n) int8 with m even → (..., m//2, n)
    uint8."""
    if codes.shape[-2] % 2:
        raise ValueError("row count must be even to pack 4-bit pairs")
    u = codes.to(torch.int32) & 0xF
    lo, hi = u[..., 0::2, :], u[..., 1::2, :]
    return (lo | (hi << 4)).to(torch.uint8)


def unpack_codes_4bit(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_codes_4bit` → int8 codes in [-8, 7], with
    the shift-based sign extension the kernels use: ``(b << 28) >> 28``
    for the low nibble and ``(b << 24) >> 28`` for the high one, in
    int32."""
    u = packed.to(torch.int32)
    lo = ((u << 28) >> 28).to(torch.int8)
    hi = ((u << 24) >> 28).to(torch.int8)
    lead, (m2, n) = packed.shape[:-2], packed.shape[-2:]
    return torch.stack([lo, hi], dim=-2).reshape(*lead, m2 * 2, n)
