"""Group-wise uniform integer quantizer, symmetric or asymmetric (port
of ``repro/quant/uniform.py``).

The second quantizer family of the paper's quantizer-agnostic study
(Table 5), and the rounding primitive inside the GPTQ-style quantizer.
Groups run along the reduction axis (axis 0 of an ``(m, n)`` weight used
as ``y = x @ W``) like MXINT blocks, but the scale is a full-precision
float, not a power of two. Rounding is half-to-even (``torch.round``, as
``jnp.round``) and every division is one IEEE division (:func:`div`), so
codes, scales and zeros are JAX's bit for bit, on the CPU and the card
alike. Plain PyTorch on any device: the JAX package has no kernel for it
either.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch


class UniformPacked(NamedTuple):
    codes: torch.Tensor   # int8 (m_pad, n)
    scales: torch.Tensor  # f32 (m_pad//g, n)
    zeros: torch.Tensor   # f32 (m_pad//g, n) — 0 when symmetric
    group_size: int
    bits: int
    orig_rows: int


def div(a: torch.Tensor, k: float) -> torch.Tensor:
    """``a / k``, rounded once. On a CUDA tensor PyTorch multiplies by
    the reciprocal of a Python-scalar divisor (``1/3`` is itself
    rounded), which moves some quotients by an ulp; a 0-dim tensor on
    ``a``'s device is divided by."""
    return a / torch.tensor(k, dtype=a.dtype, device=a.device)


def _pad_rows(w: torch.Tensor, g: int) -> torch.Tensor:
    return torch.nn.functional.pad(w, (0, 0, 0, (-w.shape[0]) % g))


@dataclasses.dataclass(frozen=True)
class UniformQuantizer:
    bits: int = 3
    group_size: int = 32
    symmetric: bool = True

    @property
    def effective_bits(self) -> float:
        side = 16.0 if self.symmetric else 32.0
        return self.bits + side / self.group_size

    def quantize(self, w: torch.Tensor) -> UniformPacked:
        """Codes and per-group (scale, zero). Asymmetric codes in ``[0,
        2^bits − 1]`` are recentred into int8 by ``− 2^(bits−1)``, and the
        zero point shifted by ``scale · 2^(bits−1)`` to match, as JAX
        stores them."""
        m, n = w.shape
        g = self.group_size
        wp = _pad_rows(w.float(), g)
        blocks = wp.reshape(-1, g, n)
        if self.symmetric:
            qmax = 2 ** (self.bits - 1) - 1
            amax = blocks.abs().amax(dim=1)
            scale = torch.where(amax > 0, div(amax, qmax), 1.0)
            zero = torch.zeros_like(scale)
            codes = torch.clamp(torch.round(blocks / scale[:, None, :]),
                                -qmax - 1, qmax)
        else:
            levels = 2 ** self.bits - 1
            lo = blocks.amin(dim=1)
            rng = blocks.amax(dim=1) - lo
            scale = torch.where(rng > 0, div(rng, levels), 1.0)
            codes = torch.clamp(torch.round((blocks - lo[:, None, :])
                                            / scale[:, None, :]), 0, levels)
            codes = codes - 2 ** (self.bits - 1)
            zero = lo + scale * 2 ** (self.bits - 1)
        return UniformPacked(codes=codes.reshape(wp.shape).to(torch.int8),
                             scales=scale, zeros=zero, group_size=g,
                             bits=self.bits, orig_rows=m)

    def dequantize(self, p: UniformPacked) -> torch.Tensor:
        g = p.group_size
        codes = p.codes.float()
        nb, n = codes.shape[0] // g, codes.shape[1]
        out = (codes.reshape(nb, g, n) * p.scales[:, None, :]
               + p.zeros[:, None, :])
        return out.reshape(codes.shape)[: p.orig_rows]

    def fake_quant(self, w: torch.Tensor) -> torch.Tensor:
        return self.dequantize(self.quantize(w)).to(w.dtype)

    def round_with_scales(self, w: torch.Tensor, scales: torch.Tensor,
                          zeros: torch.Tensor) -> torch.Tensor:
        """Round ``w`` (m, n) with *fixed* per-group scales and zeros
        ((m_pad//g, n), computed beforehand): GPTQ's inner step. Returns
        the fake-quantized values, shaped as ``w``."""
        g = self.group_size
        m, n = w.shape
        wp = _pad_rows(w.float(), g)
        blocks = wp.reshape(-1, g, n)
        if self.symmetric:
            qmax = 2 ** (self.bits - 1) - 1
            codes = torch.clamp(torch.round(blocks / scales[:, None, :]),
                                -qmax - 1, qmax)
            out = codes * scales[:, None, :]
        else:
            levels = 2 ** self.bits - 1
            half = 2 ** (self.bits - 1)
            q = torch.round((blocks - zeros[:, None, :]) / scales[:, None, :])
            codes = torch.clamp(q + half, 0, levels) - half
            out = codes * scales[:, None, :] + zeros[:, None, :]
        return out.reshape(wp.shape)[:m]
