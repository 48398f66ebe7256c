"""GPTQ-style Hessian-ordered quantizer (Frantar et al., 2023; port of
``repro/quant/gptq.py``).

For a linear layer ``y = x @ W`` with input autocorrelation
``H = E[x xᵀ] ∈ R^{m×m}``, GPTQ quantizes the rows of ``W`` (input
channels) in order, propagating the rounding error of row ``i`` into
the rows not yet quantized through the upper Cholesky factor ``U`` of
``H⁻¹`` (``H⁻¹ = Uᵀ U``): after rounding row ``i``,
``W[j,:] -= U[i,j]/U[i,i] · (W[i,:] − q_i)`` for ``j > i``. Group scales
are fixed from the original weights; :class:`UniformQuantizer` rounds.

:func:`gptq_rows` is JAX's ``fori_loop`` body as a plain loop over the
rows: the same per-element arithmetic, with the update applied to the
rows past ``i`` only, where JAX subtracts a masked full-height product
(the masked rows subtract 0 and keep their values). It is a
calibration-time loop, O(m²n); the JAX package has no kernel for it, so
plain PyTorch is its port, on any device.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.quant.uniform import UniformPacked, UniformQuantizer, div


def _cholesky_inv_upper(h: torch.Tensor, damping: float) -> torch.Tensor:
    """Upper-triangular U with H⁻¹ = Uᵀ U (dampened)."""
    m = h.shape[0]
    d = damping * torch.diagonal(h).mean()
    hd = h + (d + 1e-8) * torch.eye(m, dtype=h.dtype, device=h.device)
    hinv = torch.linalg.inv(hd)
    # symmetrize against numerical drift before the Cholesky
    hinv = 0.5 * (hinv + hinv.T)
    return torch.linalg.cholesky(hinv).T      # lower L, H⁻¹ = L Lᵀ; U = Lᵀ


def gptq_rows(w: torch.Tensor, uinv: torch.Tensor, scales: torch.Tensor,
              zeros: torch.Tensor, bits: int, group_size: int,
              symmetric: bool) -> torch.Tensor:
    """Quantize ``w`` (m, n) row by row with the fixed group ``scales`` /
    ``zeros`` ((m_pad//g, n)), pushing each row's rounding error, divided
    by ``U[i, i]`` (clipped at 1e-8), into the later rows along row ``i``
    of ``uinv``; returns the quantized rows in f32."""
    wcur = w.float().clone()
    diag = torch.clamp(torch.diagonal(uinv), min=1e-8)
    for i in range(w.shape[0]):
        row = wcur[i]
        s = scales[i // group_size]
        z = zeros[i // group_size]
        if symmetric:
            qmax = 2 ** (bits - 1) - 1
            q = torch.clamp(torch.round(row / s), -qmax - 1, qmax) * s
        else:
            levels = 2 ** bits - 1
            half = 2 ** (bits - 1)
            c = torch.clamp(torch.round((row - z) / s) + half, 0,
                            levels) - half
            q = c * s + z
        err = (row - q) / diag[i]
        wcur[i + 1:] -= uinv[i, i + 1:, None] * err[None, :]
        wcur[i] = q
    return wcur


@dataclasses.dataclass(frozen=True)
class GPTQQuantizer:
    """Hessian-aware sequential quantizer. Bind a Hessian with
    :meth:`make_bound` to obtain a ``Quantizer``-protocol object."""

    bits: int = 3
    group_size: int = 128
    symmetric: bool = False
    damping: float = 0.01

    @property
    def effective_bits(self) -> float:
        side = 16.0 if self.symmetric else 32.0
        return self.bits + side / self.group_size

    def _rounder(self) -> UniformQuantizer:
        return UniformQuantizer(bits=self.bits, group_size=self.group_size,
                                symmetric=self.symmetric)

    def fake_quant_with_hessian(self, w: torch.Tensor,
                                h: torch.Tensor) -> torch.Tensor:
        """Quantize ``w`` (m, n) given input autocorrelation ``h``
        (m, m)."""
        base = self._rounder().quantize(w)
        uinv = _cholesky_inv_upper(h.float(), self.damping)
        return gptq_rows(w, uinv, base.scales, base.zeros, self.bits,
                         self.group_size, self.symmetric).to(w.dtype)

    def make_bound(self, h: torch.Tensor) -> "BoundGPTQ":
        return BoundGPTQ(self, h)


@dataclasses.dataclass(frozen=True)
class BoundGPTQ:
    """GPTQ with a baked-in Hessian, satisfying the Quantizer protocol."""

    inner: GPTQQuantizer
    hessian: torch.Tensor

    @property
    def effective_bits(self) -> float:
        return self.inner.effective_bits

    def fake_quant(self, w: torch.Tensor) -> torch.Tensor:
        return self.inner.fake_quant_with_hessian(w, self.hessian)

    def quantize(self, w: torch.Tensor) -> UniformPacked:
        return self.inner._rounder().quantize(self.fake_quant(w))

    def dequantize(self, packed: UniformPacked) -> torch.Tensor:
        return self.inner._rounder().dequantize(packed)


def hessian_from_activations(x: torch.Tensor) -> torch.Tensor:
    """H = Xᵀ X / N from calibration activations ``x`` (N, m)."""
    x = x.float()
    return div(x.T @ x, x.shape[0])
