"""Baseline QER methods: W ≈ Q + LR with the full rank budget on the
residual (port of ``repro/core/qer.py``: ZeroQuant-V2 / LQER /
QERA-approx / QERA-exact, the baseline family of the paper, §2).

All variants share one construction (Eq. 1):

    Q  = 𝒬(W)
    LR = S⁻¹ · SVD_r( S (W − Q) )

and differ only in S (see :mod:`repro_torch.core.scaling`). The
decomposition record and the truncated-SVD factor helper serve SRR too.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.scaling import IDENTITY, Scaling
from repro_torch.core.svd import exact_svd, randomized_svd


class Decomposition(NamedTuple):
    """W ≈ q + l @ r with ``k`` leading adapter ranks "preserved"; ``q``
    is the fake-quantized backbone in weight space."""

    q: torch.Tensor   # (m, n)
    l: torch.Tensor   # (m, rank)
    r: torch.Tensor   # (rank, n)
    k: int

    @property
    def rank(self) -> int:
        return self.l.shape[1]

    def reconstruct(self) -> torch.Tensor:
        return self.q + self.l @ self.r


def scaled_error(w: torch.Tensor, dec: Decomposition,
                 scaling: Scaling) -> torch.Tensor:
    """‖S(W − Q − LR)‖_F — the paper's reconstruction objective."""
    return torch.linalg.norm(scaling.apply(w.float() - dec.reconstruct()))


def weight_error(w: torch.Tensor, dec: Decomposition) -> torch.Tensor:
    """‖W − Q − LR‖_F (the S = I error)."""
    return torch.linalg.norm(w.float() - dec.reconstruct())


def _svd_factors(a: torch.Tensor, rank: int, gen: Optional[torch.Generator],
                 exact: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """L = U_r, R = Σ_r V_rᵀ of a rank-``rank`` truncation of ``a``."""
    m, n = a.shape
    if rank <= 0:
        return (torch.zeros((m, 0), device=a.device),
                torch.zeros((0, n), device=a.device))
    dec = exact_svd(a, rank) if exact or gen is None \
        else randomized_svd(a, rank, gen)
    return dec.factors()


def qer_decompose(w: torch.Tensor, quantizer, rank: int,
                  gen: Optional[torch.Generator] = None, exact: bool = True,
                  *, scaling: Scaling = IDENTITY) -> Decomposition:
    """Activation-aware QER (Eq. 1); k = 0 by construction. ``gen``
    drives the randomized SVD unless ``exact``."""
    w = w.float()
    q = quantizer.fake_quant(w)
    lu, rv = _svd_factors(scaling.apply(w - q), rank, gen, exact)
    return Decomposition(q=q, l=scaling.apply_inv(lu), r=rv, k=0)


def w_only(w: torch.Tensor, quantizer, rank: int) -> Decomposition:
    """Quantization-only baseline: a zero adapter of width ``rank``."""
    w = w.float()
    m, n = w.shape
    return Decomposition(q=quantizer.fake_quant(w),
                         l=torch.zeros((m, rank), device=w.device),
                         r=torch.zeros((rank, n), device=w.device), k=0)
