"""The Q + LR decomposition record and the truncated-SVD factor helper
(port of the parts of ``repro/core/qer.py`` that SRR uses)."""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

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
