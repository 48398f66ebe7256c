"""Truncated + randomized SVD (Halko et al., 2011) — port of
``repro/core/svd.py``.

The paper computes only the top-r singular components, with randomized
SVD (``n_iter = 4`` power iterations, oversampling of twice the target
rank; App. A.4) and QR re-orthonormalization between power iterations.
The sketch draws from a ``torch.Generator``, so its numbers differ from
the JAX package's; ``exact_svd`` is the oracle both packages agree on.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class TruncatedSVD(NamedTuple):
    u: torch.Tensor   # (m, r)
    s: torch.Tensor   # (r,)
    vt: torch.Tensor  # (r, n)

    def factors(self) -> tuple[torch.Tensor, torch.Tensor]:
        """Paper's factorization: L = U_r (orthonormal), R = Σ_r V_rᵀ."""
        return self.u, self.s[:, None] * self.vt


def exact_svd(a: torch.Tensor, rank: int) -> TruncatedSVD:
    """Exact truncated SVD via the full decomposition (oracle path)."""
    u, s, vt = torch.linalg.svd(a.float(), full_matrices=False)
    return TruncatedSVD(u[:, :rank], s[:rank], vt[:rank])


def singular_values(a: torch.Tensor) -> torch.Tensor:
    return torch.linalg.svdvals(a.float())


def randomized_svd(a: torch.Tensor, rank: int, gen: torch.Generator,
                   n_iter: int = 4,
                   oversample: Optional[int] = None) -> TruncatedSVD:
    """Randomized range-finder SVD; sketch width = rank + oversample."""
    m, n = a.shape
    a = a.float()
    if oversample is None:
        oversample = 2 * rank
    width = min(rank + oversample, min(m, n))
    omega = torch.randn((n, width), generator=gen, device=a.device)
    y = a @ omega
    for _ in range(n_iter):
        q, _ = torch.linalg.qr(y)
        z, _ = torch.linalg.qr(a.T @ q)
        y = a @ z
    q, _ = torch.linalg.qr(y)
    ub, s, vt = torch.linalg.svd(q.T @ a, full_matrices=False)
    return TruncatedSVD((q @ ub)[:, :rank], s[:rank], vt[:rank])
