"""Rank-allocation criterion (paper §4.2, Eq. 5) — port of
``repro/core/rank_alloc.py`` with identity scaling (S = I).

``k* = argmin_{0≤k≤r} ρ_k(W) · ρ_{r−k}(E)`` with
``ρ_p(A) = 1 − Σ_{j≤p} σ_j(A)² / ‖A‖_F²`` and E a one-shot U[−1, 1]
probe standing in for the quantization error's spectrum.
"""
from __future__ import annotations

import torch

from repro_torch.core.svd import randomized_svd, singular_values


def rho_prefix(top_sv: torch.Tensor, frob_sq: torch.Tensor,
               r: int) -> torch.Tensor:
    """ρ_p for p = 0..r from the top-r singular values and the exact
    ‖A‖_F², clipped to [0, 1]."""
    sv = top_sv[:r]
    energy = torch.cat([torch.zeros((1,), dtype=sv.dtype, device=sv.device),
                        torch.cumsum(sv ** 2, dim=0)])
    return torch.clamp(1.0 - energy / torch.clamp(frob_sq, min=1e-30), 0.0, 1.0)


def select_rank(w: torch.Tensor, r: int, gen: torch.Generator,
                exact: bool = False, n_iter: int = 4) -> int:
    """Layer-wise k* (Algorithm 1 lines 1–2): exact SVDs, or randomized
    top-r sketches per App. A.4."""
    w = w.float()
    probe = torch.rand(w.shape, generator=gen, device=w.device) * 2.0 - 1.0
    if exact:
        sv_w, sv_e = singular_values(w), singular_values(probe)
    else:
        sv_w = randomized_svd(w, r, gen, n_iter=n_iter).s
        sv_e = randomized_svd(probe, r, gen, n_iter=n_iter).s
    rho_w = rho_prefix(sv_w, (w ** 2).sum(), r)
    rho_e = rho_prefix(sv_e, (probe ** 2).sum(), r)
    return int(torch.argmin(rho_w * rho_e.flip(0)))
