"""Rank-allocation criterion (paper §4.2, Eq. 5) — port of
``repro/core/rank_alloc.py``.

``k* = argmin_{0≤k≤r} ρ_k(SW) · ρ_{r−k}(SE)`` with
``ρ_p(A) = 1 − Σ_{j≤p} σ_j(A)² / ‖A‖_F²`` and E a one-shot U[−1, 1]
probe standing in for the quantization error's spectrum. Only the top-r
singular values of SW and SE are needed; ‖·‖_F² is exact, so ρ is exact
even with a truncated spectrum.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core.scaling import IDENTITY, Scaling
from repro_torch.core.svd import randomized_svd, singular_values


class RankSelection(NamedTuple):
    k_star: int
    objective: torch.Tensor  # (r+1,) surrogate values over k
    rho_w: torch.Tensor      # (r+1,) ρ_k(SW), k = 0..r
    rho_e: torch.Tensor      # (r+1,) ρ_p(SE), p = 0..r


def rho_prefix(top_sv: torch.Tensor, frob_sq: torch.Tensor,
               r: int) -> torch.Tensor:
    """ρ_p for p = 0..r from the top-r singular values and the exact
    ‖A‖_F², clipped to [0, 1]."""
    sv = top_sv[:r]
    energy = torch.cat([torch.zeros((1,), dtype=sv.dtype, device=sv.device),
                        torch.cumsum(sv ** 2, dim=0)])
    return torch.clamp(1.0 - energy / torch.clamp(frob_sq, min=1e-30), 0.0, 1.0)


def sample_probe(gen: Optional[torch.Generator], shape: Tuple[int, int],
                 device=None) -> torch.Tensor:
    """E_ij ~ U[−1, 1) in f32 on ``device`` — Algorithm 1 line 1. It is
    drawn where ``gen`` lives and moved, so a CPU generator gives the
    card the CPU's probe."""
    where = gen.device if gen is not None else device
    return (torch.rand(shape, generator=gen, device=where) * 2.0
            - 1.0).to(device)


def select_rank(w: torch.Tensor, r: int, gen: Optional[torch.Generator],
                exact: bool = False, n_iter: int = 4, *,
                scaling: Scaling = IDENTITY) -> RankSelection:
    """Layer-wise k* (Algorithm 1 lines 1–2): the probe and, unless
    ``exact``, the randomized top-r sketches (App. A.4) draw from
    ``gen``."""
    w = w.float()
    probe = sample_probe(gen, w.shape, w.device)
    sw, se = scaling.apply(w), scaling.apply(probe)
    if exact:
        sv_w, sv_e = singular_values(sw), singular_values(se)
    else:
        sv_w = randomized_svd(sw, r, gen, n_iter=n_iter).s
        sv_e = randomized_svd(se, r, gen, n_iter=n_iter).s
    rho_w = rho_prefix(sv_w, (sw ** 2).sum(), r)
    rho_e = rho_prefix(sv_e, (se ** 2).sum(), r)
    objective = rho_w * rho_e.flip(0)
    return RankSelection(int(torch.argmin(objective)), objective, rho_w,
                         rho_e)


def true_reconstruction_error(w: torch.Tensor, quantizer, r: int, k: int, *,
                              scaling: Scaling = IDENTITY) -> torch.Tensor:
    """Brute-force L(k) = ‖SE_k − SVD_{r−k}(SE_k)‖_F (Eq. 3, the oracle):
    preserve the exact top-k of SW, quantize the residual, and take the
    energy of SE_k's spectrum past its top r − k. One full SVD and one
    quantization per k, the cost the surrogate avoids (Fig. 2)."""
    w = w.float()
    if k > 0:
        u, s, vt = torch.linalg.svd(scaling.apply(w), full_matrices=False)
        preserved = scaling.apply_inv((u[:, :k] * s[:k]) @ vt[:k])
    else:
        preserved = torch.zeros_like(w)
    e_k = w - preserved - quantizer.fake_quant(w - preserved)
    sv = singular_values(scaling.apply(e_k))
    return torch.sqrt((sv[r - k:] ** 2).sum())
