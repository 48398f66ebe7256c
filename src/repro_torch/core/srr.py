"""Structured Residual Reconstruction — Algorithm 1 of the paper (port
of ``repro/core/srr.py``). Preserve-then-quantize with an explicit rank
split:

  1. k* ← argmin_k ρ_k(SW) ρ_{r−k}(SE)       (one-shot random probe)
  2. L⁽¹⁾R⁽¹⁾ ← S⁻¹ SVD_{k*}(SW)              (preserve)
  3. Q ← 𝒬(W − L⁽¹⁾R⁽¹⁾)                      (quantize the residual)
  4. E ← W − L⁽¹⁾R⁽¹⁾ − Q                     (induced quantization error)
  5. L⁽²⁾R⁽²⁾ ← S⁻¹ SVD_{r−k*}(SE)            (reconstruct)
  6. L ← [L⁽¹⁾ L⁽²⁾],  R ← [R⁽¹⁾; R⁽²⁾]

``variant="joint"`` is the paper's Eq. 6: after the preserve-quantize
step one rank-r SVD of S(W − Q) replaces steps 5–6 (optimal for a fixed
Q by Eckart–Young). Step 1 and the SVDs of 2 and 5 run under
``torch.profiler`` ranges named ``srr.select_rank`` and
``srr.svd_factors``; building S runs under ``srr.scaling``
(``core/api.py``) and the quantizer marks its own (``mxint.*``), so a
profile of the pass reads time by stage.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.profiler import record_function

from repro_torch.core.qer import Decomposition, _svd_factors
from repro_torch.core.rank_alloc import RankSelection, select_rank
from repro_torch.core.scaling import IDENTITY, Scaling


class SRRResult(NamedTuple):
    """The decomposition and the rank selection that chose its split
    (``None`` when k was forced); reads as its decomposition."""

    decomposition: Decomposition
    selection: Optional[RankSelection]

    q = property(lambda self: self.decomposition.q)
    l = property(lambda self: self.decomposition.l)
    r = property(lambda self: self.decomposition.r)
    k = property(lambda self: self.decomposition.k)
    rank = property(lambda self: self.decomposition.rank)

    def reconstruct(self) -> torch.Tensor:
        return self.decomposition.reconstruct()


def srr_decompose(w: torch.Tensor, quantizer, rank: int,
                  gen: Optional[torch.Generator], k: Optional[int] = None,
                  exact: bool = True, *, scaling: Scaling = IDENTITY,
                  variant: str = "split") -> SRRResult:
    """SRR for one (m, n) weight used as ``y = x @ w``. ``k`` forces the
    split; ``exact`` takes full SVDs instead of randomized sketches drawn
    from ``gen``; ``variant`` is ``"split"`` (Algorithm 1) or ``"joint"``
    (Eq. 6)."""
    if variant not in ("split", "joint"):
        raise ValueError(f"unknown SRR variant {variant!r}")
    w = w.float()
    selection = None
    if k is None:
        with record_function("srr.select_rank"):
            selection = select_rank(w, rank, gen, exact=exact,
                                    scaling=scaling)
        k = selection.k_star
    if not 0 <= k <= rank:
        raise ValueError(f"k={k} outside budget r={rank}")
    with record_function("srr.svd_factors"):
        l1s, r1 = _svd_factors(scaling.apply(w), k, gen, exact)
    l1 = scaling.apply_inv(l1s)
    preserved = l1 @ r1 if k > 0 else torch.zeros_like(w)
    q = quantizer.fake_quant(w - preserved)
    if variant == "split":
        e = w - preserved - q
        with record_function("srr.svd_factors"):
            l2s, r2 = _svd_factors(scaling.apply(e), rank - k, gen, exact)
        l, r = torch.cat([l1, scaling.apply_inv(l2s)], dim=1), \
            torch.cat([r1, r2], dim=0)
    else:
        with record_function("srr.svd_factors"):
            ls, r = _svd_factors(scaling.apply(w - q), rank, gen, exact)
        l = scaling.apply_inv(ls)
    return SRRResult(Decomposition(q=q, l=l, r=r, k=k), selection)


def preserved_singular_values(dec: Decomposition) -> torch.Tensor:
    """σ_i of the adapter rows (R = Σ Vᵀ, so the row norms of R are the
    components' singular values — what SGP gradient scaling reads)."""
    return torch.linalg.norm(dec.r, dim=1)
