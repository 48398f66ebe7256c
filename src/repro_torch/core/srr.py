"""Structured Residual Reconstruction — Algorithm 1 of the paper, split
variant, with identity scaling (port of ``repro/core/srr.py``):

  1. k* ← argmin_k ρ_k(W) ρ_{r−k}(E)       (one-shot random probe)
  2. L⁽¹⁾R⁽¹⁾ ← SVD_{k*}(W)                 (preserve)
  3. Q ← 𝒬(W − L⁽¹⁾R⁽¹⁾)                    (quantize the residual)
  4. E ← W − L⁽¹⁾R⁽¹⁾ − Q                   (induced quantization error)
  5. L⁽²⁾R⁽²⁾ ← SVD_{r−k*}(E)               (reconstruct)
  6. L ← [L⁽¹⁾ L⁽²⁾],  R ← [R⁽¹⁾; R⁽²⁾]

Activation-aware scalings S and the joint variant come with the
calibration pipeline. Steps 1 and 2/5 run under ``torch.profiler`` ranges
named ``srr.select_rank`` and ``srr.svd_factors`` (the quantizer marks
its own, ``mxint.*``), so a profile of the pass reads time by stage.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.profiler import record_function

from repro_torch.core.qer import Decomposition, _svd_factors
from repro_torch.core.rank_alloc import select_rank


def srr_decompose(w: torch.Tensor, quantizer, rank: int,
                  gen: Optional[torch.Generator], k: Optional[int] = None,
                  exact: bool = True) -> Decomposition:
    """SRR for one (m, n) weight used as ``y = x @ w``. ``k`` forces the
    split; ``exact`` takes full SVDs instead of randomized sketches."""
    w = w.float()
    if k is None:
        with record_function("srr.select_rank"):
            k = select_rank(w, rank, gen, exact=exact)
    if not 0 <= k <= rank:
        raise ValueError(f"k={k} outside budget r={rank}")
    with record_function("srr.svd_factors"):
        l1, r1 = _svd_factors(w, k, gen, exact)
    preserved = l1 @ r1 if k > 0 else torch.zeros_like(w)
    q = quantizer.fake_quant(w - preserved)
    e = w - preserved - q
    with record_function("srr.svd_factors"):
        l2, r2 = _svd_factors(e, rank - k, gen, exact)
    return Decomposition(q=q, l=torch.cat([l1, l2], dim=1),
                         r=torch.cat([r1, r2], dim=0), k=k)
