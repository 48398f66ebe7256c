"""QPEFT: SRR-initialized adapters + decoupled gradient scaling (§4.4;
port of ``repro/core/qpeft.py``).

The quantized backbone Q is frozen; the adapter (L, R) is trainable and
initialized from the SRR decomposition. The two component groups get
different treatment during fine-tuning:

  * preserved directions (columns L[:, :k], rows R[:k, :]) — gradients
    attenuated by γ ∈ (0, 1)                       (Eq. 7), or rank-wise
    by SGP's (1 − λ_i), λ_i = (α+1)σ_i / (ασ_i + σ_1)   (Eq. 8–9);
  * residual-reconstruction directions — unscaled.

It is a gradient transform (``repro_torch.optim`` applies it before the
Adam update); ``k`` is fixed per layer at init, the masks precomputed.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.qer import Decomposition
from repro_torch.core.srr import preserved_singular_values


class AdapterParams(NamedTuple):
    """Trainable adapter factors."""

    l: torch.Tensor  # (m, rank)
    r: torch.Tensor  # (rank, n)


class AdapterStatic(NamedTuple):
    """Frozen per-layer state: the backbone and the per-rank gradient
    scale g ∈ (0, 1]^rank (fixed γ or SGP, built once at init)."""

    q: torch.Tensor           # (m, n) frozen fake-quantized backbone
    grad_scale: torch.Tensor  # (rank,)
    k: int


def fixed_gamma_scale(rank: int, k: int, gamma: float,
                      device=None) -> torch.Tensor:
    """g_i = γ for i < k (preserved), 1 otherwise (Eq. 7)."""
    idx = torch.arange(rank, device=device)
    return torch.where(idx < k, gamma, 1.0).float()


def sgp_scale(dec: Decomposition, alpha: float = 5.0) -> torch.Tensor:
    """Rank-wise SGP scaling on the preserved block (Eq. 8–9): λ_i =
    (α+1)σ_i / (ασ_i + σ_1) over the preserved singular values; g_i =
    1 − λ_i for i < k, 1 for the residual block."""
    rank, k = dec.rank, dec.k
    g = torch.ones((rank,), dtype=torch.float32, device=dec.r.device)
    if k == 0:
        return g
    sigma = preserved_singular_values(dec)[:k]
    sigma1 = torch.clamp(sigma[0], min=1e-12)
    lam = torch.clamp((alpha + 1.0) * sigma / (alpha * sigma + sigma1),
                      0.0, 1.0)
    g[:k] = 1.0 - lam
    return g


def init_adapter(dec: Decomposition, mode: str = "gamma", gamma: float = 0.1,
                 alpha: float = 5.0) -> tuple[AdapterParams, AdapterStatic]:
    """The trainable/frozen split of an SRR (or QER) decomposition."""
    if mode == "gamma":
        g = fixed_gamma_scale(dec.rank, dec.k, gamma, dec.r.device)
    elif mode == "sgp":
        g = sgp_scale(dec, alpha)
    elif mode == "none":
        g = torch.ones((dec.rank,), dtype=torch.float32, device=dec.r.device)
    else:
        raise ValueError(f"unknown grad-scaling mode {mode!r}")
    return (AdapterParams(l=dec.l, r=dec.r),
            AdapterStatic(q=dec.q, grad_scale=g, k=dec.k))


def scale_adapter_grads(grads: AdapterParams,
                        static: AdapterStatic) -> AdapterParams:
    """The per-rank gradient scaling: ``l``'s columns and ``r``'s rows."""
    g = static.grad_scale
    return AdapterParams(l=grads.l * g[None, :], r=grads.r * g[:, None])


def adapter_matmul(x: torch.Tensor, params: AdapterParams,
                   static: AdapterStatic) -> torch.Tensor:
    """y = x Q + (x L) R — the QPEFT forward; Q receives no gradient."""
    y = x @ static.q.detach()
    return y + (x @ params.l) @ params.r


def tree_scale_grads(grads, statics):
    """:func:`scale_adapter_grads` over matching trees of adapters
    (dicts, lists and tuples with ``AdapterParams`` leaves)."""
    if isinstance(grads, AdapterParams):
        return scale_adapter_grads(grads, statics)
    if isinstance(grads, dict):
        return {k: tree_scale_grads(v, statics[k]) for k, v in grads.items()}
    if isinstance(grads, (list, tuple)):
        return type(grads)(tree_scale_grads(g, s)
                           for g, s in zip(grads, statics))
    return grads
