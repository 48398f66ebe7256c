"""Activation-aware scaling matrices S for QER/SRR (port of
``repro/core/scaling.py``).

Each QER variant is defined by its choice of S (§2 of the paper):

  * ``identity``    — ZeroQuant-V2:     S = I
  * ``lqer``        — LQER:             S = diag(mean |x_j|)        (heuristic)
  * ``qera-approx`` — QERA-approx:      S = diag(sqrt(E[x_j²]))     (heuristic)
  * ``qera-exact``  — QERA-exact:       S = (E[x xᵀ])^{1/2}         (exact)

The exact variant minimizes the output-space error ``E‖x(W − Ŵ)‖²``,
since ``E‖xΔ‖² = ‖S Δ‖_F²`` with S the symmetric square root of the
input autocorrelation. A :class:`Scaling` applies S and S⁻¹ without
materializing an m×m matrix for the diagonal kinds.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

SCALING_KINDS = ("identity", "lqer", "qera-approx", "qera-exact")


@dataclasses.dataclass(frozen=True)
class Scaling:
    """S as either a diagonal vector or a dense symmetric matrix."""

    diag: Optional[torch.Tensor] = None       # (m,) — used when dense is None
    dense: Optional[torch.Tensor] = None      # (m, m)
    dense_inv: Optional[torch.Tensor] = None  # (m, m)

    @property
    def is_identity(self) -> bool:
        return self.diag is None and self.dense is None

    def apply(self, w: torch.Tensor) -> torch.Tensor:
        """S @ w."""
        if self.dense is not None:
            return self.dense @ w
        if self.diag is not None:
            return self.diag[:, None] * w
        return w

    def apply_inv(self, w: torch.Tensor) -> torch.Tensor:
        """S⁻¹ @ w."""
        if self.dense is not None:
            return self.dense_inv @ w
        if self.diag is not None:
            return w / self.diag[:, None]
        return w


IDENTITY = Scaling()


def identity_scaling() -> Scaling:
    return IDENTITY


def lqer_scaling(x: torch.Tensor, eps: float = 1e-6) -> Scaling:
    """diag of mean absolute activation per input channel. x: (N, m)."""
    return Scaling(diag=x.float().abs().mean(dim=0).clamp_min(eps))


def qera_approx_scaling(x: torch.Tensor, eps: float = 1e-6) -> Scaling:
    """diag of root-mean-square activation per input channel."""
    return Scaling(diag=x.float().square().mean(dim=0).sqrt().clamp_min(eps))


def autocorr_scaling_from_moments(r: torch.Tensor,
                                  eps: float = 1e-4) -> Scaling:
    """qera-exact from an autocorrelation matrix R = E[xxᵀ]: its symmetric
    square root and inverse from one eigendecomposition, eigenvalues
    floored at ``eps·λ_max`` so S stays invertible (the paper requires
    an invertible S)."""
    r = 0.5 * (r + r.T)
    evals, evecs = torch.linalg.eigh(r.float())
    floor = eps * evals[-1].clamp_min(1e-12)
    half = torch.maximum(evals, floor).sqrt()
    return Scaling(dense=(evecs * half) @ evecs.T,
                   dense_inv=(evecs / half) @ evecs.T)


def qera_exact_scaling(x: torch.Tensor, eps: float = 1e-4) -> Scaling:
    """Symmetric square root of the input autocorrelation E[x xᵀ] of the
    (N, m) sample ``x``."""
    x = x.float()
    return autocorr_scaling_from_moments((x.T @ x) / x.shape[0], eps)


def make_scaling(kind: str, x: Optional[torch.Tensor] = None) -> Scaling:
    """Factory. ``x`` is the (N, m) calibration activation sample."""
    if kind == "identity":
        return identity_scaling()
    if x is None:
        raise ValueError(f"scaling kind {kind!r} needs calibration activations")
    if kind == "lqer":
        return lqer_scaling(x)
    if kind == "qera-approx":
        return qera_approx_scaling(x)
    if kind == "qera-exact":
        return qera_exact_scaling(x)
    raise ValueError(f"unknown scaling kind {kind!r}; options: {SCALING_KINDS}")
