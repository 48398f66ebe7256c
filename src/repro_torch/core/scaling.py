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


# cuSOLVER's syevd, behind torch.linalg.eigh on the card, refuses wider
# matrices: on an H100 (CUDA 12.8) it ran a 24,576-wide f32 matrix in 7.3
# s and raised CUSOLVER_STATUS_INVALID_VALUE at 27,392 (qwen1.5-32b's
# d_ff), in f32 and f64 alike.
EIGH_MAX_WIDTH = 24_576
# columns past the rank bound in the range route's sketch
RANGE_OVERSAMPLE = 16


def autocorr_scaling_from_moments(r: torch.Tensor, eps: float = 1e-4,
                                  rows: Optional[int] = None) -> Scaling:
    """qera-exact from an autocorrelation matrix R = E[xxᵀ]: its symmetric
    square root and inverse from one eigendecomposition, eigenvalues
    floored at ``eps·λ_max`` so S stays invertible (the paper requires
    an invertible S).

    On the card a matrix wider than ``EIGH_MAX_WIDTH`` takes
    :func:`range_autocorr_scaling` when ``rows``, the count of samples R
    averages, is below its width; otherwise it raises."""
    r = 0.5 * (r + r.T)
    if r.is_cuda and r.shape[0] > EIGH_MAX_WIDTH:
        if rows is None or rows >= r.shape[0]:
            raise ValueError(
                f"qera-exact of a {r.shape[0]}-wide autocorrelation: the "
                f"card's eigh takes at most {EIGH_MAX_WIDTH}, and the range "
                f"route needs fewer samples than that ({rows})")
        return range_autocorr_scaling(r, rows, eps)
    evals, evecs = torch.linalg.eigh(r.float())
    floor = eps * evals[-1].clamp_min(1e-12)
    half = torch.maximum(evals, floor).sqrt()
    return Scaling(dense=(evecs * half) @ evecs.T,
                   dense_inv=(evecs / half) @ evecs.T)


def range_autocorr_scaling(r: torch.Tensor, rows: int,
                           eps: float = 1e-4) -> Scaling:
    """The S of :func:`autocorr_scaling_from_moments` for an R averaged
    over ``rows`` samples, fewer than its width m, without an m-wide
    eigendecomposition: R's rank is at most ``rows``, so a basis Q of
    R·Ω (Ω Gaussian, ``rows + RANGE_OVERSAMPLE`` columns, seed 0) spans
    its range, the eigenpairs (λ, V) of QᵀRQ are R's nonzero ones, and
    every direction outside takes the floor:
    S = √f·I + V·diag(√max(λ, f) − √f)·Vᵀ with f = ``eps``·λ_max, and
    S⁻¹ alike. In f64, so the sketch resolves every eigenvalue above the
    floor; returns f32, as the eigh route does."""
    m = r.shape[0]
    k = min(m, rows + RANGE_OVERSAMPLE)
    gen = torch.Generator(device=r.device).manual_seed(0)
    r64 = r.double()
    omega = torch.randn((m, k), generator=gen, device=r.device,
                        dtype=torch.float64)
    q, _ = torch.linalg.qr(r64 @ omega)
    evals, w = torch.linalg.eigh(q.T @ (r64 @ q))
    del r64, omega
    v = q @ w
    floor = eps * evals[-1].clamp_min(1e-12)
    half = torch.maximum(evals, floor).sqrt()
    base = floor.sqrt()

    def build(d: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
        out = (v * (d - shift)) @ v.T
        out.diagonal().add_(shift)
        return out.float()

    return Scaling(dense=build(half, base), dense_inv=build(1.0 / half,
                                                            1.0 / base))


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
