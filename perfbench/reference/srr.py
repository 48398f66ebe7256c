"""The plain reference of the offline pass for one matrix: qera-exact
scaling, SRR's rank split, MXINT quantization of the residual and the
low-rank factors (the paper's Algorithm 1, written from its equations).

* S = R^{1/2} of the input autocorrelation R = E[x xᵀ] (one ``eigh``,
  eigenvalues floored at 1e-4 of the largest), and S⁻¹ alike;
* k* = argmin_k ρ_k(SW)·ρ_{r−k}(SE), ρ_p the energy share past the top p
  singular values, E a U[−1, 1) probe;
* L₁R₁ = S⁻¹·SVD_k*(SW); Q = MXINT(W − L₁R₁), each 32-row block's
  exponent ceil(log2(amax / qmax)) taken exactly, codes rounded half to
  even; L₂R₂ = S⁻¹·SVD_{r−k*}(S(W − L₁R₁ − Q)); L = [L₁ L₂], R = [R₁; R₂].

The top singular triplets come from randomized SVD (4 power iterations
with QR between them, a sketch of 3r columns), drawn from a generator
seeded as the configuration seeds each matrix's, in the order the
algorithm draws them: the probe, the two spectra's sketches, then the
two factors' sketches. ``dtype`` is the precision of every product; the
decompositions (``eigh``, QR, SVD) run in f32 whatever it is.
"""
from __future__ import annotations

from typing import Dict

import torch


def scaling(autocorr: torch.Tensor, count: int, eps: float = 1e-4):
    """(S, S⁻¹) of the autocorrelation sum ``autocorr`` over ``count``
    rows."""
    r = autocorr / max(count, 1)
    r = 0.5 * (r + r.T)
    evals, evecs = torch.linalg.eigh(r.float())
    half = torch.maximum(evals, eps * evals[-1].clamp_min(1e-12)).sqrt()
    return (evecs * half) @ evecs.T, (evecs / half) @ evecs.T


def _rsvd(a: torch.Tensor, rank: int, gen: torch.Generator, dtype):
    m, n = a.shape
    width = min(3 * rank, min(m, n))
    omega = torch.randn((n, width), generator=gen, device=a.device)
    ad = a.to(dtype)
    y = (ad @ omega.to(dtype)).float()
    for _ in range(4):
        q, _ = torch.linalg.qr(y)
        z, _ = torch.linalg.qr((ad.T @ q.to(dtype)).float())
        y = (ad @ z.to(dtype)).float()
    q, _ = torch.linalg.qr(y)
    ub, s, vt = torch.linalg.svd((q.to(dtype).T @ ad).float(),
                                 full_matrices=False)
    return (q @ ub)[:, :rank], s[:rank], vt[:rank]


def _rho(sv: torch.Tensor, frob: torch.Tensor, r: int) -> torch.Tensor:
    e = torch.cat([sv.new_zeros(1), torch.cumsum(sv[:r] ** 2, 0)])
    return torch.clamp(1.0 - e / frob.clamp_min(1e-30), 0.0, 1.0)


def mxint(w: torch.Tensor, bits: int, block: int):
    """(codes int8, exponents int8) of ``w`` (rows a multiple of the
    block)."""
    m, n = w.shape
    qmax = 2 ** (bits - 1) - 1
    blocks = w.float().reshape(m // block, block, n)
    amax = blocks.abs().amax(dim=1)
    safe = torch.where(amax > 0, amax, torch.ones_like(amax))
    mant, ex = torch.frexp(safe / torch.full_like(safe, qmax))
    exp = torch.where(mant == 0.5, ex - 1, ex).clamp(-127, 127)
    codes = torch.clamp(torch.round(blocks / torch.exp2(exp.float())[:, None]),
                        -qmax - 1, qmax)
    codes = torch.where(amax[:, None] > 0, codes, torch.zeros_like(codes))
    return codes.reshape(m, n).to(torch.int8), exp.to(torch.int8)


def srr(w: torch.Tensor, s: torch.Tensor, s_inv: torch.Tensor, rank: int,
        bits: int, block: int, gen: torch.Generator,
        dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """One matrix's pass: {"k": k*, "codes", "exponents", "l", "r"}."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        w = w.float()
        mm = lambda a, b: (a.to(dtype) @ b.to(dtype)).float()  # noqa: E731
        probe = torch.rand(w.shape, generator=gen, device=w.device) * 2 - 1
        sw, se = mm(s, w), mm(s, probe)
        sv_w = _rsvd(sw, rank, gen, dtype)[1]
        sv_e = _rsvd(se, rank, gen, dtype)[1]
        obj = _rho(sv_w, (sw ** 2).sum(), rank) \
            * _rho(sv_e, (se ** 2).sum(), rank).flip(0)
        k = int(torch.argmin(obj))
        m, n = w.shape
        l1 = r1 = None
        preserved = torch.zeros_like(w)
        if k:
            u, sg, vt = _rsvd(sw, k, gen, dtype)
            l1, r1 = mm(s_inv, u), sg[:, None] * vt
            preserved = mm(l1, r1)
        codes, exps = mxint(w - preserved, bits, block)
        q = (codes.float().reshape(m // block, block, n)
             * torch.exp2(exps.float())[:, None]).reshape(m, n)
        ls, rs = [], []
        if k:
            ls.append(l1)
            rs.append(r1)
        if rank - k:
            u, sg, vt = _rsvd(mm(s, w - preserved - q), rank - k, gen, dtype)
            ls.append(mm(s_inv, u))
            rs.append(sg[:, None] * vt)
        return {"k": k, "codes": codes, "exponents": exps,
                "l": torch.cat(ls, 1), "r": torch.cat(rs, 0)}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
