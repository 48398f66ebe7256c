"""K1 and K2: the fused MXINT Q + LR matmul, ``y = x·dequant(Q) + (x·L)·R``.

Port of ``repro/kernels/mxint_matmul.py`` (the Pallas kernels
``mxint_lowrank_matmul_fused_2d`` and ``mxint_lowrank_matmul_2d``) and of
the ``qlr_matmul`` dispatch in ``repro/kernels/ops.py``. The CUDA source
is ``csrc/mxint_matmul.cu``; its header says what bounds it and how.

:func:`qlr_matmul` is the entry point. For a CPU tensor it runs
:func:`qlr_matmul_plain`; for a CUDA tensor it launches K1 (x·L
accumulated in the kernel) when there are at most
``QLR_FUSED_MAX_ROWS`` rows and K2 (x·L precomputed by one small
``torch.matmul``) otherwise, or raises on an input the kernels do not
take. ``codes`` is the int8 container ``(K, N)`` or the packed4 uint8
container ``(K/2, N)``, which the kernels unpack in registers.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.constraints import (MXINT_BLOCK, QLR_COL_VEC,
                                             QLR_FUSED_MAX_ROWS, QLR_MAX_RANK,
                                             QLR_SPLIT_ROWS)
from repro_torch.quant.mxint import unpack_codes_4bit

# launches of each kernel since the last reset; a plain count per wrapper
LAUNCHES = {"qlr_fused": 0, "qlr": 0}


def dequant_blockwise(codes: torch.Tensor, scale: torch.Tensor,
                      dtype) -> torch.Tensor:
    """``(K, N)`` codes × per-block ``(K/B, N)`` scale → dense weight,
    by reshape-multiply (no repeated scale plane)."""
    k, n = codes.shape
    nb = scale.shape[0]
    return (codes.to(dtype).reshape(nb, k // nb, n)
            * scale.to(dtype)[:, None, :]).reshape(k, n)


def qlr_matmul_plain(x: torch.Tensor, codes: torch.Tensor,
                     scale: torch.Tensor, l: torch.Tensor,
                     r: torch.Tensor) -> torch.Tensor:
    """Plain version of K1 and K2: ``x (M, K) → y (M, N)`` in f32."""
    if codes.dtype == torch.uint8:
        codes = unpack_codes_4bit(codes)
    xf = x.float()
    y = xf @ dequant_blockwise(codes, scale, torch.float32)
    if l.shape[-1] > 0:
        y = y + (xf @ l.float()) @ r.float()
    return y


def _check(x, codes, scale, l, r, rank_rows: int) -> tuple[int, int, int]:
    """Raise on anything the kernels do not take; returns (K, N, rank)."""
    packed = codes.dtype == torch.uint8
    if codes.dtype not in (torch.int8, torch.uint8):
        raise TypeError(f"codes must be int8 or packed4 uint8, got {codes.dtype}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    for name, t in (("scale", scale), ("l", l), ("r", r)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    tensors = {"x": x, "codes": codes, "scale": scale, "l": l, "r": r}
    for name, t in tensors.items():
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    k = codes.shape[0] * (2 if packed else 1)
    n = codes.shape[1]
    rank = r.shape[0]
    if x.shape[-1] != k:
        raise ValueError(f"x has {x.shape[-1]} columns, codes hold {k} rows")
    if k % MXINT_BLOCK or scale.shape != (k // MXINT_BLOCK, n):
        raise ValueError(f"scale {tuple(scale.shape)} must be (K/{MXINT_BLOCK}, "
                         f"N) = ({k // MXINT_BLOCK}, {n}) with K % "
                         f"{MXINT_BLOCK} == 0")
    if n % QLR_COL_VEC:
        raise ValueError(f"N={n} must be a multiple of {QLR_COL_VEC}")
    if rank > QLR_MAX_RANK or r.shape != (rank, n) or l.shape[-1] != rank \
            or l.shape[0] != rank_rows:
        raise ValueError(f"low-rank factors l {tuple(l.shape)}, r "
                         f"{tuple(r.shape)} do not fit K={k}, N={n} (rank ≤ "
                         f"{QLR_MAX_RANK})")
    if codes.data_ptr() % 4 or scale.data_ptr() % 16:
        raise ValueError("codes must be 4-byte and scale 16-byte aligned")
    return k, n, rank


def qlr_fused_matmul(x: torch.Tensor, codes: torch.Tensor,
                     scale: torch.Tensor, l: torch.Tensor,
                     r: torch.Tensor) -> torch.Tensor:
    """Launch K1 on ``x (M, K)``: y (M, N) f32, x·L accumulated in the
    kernel's pass over K."""
    k, n, rank = _check(x, codes, scale, l, r, rank_rows=x.shape[-1])
    m = x.shape[0]
    splits = -(-k // QLR_SPLIT_ROWS)
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    part = torch.empty((splits, m, n), dtype=torch.float32, device=x.device)
    xl_part = torch.empty((splits, m, max(rank, 1)), dtype=torch.float32,
                          device=x.device)
    fn = _build.function("mxint_matmul", "qlr_fused_launch", 8, 6)
    err = fn(x.data_ptr(), codes.data_ptr(), scale.data_ptr(), l.data_ptr(),
             r.data_ptr(), y.data_ptr(), part.data_ptr(), xl_part.data_ptr(),
             m, k, n, rank, int(x.dtype == torch.bfloat16),
             int(codes.dtype == torch.uint8),
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "qlr_fused_launch (K1)")
    LAUNCHES["qlr_fused"] += 1
    return y


def qlr_xl_matmul(x: torch.Tensor, codes: torch.Tensor, scale: torch.Tensor,
                  xl: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Launch K2 on ``x (M, K)`` with the precomputed sliver ``xl = x·L``
    (M, rank) f32: y (M, N) f32."""
    k, n, rank = _check(x, codes, scale, xl, r, rank_rows=x.shape[0])
    m = x.shape[0]
    splits = -(-k // QLR_SPLIT_ROWS)
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    part = torch.empty((splits, m, n), dtype=torch.float32, device=x.device)
    fn = _build.function("mxint_matmul", "qlr_launch", 7, 6)
    err = fn(x.data_ptr(), codes.data_ptr(), scale.data_ptr(), xl.data_ptr(),
             r.data_ptr(), y.data_ptr(), part.data_ptr(),
             m, k, n, rank, int(x.dtype == torch.bfloat16),
             int(codes.dtype == torch.uint8),
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "qlr_launch (K2)")
    LAUNCHES["qlr"] += 1
    return y


def qlr_matmul(x: torch.Tensor, codes: torch.Tensor, scale: torch.Tensor,
               l: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """``y = x·dequant(codes, scale) + (x·L)·R`` over any leading dims of
    ``x``; returns ``x.dtype``. CPU tensors take the plain version; CUDA
    tensors take K1 (rows ≤ ``QLR_FUSED_MAX_ROWS``) or K2."""
    k = x.shape[-1]
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k)
    if x.device.type == "cpu":
        y = qlr_matmul_plain(x2, codes, scale, l, r)
    elif x2.shape[0] <= QLR_FUSED_MAX_ROWS:
        y = qlr_fused_matmul(x2.contiguous(), codes, scale, l, r)
    else:
        xl = x2.float() @ l.float()
        y = qlr_xl_matmul(x2.contiguous(), codes, scale, xl, r)
    return y.reshape(*lead, y.shape[-1]).to(x.dtype)
