"""K7: MXINT block quantization, ``w (M, N) → (codes, exponents)``.

Port of ``repro/kernels/mxint_quantize.py`` (the Pallas kernel
``mxint_quantize_2d``) and of the ``mxint_quantize`` dispatch in
``repro/kernels/ops.py``. The CUDA source is ``csrc/mxint_quantize.cu``;
its header says what bounds it and how it stays exact.

:func:`mxint_quantize` is the entry point: for a CPU tensor it runs
:func:`mxint_quantize_plain`, for a CUDA tensor it launches K7 or raises
on an input the kernel does not take. Rows must already be a multiple
of the block: ``quant.mxint.MXIntQuantizer.quantize`` pads them.
:func:`mxint_quantize_plan` picks K7's launch: the register path's
persistent grid, or the scalar path (a column a thread) for a misaligned
``w``, an N that is not a multiple of 4 or too few columns to fill the
card.

The exponent is ``ceil(log2(amax / qmax))`` computed exactly, from the
binary exponent of the f32 quotient (:func:`ceil_log2`), not from a
rounded ``log2``: a ``log2`` that rounds to nearest returns the integer
``k`` for quotients a few ulps above ``2^k``, and its ceiling is then
one too small.
"""
from __future__ import annotations

from collections import Counter
from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.constraints import (
    MXINT_ALIGN, MXINT_BLOCK, MXINT_BLOCKS_PER_SM, MXINT_MAX_BITS,
    MXINT_MAX_ITEMS, MXINT_MIN_BITS, MXINT_PATH_REGISTERS, MXINT_PATH_SCALAR,
    MXINT_THREADS, MXINT_VEC, runs_plain)

# launches since the last reset; a plain count per wrapper, and K7's by
# the (M, N) it quantized
LAUNCHES = {"mxint_quantize": 0}
LAUNCH_SHAPES: Counter = Counter()

MAX_EXPONENT = 127          # int8 exponents, clipped like the reference


def ceil_log2(q: torch.Tensor) -> torch.Tensor:
    """Exact ``ceil(log2(q))`` of positive finite f32 values, as int32:
    ``q = m·2^x`` with ``m`` in [0.5, 1) gives ``x - 1`` when ``m`` is
    0.5 (``q`` a power of two) and ``x`` otherwise."""
    mant, ex = torch.frexp(q)
    return torch.where(mant == 0.5, ex - 1, ex)


def mxint_quantize_plain(w: torch.Tensor, bits: int,
                         block: int = MXINT_BLOCK
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K7: ``w (M, N)`` with ``M % block == 0`` →
    (codes int8 (M, N), exponents int8 (M/block, N))."""
    m, n = w.shape
    qmax = 2 ** (bits - 1) - 1
    blocks = w.float().reshape(m // block, block, n)
    amax = blocks.abs().amax(dim=1)                     # (nb, n)
    safe = torch.where(amax > 0, amax, torch.ones_like(amax))
    # divide by a tensor: a Python scalar divisor may become a multiply
    # by its rounded reciprocal on CUDA, which is not the IEEE quotient
    exp = ceil_log2(safe / torch.full_like(safe, qmax)).clamp(
        -MAX_EXPONENT, MAX_EXPONENT)
    scale = torch.exp2(exp.float())[:, None, :]
    codes = torch.clamp(torch.round(blocks / scale), -qmax - 1, qmax)
    codes = torch.where(amax[:, None, :] > 0, codes, torch.zeros_like(codes))
    return codes.reshape(m, n).to(torch.int8), exp.to(torch.int8)


class QuantizePlan(NamedTuple):
    """K7's launch for one ``(m, n)``: ``path`` (``constraints.MXINT_PATH_*``),
    the persistent ``grid`` of ``MXINT_THREADS``-thread blocks, the
    ``items`` it walks (register-path column quads or scalar-path columns,
    each of one 32-row block), and the ``tail_cols`` the scalar path takes
    (all or none)."""
    path: int
    grid: int
    items: int
    tail_cols: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _check_shape(m: int, n: int) -> None:
    if m < MXINT_BLOCK or m % MXINT_BLOCK or n < 1:
        raise ValueError(f"w has {m} rows: K7 takes a positive multiple of "
                         f"{MXINT_BLOCK} (pad first) and at least one column")
    if n > MXINT_MAX_ITEMS // (m // MXINT_BLOCK):
        raise ValueError(f"w ({m}, {n}) has more than {MXINT_MAX_ITEMS} "
                         f"(32-row block, column) pairs: K7 counts them in "
                         f"int32")


def mxint_quantize_plan(m: int, n: int, sms: int,
                        aligned: bool = True) -> QuantizePlan:
    """The launch of K7 on an ``(m, n)`` f32 ``w`` on a card with ``sms``
    SMs; ``aligned``: w's address is 16-byte aligned. The register path
    takes ``w`` when ``aligned`` and ``n`` is a multiple of 4: one thread
    per (32-row block, four columns), 64-thread blocks, as many as the
    items need up to four an SM, each thread walking items a grid apart.
    Otherwise, and where there are fewer quads than one block an SM would
    take (the router's 2048×64), every column takes the scalar path in the
    same launch: one thread per (32-row block, column), on the same grid
    rule. Raises ``ValueError`` on a shape K7 does not take."""
    _check_shape(m, n)
    if sms < 1:
        raise ValueError(f"sms={sms} must be positive")
    nb = m // MXINT_BLOCK
    quads = nb * (n // MXINT_VEC)
    if aligned and n % MXINT_VEC == 0 and quads >= sms * MXINT_THREADS:
        path, items, tail = MXINT_PATH_REGISTERS, quads, 0
    else:
        path, items, tail = MXINT_PATH_SCALAR, nb * n, n
    grid = min(_cdiv(items, MXINT_THREADS), sms * MXINT_BLOCKS_PER_SM)
    return QuantizePlan(path, grid, items, tail)


def mxint_quantize_cuda(w: torch.Tensor, bits: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K7 on a contiguous f32 CUDA ``w (M, N)``, ``M % 32 == 0``,
    with :func:`mxint_quantize_plan`'s plan for it."""
    if w.dtype != torch.float32:
        raise TypeError(f"w must be float32, got {w.dtype}")
    if w.ndim != 2 or not w.is_contiguous():
        raise ValueError(f"w must be a contiguous 2-D tensor, got shape "
                         f"{tuple(w.shape)}")
    m, n = w.shape
    _check_shape(m, n)
    if not MXINT_MIN_BITS <= bits <= MXINT_MAX_BITS:
        raise ValueError(f"bits={bits} outside [{MXINT_MIN_BITS}, "
                         f"{MXINT_MAX_BITS}]")
    if w.device.type != "cuda":
        raise ValueError(f"K7 runs on a CUDA tensor, not on {w.device}")
    plan = mxint_quantize_plan(m, n, _build.sm_count(w.device.index or 0),
                               w.data_ptr() % MXINT_ALIGN == 0)
    codes = torch.empty((m, n), dtype=torch.int8, device=w.device)
    exps = torch.empty((m // MXINT_BLOCK, n), dtype=torch.int8,
                       device=w.device)
    fn = _build.function("mxint_quantize", "mxint_quantize_launch", 3, 5)
    err = fn(w.data_ptr(), codes.data_ptr(), exps.data_ptr(), m, n,
             2 ** (bits - 1) - 1, plan.path, plan.grid,
             torch.cuda.current_stream(w.device).cuda_stream)
    _build.check(err, "mxint_quantize_launch (K7)")
    LAUNCHES["mxint_quantize"] += 1
    LAUNCH_SHAPES[(m, n)] += 1
    return codes, exps


def mxint_quantize(w: torch.Tensor, bits: int, block: int = MXINT_BLOCK
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(codes int8 (M, N), exponents int8 (M/block, N)) of ``w``, whose
    row count is a multiple of ``block``. CPU tensors take the plain
    version; CUDA tensors take K7, which is built for 32-row blocks."""
    if w.shape[0] % block:
        raise ValueError(f"{w.shape[0]} rows are not a multiple of the "
                         f"block {block}: pad them first")
    if runs_plain(w):
        return mxint_quantize_plain(w, bits, block)
    if block != MXINT_BLOCK:
        raise ValueError(f"K7 quantizes {MXINT_BLOCK}-row blocks, not {block}")
    return mxint_quantize_cuda(w, bits)
