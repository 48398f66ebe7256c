"""Operations and bytes of one call of a kernel function, from its shapes.

A frozen copy of the formulas of ``repro_torch/kernels/work.py`` for K1,
K2, K4, K6 and K7 (``perfbench/tests/test_perfbench_work.py`` holds
the two equal at several shapes). Each counts the FLOPs the function's
mathematics needs and the bytes it must move: each input read once,
each output written once. They are the numerators of the benchmark's
roofline shares and MFUs, and stay as they are whatever the port's own
copy becomes.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

MXINT_BLOCK = 32          # rows of one MXINT block (one shared exponent)
QLR_FUSED_MAX_ROWS = 128  # K1 (x·L in the pass) up to this many rows, K2 above


@dataclasses.dataclass(frozen=True)
class Work:
    """One call's work: ``name`` (``"K1 qlr_fused_matmul"`` …), its FLOPs
    and the bytes it must move."""
    name: str
    flops: float
    bytes: float


def qlr_work(m: int, k: int, n: int, rank: int, *, x_itemsize: int = 4,
             packed: bool = False) -> Work:
    """K1/K2, ``y (m, n) f32 = x (m, k)·dequant(Q) + (x·L)·R``: x, the
    codes (int8, or packed4 at half a byte), the f32 block scales and R,
    the f32 output, and L (K1, ``m <= QLR_FUSED_MAX_ROWS``) or the f32
    sliver x·L (K2). ``k`` is the codes' MXINT-padded rows."""
    fused = m <= QLR_FUSED_MAX_ROWS
    codes = k * n // 2 if packed else k * n
    nbytes = (m * k * x_itemsize + codes + (k // MXINT_BLOCK) * n * 4
              + rank * n * 4 + m * n * 4
              + (k * rank * 4 if fused else m * rank * 4))
    flops = 2 * m * k * n + 2 * m * k * rank + 2 * m * rank * n
    return Work("K1 qlr_fused_matmul" if fused else "K2 qlr_xl_matmul",
                flops, nbytes)


def attention_pairs(sq: int, sk: int, *, causal: bool = True, window: int = 0,
                    start: int = 0) -> int:
    """(query, key) pairs a prefill attends: every one non-causal;
    causal, query ``i`` (at position ``start + i``) sees ``start + i + 1``
    keys, at most ``window`` of them under a window."""
    if not causal:
        return sq * sk
    lo, hi = start + 1, start + sq
    if not window or window >= hi:
        return (lo + hi) * sq // 2
    if window < lo:
        return window * sq
    return (lo + window) * (window - lo + 1) // 2 + window * (hi - window)


def flash_attention_work(sq: int, h: int, kvh: int, hd: int, *, pairs: int,
                         kv_rows: int, positions: int, itemsize: int = 4,
                         b: int = 1) -> Work:
    """K4: q and the output (b, sq, h, hd), the K/V rows of ``kv_rows``
    keys (b, kv_rows, kvh, hd), ``positions`` int32 entries, and 2·2·hd
    FLOPs a (query head, key) pair."""
    nbytes = (2 * b * sq * h * hd * itemsize
              + 2 * b * kv_rows * kvh * hd * itemsize + positions * 4)
    return Work("K4 flash_attention", 2 * 2 * b * h * pairs * hd, nbytes)


def qlr_batched_work(e: int, m: int, k: int, n: int, rank: int, *,
                     rows: Optional[int] = None, live: Optional[int] = None,
                     x_itemsize: int = 4, counts: bool = True) -> Work:
    """K6 over ``e`` int8 expert stacks of ``m`` rows: the ``rows`` rows
    that hold a token (all by default) and the codes, scales, L and R of
    the ``live`` experts that hold one (all by default), the (e,) int32
    counts where given, and all of y (e, m, n) f32."""
    rows = e * m if rows is None else rows
    live = e if live is None else live
    per_expert = (k * n + (k // MXINT_BLOCK) * n * 4 + k * rank * 4
                  + rank * n * 4)
    nbytes = (live * per_expert + rows * k * x_itemsize
              + (e * 4 if counts else 0) + e * m * n * 4)
    return Work("K6 qlr_batched_matmul",
                2 * rows * (k * n + k * rank + rank * n), nbytes)


def mxint_quantize_work(m: int, n: int, *, w_itemsize: int = 4) -> Work:
    """K7: one read of w (m, n), one write of the int8 codes and of the
    int8 exponents (m/32, n); per weight an abs, a max, a scaling, a
    rounding and two clamps."""
    nbytes = m * n * w_itemsize + m * n + (m // MXINT_BLOCK) * n
    return Work("K7 mxint_quantize", 6 * m * n, nbytes)
