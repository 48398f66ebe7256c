"""Each kernel function's work (K1–K7) by its own formula, and the hook
the model calls each of them through.

A formula reads shapes and dtypes only, never a device value: its FLOPs,
and the bytes the function must move (each input read once, each output
written once). Where the work depends on the data (valid cache slots,
expert rows that hold a token) the model's call counts every slot and
every row; a caller that knows its data passes the counts it needs.

:func:`kernel` wraps one call of a kernel function, whichever route
computes it (the CUDA kernel, its plain version, or the model's
``fused="off"`` path). While nothing records (``RECORDER is None``) it is
one ``None`` check before the call; :func:`repro_torch.launch.cost.count`
sets ``RECORDER`` to an object whose ``kernel(work, fn, args, kwargs)``
records ``work`` and runs ``fn``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from repro_torch.kernels.constraints import MXINT_BLOCK, QLR_FUSED_MAX_ROWS

# the running recorder (None: nothing records)
RECORDER = None


@dataclasses.dataclass(frozen=True)
class Work:
    """One kernel function call's work: ``name`` (``"K1
    qlr_fused_matmul"`` … ``"K7 mxint_quantize"``, as ``chip_smoke.py``'s
    rows name them), its FLOPs and the bytes it must move (each input
    read once, each output written once)."""
    name: str
    flops: float
    bytes: float


# ---------------------------------------------------------------------------
# the kernel functions' formulas (shapes only)
# ---------------------------------------------------------------------------
def qlr_work(m: int, k: int, n: int, rank: int, *, x_itemsize: int = 4,
             packed: bool = False) -> Work:
    """K1/K2, ``y (m, n) f32 = x (m, k)·dequant(Q) + (x·L)·R``: x, the
    codes (int8, or packed4 at half a byte), the f32 block scales and R,
    the f32 output, and L (K1, ``m ≤ QLR_FUSED_MAX_ROWS``) or the f32
    sliver x·L (K2). ``k`` is the codes' MXINT-padded rows, which the
    kernel and its plain version multiply (``fused="off"`` leaves the
    zero rows out of its dequantized weight)."""
    fused = m <= QLR_FUSED_MAX_ROWS
    codes = k * n // 2 if packed else k * n
    nbytes = (m * k * x_itemsize + codes + (k // MXINT_BLOCK) * n * 4
              + rank * n * 4 + m * n * 4
              + (k * rank * 4 if fused else m * rank * 4))
    flops = 2 * m * k * n + 2 * m * k * rank + 2 * m * rank * n
    return Work("K1 qlr_fused_matmul" if fused else "K2 qlr_xl_matmul",
                flops, nbytes)


def decode_slot_bytes(kvh: int, hd: int, kv_itemsize: float,
                      scaled: bool) -> float:
    """One slot's K and V rows over ``kvh`` heads, and their f32 scales."""
    return 2 * kvh * hd * kv_itemsize + (2 * kvh * 4 if scaled else 0)


def _decode_bytes(b: int, kvh: int, g: int, hd: int, slots: int, valid: int,
                  kv_itemsize: float, scaled: bool, q_itemsize: int) -> float:
    """The K/V rows (and scales) of the valid slots, q, the positions
    (q_pos (b,), k_pos (b, slots) int32) and the f32 output."""
    slot = decode_slot_bytes(kvh, hd, kv_itemsize, scaled)
    return (valid * slot + b * kvh * g * hd * q_itemsize + b * 4
            + b * slots * 4 + b * kvh * g * hd * 4)


def decode_attention_work(b: int, kvh: int, g: int, hd: int, slots: int, *,
                          valid: Optional[int] = None,
                          kv_itemsize: float = 2, scaled: bool = False,
                          q_itemsize: int = 4) -> Work:
    """K3 over a (b, kvh, slots, hd) slot cache, ``g`` query heads a KV
    head: ``valid`` (row, slot) pairs attended (every slot by default);
    ``kv_itemsize`` 0.5 for packed int4, ``scaled`` for int8/int4 with
    per-slot scales."""
    valid = b * slots if valid is None else valid
    return Work("K3 flash_decode", 2 * 2 * valid * kvh * g * hd,
                _decode_bytes(b, kvh, g, hd, slots, valid, kv_itemsize,
                              scaled, q_itemsize))


def paged_decode_work(b: int, kvh: int, g: int, hd: int, slots: int,
                      table_entries: int, *, valid: Optional[int] = None,
                      kv_itemsize: float = 2, scaled: bool = False,
                      q_itemsize: int = 4) -> Work:
    """K5: K3's work over ``slots`` logical slots a row through a block
    table of ``table_entries`` int32 entries, which it also reads."""
    valid = b * slots if valid is None else valid
    return Work("K5 flash_decode_paged", 2 * 2 * valid * kvh * g * hd,
                _decode_bytes(b, kvh, g, hd, slots, valid, kv_itemsize,
                              scaled, q_itemsize) + table_entries * 4)


def latent_decode_work(b: int, h: int, slots: int, r: int, pe: int, *,
                       valid: Optional[int] = None, lat_itemsize: int = 2,
                       q_itemsize: int = 4) -> Work:
    """K3's latent instance (MLA): ``h`` query heads over one latent row
    of ``r + pe`` a slot, read once (V is its first ``r`` columns); q,
    the positions and the f32 (b, h, r) output."""
    valid = b * slots if valid is None else valid
    nbytes = (valid * (r + pe) * lat_itemsize + b * h * (r + pe) * q_itemsize
              + b * 4 + b * slots * 4 + b * h * r * 4)
    return Work("K3 flash_decode", 2 * h * valid * (r + pe) + 2 * h * valid * r,
                nbytes)


def attention_pairs(sq: int, sk: int, *, causal: bool = True, window: int = 0,
                    start: int = 0) -> int:
    """(query, key) pairs a prefill attends: every one non-causal;
    causal, query ``i`` (at position ``start + i``) sees ``start + i + 1``
    keys, at most ``window`` of them under a window."""
    if not causal:
        return sq * sk
    lo, hi = start + 1, start + sq              # keys seen by the first/last
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


# ---------------------------------------------------------------------------
# the hook
# ---------------------------------------------------------------------------
def kernel(work: Callable[[], Work], fn: Callable, *args, **kw):
    """``fn(*args, **kw)``: one kernel function's call, by whichever
    route. Under a recorder, ``work()`` is handed to it with the call."""
    rec = RECORDER
    if rec is None:
        return fn(*args, **kw)
    return rec.kernel(work(), fn, args, kw)
