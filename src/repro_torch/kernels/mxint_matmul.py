"""K1, K2 and K6: the fused MXINT Q + LR matmul,
``y = x·dequant(Q) + (x·L)·R``.

Port of ``repro/kernels/mxint_matmul.py`` (the Pallas kernels
``mxint_lowrank_matmul_fused_2d``, ``mxint_lowrank_matmul_2d`` and
``mxint_lowrank_matmul_batched_2d``) and of the ``qlr_matmul`` /
``qlr_matmul_batched`` dispatch in ``repro/kernels/ops.py``. The CUDA
source is ``csrc/mxint_matmul.cu``; its header says what bounds it and
how.

:func:`qlr_matmul` is the entry point. For a CPU tensor it runs
:func:`qlr_matmul_plain`; for a CUDA tensor it launches K1 (x·L
accumulated in the kernel) when there are at most
``QLR_FUSED_MAX_ROWS`` rows and K2 (x·L precomputed by one small
``torch.matmul``) otherwise, or raises on an input the kernels do not
take. ``codes`` is the int8 container ``(K, N)`` or the packed4 uint8
container ``(K/2, N)``, which the kernels unpack in registers; any N, as
the JAX entry pads N to its tile: a width that is not a multiple of
``QLR_COL_VEC`` runs on copies widened to one (:func:`pad_cols`), which
no full-width model's projections need. K1 and K2
are one tensor-core kernel launched once a call; :func:`qlr_plan` picks
its tile and its split of K. The kernels build each weight as
``code · scale`` in bf16, exact for MXINT's power-of-two scales.

:func:`qlr_matmul_batched` is the stacked entry (MoE experts): ``x (E, M,
K)`` against ``E`` int8 weights. On a CUDA tensor it launches K6, the same
tensor-core body over the stack with x·L in the pass (one launch, no
sliver computed outside, no finishing kernel; :func:`qlr_stacked_plan`
picks its tile and split); on a CPU tensor it runs
:func:`qlr_matmul_batched_plain`. Its optional ``counts`` (E,) int32 gives
the rows of each entry's capacity queue that hold a token: the rows past
it come out as zeros and K6 does not compute them (the JAX kernel computes
every row; on the MoE dispatch buffer, zero past the counts, the two
agree).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.constraints import (
    CUDA_MAX_GRID_YZ, MXINT_BLOCK, QLR_COL_VEC, QLR_DECODE_ROWS,
    QLR_DECODE_TARGET_BLOCKS, QLR_FUSED_MAX_ROWS, QLR_MAX_RANK,
    QLR_MAX_SPLITS, QLR_PREFILL_TARGET_BLOCKS, QLR_ROUTER_COLS,
    QLR_STACK_TARGET_BLOCKS, QLR_TILE_DECODE, QLR_TILE_PREFILL,
    QLR_TILE_ROUTER, QLR_TILE_STACK_DECODE, QLR_TILE_STACK_PREFILL,
    QLR_TILE_WIDE, QLR_TILES, QLR_WIDE_MAX_COLS, QLR_X_ALIGN, refuse_grad,
    runs_plain)
from repro_torch.quant.mxint import unpack_codes_4bit

# launches of each kernel since the last reset; a plain count per wrapper
LAUNCHES = {"qlr_fused": 0, "qlr": 0, "qlr_batched": 0}


def dequant_blockwise(codes: torch.Tensor, scale: torch.Tensor,
                      dtype) -> torch.Tensor:
    """``(..., K, N)`` codes × per-block ``(..., K/B, N)`` scale → dense
    weight, by reshape-multiply (no repeated scale plane); leading stack
    dims pass through."""
    lead, (k, n) = codes.shape[:-2], codes.shape[-2:]
    nb = scale.shape[-2]
    return (codes.to(dtype).reshape(*lead, nb, k // nb, n)
            * scale.to(dtype)[..., :, None, :]).reshape(*lead, k, n)


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


def _split_k(tile: int, tiles: int, k: int,
             target: int) -> tuple[int, int, int]:
    """(tile, K splits, MXINT blocks a split) for a grid of ``tiles``
    output tiles over ``k`` rows. Splits double, up to ``QLR_MAX_SPLITS``
    (one thread-block cluster), while the doubled grid stays within
    ``target`` blocks and every split keeps at least one MXINT block; the
    last split may be short."""
    k32 = k // MXINT_BLOCK
    splits = 1
    while splits < QLR_MAX_SPLITS and tiles * 2 * splits <= target \
            and (2 * splits - 1) * -(-k32 // (2 * splits)) < k32:
        splits *= 2
    return tile, splits, -(-k32 // splits)


def qlr_plan(m: int, k: int, n: int) -> tuple[int, int, int]:
    """The K1/K2 launch for ``x (m, k)`` against ``(k, n)`` codes: (tile
    shape, K splits, MXINT blocks a split), the splits within the tile's
    target count of blocks (one wave)."""
    if m <= QLR_DECODE_ROWS:
        tile = QLR_TILE_ROUTER if n <= QLR_ROUTER_COLS else \
            QLR_TILE_WIDE if n < QLR_WIDE_MAX_COLS else QLR_TILE_DECODE
        target = QLR_DECODE_TARGET_BLOCKS
    else:
        tile, target = QLR_TILE_PREFILL, QLR_PREFILL_TARGET_BLOCKS
    cols, rows = QLR_TILES[tile][:2]
    return _split_k(tile, -(-n // cols) * -(-m // rows), k, target)


def qlr_stacked_plan(e: int, m: int, k: int,
                     n: int) -> tuple[int, int, int]:
    """The K6 launch for ``x (e, m, k)`` against ``(e, k, n)`` codes:
    (tile shape, K splits, MXINT blocks a split). 8-row tiles for the
    decode lanes, 32-row tiles above; K splits only while the grid of
    ``e`` entries' tiles stays within ``QLR_STACK_TARGET_BLOCKS``."""
    tile = QLR_TILE_STACK_DECODE if m <= QLR_DECODE_ROWS \
        else QLR_TILE_STACK_PREFILL
    cols, rows = QLR_TILES[tile][:2]
    return _split_k(tile, e * -(-n // cols) * -(-m // rows), k,
                    QLR_STACK_TARGET_BLOCKS)


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
    if x.ndim != 2 or x.shape[-1] != k:
        raise ValueError(f"x {tuple(x.shape)} must be (M, K) with K = {k}, "
                         f"the rows the codes hold")
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
    m = x.shape[0]
    if m < 1 or -(-m // QLR_TILES[QLR_TILE_PREFILL][1]) > CUDA_MAX_GRID_YZ \
            or -(-n // QLR_TILES[QLR_TILE_ROUTER][0]) > CUDA_MAX_GRID_YZ:
        raise ValueError(f"M={m}, N={n}: the grid's row and column tiles "
                         f"must number 1 to {CUDA_MAX_GRID_YZ}")
    if codes.data_ptr() % 4 or scale.data_ptr() % 16 \
            or x.data_ptr() % QLR_X_ALIGN \
            or (rank and r.data_ptr() % QLR_X_ALIGN):
        raise ValueError(f"codes must be 4-byte, scale 16-byte and x and r "
                         f"{QLR_X_ALIGN}-byte aligned")
    return k, n, rank


def pad_cols(codes: torch.Tensor, scale: torch.Tensor,
             r: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """``codes``, ``scale`` and ``r`` widened to the next multiple of
    ``QLR_COL_VEC`` output columns (codes and R with zeros, the scale with
    ones), so that the kernels' 4- and 16-byte row copies stay aligned; a
    width already a multiple passes through uncopied. The padded columns
    compute zeros, which the launchers slice off."""
    pad = -codes.shape[1] % QLR_COL_VEC
    if not pad:
        return codes, scale, r
    widen = torch.nn.functional.pad
    return widen(codes, (0, pad)), widen(scale, (0, pad), value=1.0), \
        widen(r, (0, pad))


def qlr_fused_matmul(x: torch.Tensor, codes: torch.Tensor,
                     scale: torch.Tensor, l: torch.Tensor,
                     r: torch.Tensor) -> torch.Tensor:
    """Launch K1 on ``x (M, K)``: y (M, N) f32, x·L accumulated in the
    kernel's pass over K. Any N: a width that is not a multiple of
    ``QLR_COL_VEC`` runs padded (:func:`pad_cols`)."""
    n_out = codes.shape[1]
    codes, scale, r = pad_cols(codes, scale, r)
    k, n, rank = _check(x, codes, scale, l, r, rank_rows=x.shape[-1])
    m = x.shape[0]
    tile, splits, per = qlr_plan(m, k, n)
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    fn = _build.function("mxint_matmul", "qlr_fused_launch", 6, 9)
    err = fn(x.data_ptr(), codes.data_ptr(), scale.data_ptr(), l.data_ptr(),
             r.data_ptr(), y.data_ptr(), m, k, n, rank, tile, splits, per,
             int(x.dtype == torch.bfloat16), int(codes.dtype == torch.uint8),
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "qlr_fused_launch (K1)")
    LAUNCHES["qlr_fused"] += 1
    return y[:, :n_out]


def qlr_xl_matmul(x: torch.Tensor, codes: torch.Tensor, scale: torch.Tensor,
                  xl: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Launch K2 on ``x (M, K)`` with the precomputed sliver ``xl = x·L``
    (M, rank) f32: y (M, N) f32, any N as K1."""
    n_out = codes.shape[1]
    codes, scale, r = pad_cols(codes, scale, r)
    k, n, rank = _check(x, codes, scale, xl, r, rank_rows=x.shape[0])
    m = x.shape[0]
    tile, splits, per = qlr_plan(m, k, n)
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    fn = _build.function("mxint_matmul", "qlr_launch", 6, 9)
    err = fn(x.data_ptr(), codes.data_ptr(), scale.data_ptr(), xl.data_ptr(),
             r.data_ptr(), y.data_ptr(), m, k, n, rank, tile, splits, per,
             int(x.dtype == torch.bfloat16), int(codes.dtype == torch.uint8),
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "qlr_launch (K2)")
    LAUNCHES["qlr"] += 1
    return y[:, :n_out]


def qlr_matmul(x: torch.Tensor, codes: torch.Tensor, scale: torch.Tensor,
               l: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """``y = x·dequant(codes, scale) + (x·L)·R`` over any leading dims of
    ``x``; returns ``x.dtype``. CPU tensors take the plain version; CUDA
    tensors take K1 (rows ≤ ``QLR_FUSED_MAX_ROWS``) or K2. Raises for an
    operand that requires grad (``constraints.refuse_grad``)."""
    refuse_grad("K1/K2 (qlr_matmul)", x, codes, scale, l, r)
    k = x.shape[-1]
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k)
    if runs_plain(x):
        y = qlr_matmul_plain(x2, codes, scale, l, r)
    else:
        x2 = x2.contiguous()
        if x2.data_ptr() % QLR_X_ALIGN:     # a view at an odd offset
            x2 = x2.clone()
        if x2.shape[0] <= QLR_FUSED_MAX_ROWS:
            y = qlr_fused_matmul(x2, codes, scale, l, r)
        else:
            xl = x2.float() @ l.float()
            y = qlr_xl_matmul(x2, codes, scale, xl, r)
    return y.reshape(*lead, y.shape[-1]).to(x.dtype)


def _zero_past_counts(y: torch.Tensor,
                     counts: torch.Tensor | None) -> torch.Tensor:
    """Rows of entry ``e`` at or past ``counts[e]`` set to exactly 0."""
    if counts is None:
        return y
    rows = torch.arange(y.shape[1], device=y.device)
    live = rows[None, :] < counts.to(y.device, torch.int64)[:, None]
    return torch.where(live[..., None], y, 0.0)


def qlr_matmul_batched_plain(x: torch.Tensor, codes: torch.Tensor,
                             scale: torch.Tensor, l: torch.Tensor,
                             r: torch.Tensor,
                             counts: torch.Tensor | None = None
                             ) -> torch.Tensor:
    """Plain version of K6: ``x (E, M, K) → y (E, M, N)`` in f32,
    ``y[e] = x[e]·dequant(codes[e], scale[e]) + (x[e]·L[e])·R[e]``, rows
    of entry ``e`` at or past ``counts[e]`` zero."""
    xf = x.float()
    y = torch.bmm(xf, dequant_blockwise(codes, scale, torch.float32))
    if l.shape[-1] > 0:
        y = y + torch.bmm(torch.bmm(xf, l.float()), r.float())
    return _zero_past_counts(y, counts)


def qlr_batched_matmul_cuda(x: torch.Tensor, codes: torch.Tensor,
                            scale: torch.Tensor, l: torch.Tensor,
                            r: torch.Tensor,
                            counts: torch.Tensor | None = None
                            ) -> torch.Tensor:
    """Launch K6 on ``x (E, M, K)``: y (E, M, N) f32, x·L accumulated in
    the kernel's pass over K. Codes are int8 only, as the TPU kernel's.
    ``counts`` (E,) int32 on x's device, or None for every row; its
    values are not checked here (that would wait on the device): the
    kernel clamps them to [0, M]."""
    if codes.dtype != torch.int8:
        raise TypeError(f"K6 takes int8 codes, got {codes.dtype} (packed4 "
                        f"expert stacks take the dequantize-then-matmul path)")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    for name, t in (("scale", scale), ("l", l), ("r", r)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    for name, t in (("x", x), ("codes", codes), ("scale", scale), ("l", l),
                    ("r", r)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.ndim != 3 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 3-D stack, got "
                             f"shape {tuple(t.shape)}")
    e, m, k = x.shape
    n = codes.shape[2]
    rank = r.shape[1]
    if codes.shape != (e, k, n):
        raise ValueError(f"codes {tuple(codes.shape)} must be (E, K, N) = "
                         f"({e}, {k}, N) for x {tuple(x.shape)}")
    if k % MXINT_BLOCK or scale.shape != (e, k // MXINT_BLOCK, n):
        raise ValueError(f"scale {tuple(scale.shape)} must be (E, K/"
                         f"{MXINT_BLOCK}, N) = ({e}, {k // MXINT_BLOCK}, {n}) "
                         f"with K % {MXINT_BLOCK} == 0")
    if n % QLR_COL_VEC:
        raise ValueError(f"N={n} must be a multiple of {QLR_COL_VEC}")
    if rank > QLR_MAX_RANK or r.shape != (e, rank, n) \
            or l.shape != (e, k, rank):
        raise ValueError(f"l {tuple(l.shape)}, r {tuple(r.shape)} do not "
                         f"fit E={e}, K={k}, N={n} (rank ≤ {QLR_MAX_RANK})")
    if counts is not None:
        if counts.dtype != torch.int32:
            raise TypeError(f"counts must be int32, got {counts.dtype}")
        if counts.device != x.device:
            raise ValueError(f"counts is on {counts.device}, x on {x.device}")
        if counts.shape != (e,) or not counts.is_contiguous():
            raise ValueError(f"counts {tuple(counts.shape)} must be a "
                             f"contiguous ({e},) vector")
    tile, splits, per = qlr_stacked_plan(e, m, k, n)
    cols, rows = QLR_TILES[tile][:2]
    if m < 1 or e < 1 or e * -(-m // rows) > CUDA_MAX_GRID_YZ \
            or -(-n // cols) > CUDA_MAX_GRID_YZ:
        raise ValueError(f"E={e}, M={m}, N={n}: K6's grid takes 1 ≤ E · "
                         f"ceil(M/{rows}) ≤ {CUDA_MAX_GRID_YZ} and "
                         f"ceil(N/{cols}) ≤ {CUDA_MAX_GRID_YZ}")
    if codes.data_ptr() % 4 or scale.data_ptr() % 16 \
            or x.data_ptr() % QLR_X_ALIGN \
            or (rank and r.data_ptr() % QLR_X_ALIGN):
        raise ValueError(f"codes must be 4-byte, scale 16-byte and x and r "
                         f"{QLR_X_ALIGN}-byte aligned")
    y = torch.empty((e, m, n), dtype=torch.float32, device=x.device)
    fn = _build.function("mxint_matmul", "qlr_stacked_launch", 7, 9)
    err = fn(x.data_ptr(), codes.data_ptr(), scale.data_ptr(), l.data_ptr(),
             r.data_ptr(), y.data_ptr(),
             None if counts is None else counts.data_ptr(), e, m, k, n, rank,
             tile, splits, per, int(x.dtype == torch.bfloat16),
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "qlr_stacked_launch (K6)")
    LAUNCHES["qlr_batched"] += 1
    return y


def qlr_matmul_batched(x: torch.Tensor, codes: torch.Tensor,
                       scale: torch.Tensor, l: torch.Tensor,
                       r: torch.Tensor,
                       counts: torch.Tensor | None = None) -> torch.Tensor:
    """Stacked ``y[e] = x[e]·dequant(codes[e], scale[e]) + (x[e]·L[e])·
    R[e]`` for ``x (E, M, K)``, int8 ``codes (E, K, N)``, ``scale (E,
    K/32, N)``, ``l (E, K, r)``, ``r (E, r, N)``; rows of entry ``e`` at
    or past ``counts[e]`` (an (E,) int32, or None for none) are zero.
    Returns ``x.dtype``. CPU tensors take the plain version; CUDA tensors
    take K6. Raises for an operand that requires grad."""
    refuse_grad("K6 (qlr_matmul_batched)", x, codes, scale, l, r)
    if runs_plain(x):
        y = qlr_matmul_batched_plain(x, codes, scale, l, r, counts)
    else:
        x = x.contiguous()
        if x.data_ptr() % QLR_X_ALIGN:      # a view at an odd offset
            x = x.clone()
        y = qlr_batched_matmul_cuda(x, codes, scale, l, r, counts)
    return y.to(x.dtype)
