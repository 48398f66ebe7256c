"""The number path of the tensor-core K1/K2/K6 kernel (qlr_tc_body in
``kernels/csrc/mxint_matmul.cu``), emulated in torch on the CPU and held
against the JAX oracle ``repro.kernels.ref.mxint_lowrank_matmul_ref``.

The emulation follows the kernel step by step: the weight enters as
``bf16(code · 2^e)``; an f32 x as the bf16 pair ``hi = bf16(x)``, ``lo =
bf16(x − hi)`` and a bf16 x once; each 16-row k-step's products are added
to f32 accumulators (hi first, then lo); each warp of a stage owns its
MXINT blocks; each block of a K split of :func:`qlr_plan` sums its warps
in order, and the splits' sums add in rank order; K1's x·L runs as x hi/lo × L hi/lo
(three products) and K2 takes ``x·L`` from the caller; the epilogue adds
``(x·L)·R`` one rank at a time. K6 is K1 per stack entry under
:func:`qlr_stacked_plan`, with the entry's x rows at or past its count
loaded as zeros and its y rows there written as zeros.

An N that is not a multiple of four runs as the launchers run it: on the
operands widened by ``pad_cols``, the padded columns sliced off.

Tolerance: ``1e-4 · max(1, max|y|)``, the gate the card run holds the
kernel to. The weights are exact in bf16; x's hi/lo pair misses x by about
2^-17 of |x|, so each product is off by that much at most, and the
f32 sums in another order than the oracle's add ~K·2^-24 relative — both
far inside 1e-4 of the output scale.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import mxint_lowrank_matmul_ref
from repro.quant.mxint import MXIntQuantizer, pack_codes_4bit
from repro_torch.kernels.constraints import (CUDA_MAX_GRID_YZ, MXINT_BLOCK,
                                             QLR_COL_VEC, QLR_FUSED_MAX_ROWS,
                                             QLR_MAX_SPLITS, QLR_TILE_ROUTER,
                                             QLR_TILES)
from repro_torch.kernels.mxint_matmul import (_check, pad_cols, qlr_plan,
                                              qlr_stacked_plan)
from repro_torch.quant.mxint import unpack_codes_4bit

K16 = 16                       # mma.sync m16n8k16: K rows a step


def _bf16_terms(v: torch.Tensor) -> list:
    """The bf16 operands a value enters the mma as: one for bf16, hi + lo
    for f32 — as f32 tensors holding bf16 values."""
    if v.dtype == torch.bfloat16:
        return [v.float()]
    hi = v.bfloat16().float()
    return [hi, (v - hi).bfloat16().float()]


def emulate(x, codes, scale, l, r, xl=None, plan=None) -> torch.Tensor:
    """y = x·dequant(codes, scale) + (x·L)·R as the kernel computes it;
    K1 (x·L in the pass) when ``xl`` is None, else K2; ``plan`` (tile,
    splits, blocks a split) when not :func:`qlr_plan`'s."""
    if codes.dtype == torch.uint8:
        codes = unpack_codes_4bit(codes)
    m, k = x.shape
    n = codes.shape[1]
    rank = r.shape[0]
    tile, splits, per = plan or qlr_plan(m, k, n)
    stage_blocks, k_warps = QLR_TILES[tile][2:]
    w = (codes.float().reshape(k // MXINT_BLOCK, MXINT_BLOCK, n)
         * scale[:, None, :]).reshape(k, n)
    w_bf = w.bfloat16().float()
    assert torch.equal(w_bf, w), "an MXINT weight is not exact in bf16"
    xs = _bf16_terms(x)
    lh = _bf16_terms(l.float())
    partial = torch.zeros((splits, k_warps, m, n))
    xl_part = torch.zeros((splits, k_warps, m, rank))
    for s in range(splits):
        for b in range(s * per, min(k // MXINT_BLOCK, (s + 1) * per)):
            wk = (b - s * per) % stage_blocks % k_warps   # its warp
            for k0 in range(b * MXINT_BLOCK, (b + 1) * MXINT_BLOCK, K16):
                rows = slice(k0, k0 + K16)
                for xt in xs:
                    partial[s, wk] += xt[:, rows] @ w_bf[rows]
                if xl is None and rank:
                    # ah·bh, al·bh, then ah·bl for an f32 x
                    pairs = [(xs[0], lh[0]), (xs[0], lh[1])]
                    if len(xs) > 1:
                        pairs.append((xs[1], lh[0]))
                    for xt, lt in pairs:
                        xl_part[s, wk] += xt[:, rows] @ lt[rows]
    # each block sums its warps first, then the splits' sums add in rank
    # order
    y = torch.zeros((m, n))
    xl_sum = torch.zeros((m, rank))
    for s in range(splits):
        block, block_xl = partial[s, 0].clone(), xl_part[s, 0].clone()
        for wk in range(1, k_warps):
            block += partial[s, wk]
            block_xl += xl_part[s, wk]
        y += block
        xl_sum += block_xl
    if xl is not None:
        xl_sum = xl
    for c in range(rank):
        y += xl_sum[:, c:c + 1] * r[c]
    return y


def emulate_stacked(x, codes, scale, l, r, counts) -> torch.Tensor:
    """K6 as the kernel computes it: K1 per entry under the stacked plan,
    x rows at or past the entry's count (clamped to [0, M]) loaded as
    zeros, y rows there written as zeros."""
    e, m, k = x.shape
    plan = qlr_stacked_plan(e, m, k, codes.shape[2])
    ys = []
    for i in range(e):
        c = min(max(int(counts[i]), 0), m)
        xi = x[i].clone()
        xi[c:] = 0
        yi = emulate(xi, codes[i], scale[i], l[i], r[i], plan=plan)
        yi[c:] = 0
        ys.append(yi)
    return torch.stack(ys)


def _case(m, k, n, rank, seed, extreme=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    q = MXIntQuantizer(bits=3).quantize(jnp.asarray(w))
    codes = np.array(q.codes)
    exps = np.array(q.exponents, np.int32)
    if extreme:
        # blocks at the clip ends of MXINT's exponent; at +127 only codes
        # of magnitude <= 1 keep code·2^e finite in f32, and x shrinks so
        # that the sums stay finite too
        blocks = k // MXINT_BLOCK
        exps[0], exps[1], exps[blocks - 1] = -127, 127, -126
        big = slice(MXINT_BLOCK, 2 * MXINT_BLOCK)
        codes[big] = np.clip(codes[big], -1, 1)
        x *= np.float32(2.0 ** -20)
    scale = np.ldexp(np.float32(1), exps).astype(np.float32)   # exact 2^e
    l = (rng.standard_normal((k, rank)) * 0.1).astype(np.float32)
    r = (rng.standard_normal((rank, n)) * 0.1).astype(np.float32)
    return x, codes, scale, l, r


def _hold(m, k, n, rank, packed, seed, extreme=False, bf16=False):
    x, codes, scale, l, r = _case(m, k, n, rank, seed, extreme)
    if bf16:
        x = np.asarray(torch.from_numpy(x).bfloat16().float())
    want = np.asarray(mxint_lowrank_matmul_ref(
        *(jnp.asarray(a) for a in (x, codes, scale, l, r))))
    c = np.array(pack_codes_4bit(jnp.asarray(codes))) if packed else codes
    xt = torch.from_numpy(x)
    if bf16:
        xt = xt.bfloat16()
    c, scale_t, r_t = pad_cols(*(torch.from_numpy(a) for a in (c, scale, r)))
    args = [c, scale_t, torch.from_numpy(l), r_t]
    xl = None if m <= QLR_FUSED_MAX_ROWS else xt.float() @ args[2]
    got = emulate(xt, *args, xl=xl)[:, :n].numpy()
    assert np.isfinite(want).all() and np.isfinite(got).all()
    tol = 1e-4 * max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= tol


# K = 1056: 33 MXINT blocks, so the last K split is short; N =
# 200 leaves a partial column tile, N = 64 is the router's tile
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("rank", [0, 16])
@pytest.mark.parametrize("m", [1, 8, 128, 130])
@pytest.mark.parametrize("n", [64, 200])
def test_tiles_match_jax_oracle(packed, rank, m, n):
    _hold(m, 1056, n, rank, packed, seed=m + n + rank)


# K6: entries with no token, one, part of the queue and all of it, and
# counts past M and below 0 (clamped); M = 30 is the prefill capacity
# (one 32-row tile), 40 takes two row tiles, 8 the decode lanes
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("rank", [0, 16])
@pytest.mark.parametrize("m", [1, 8, 30, 40])
@pytest.mark.parametrize("n", [64, 200])
def test_stacked_tiles_match_jax_oracle(bf16, rank, m, n):
    e, k = 6, 1056
    counts = [0, 1, m // 2, m, m + 3, -2]
    cases = [_case(m, k, n, rank, seed=m + n + rank + i) for i in range(e)]
    x, codes, scale, l, r = (np.stack(a) for a in zip(*cases))
    rows = np.arange(m)[None, :] >= np.clip(counts, 0, m)[:, None]
    x[rows] = 0                  # the dispatch buffer is zero past a count
    if bf16:
        x = np.asarray(torch.from_numpy(x).bfloat16().float())
    want = np.stack([np.asarray(mxint_lowrank_matmul_ref(
        *(jnp.asarray(a[i]) for a in (x, codes, scale, l, r))))
        for i in range(e)])
    xt = torch.from_numpy(x)
    if bf16:
        xt = xt.bfloat16()
    got = emulate_stacked(xt, *(torch.from_numpy(a)
                                for a in (codes, scale, l, r)),
                          counts).numpy()
    assert np.isfinite(got).all() and not got[rows].any()
    tol = 1e-4 * max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= tol


# xlstm-125m's w_if: 1536×8 at rank 4 (one partial 16-rank tile of x·L,
# 8 live columns of the router tile); the reduced sLSTM FFN's N = 85
# (widened to 88); at decode (K1) and prefill (K2) rows
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("m", [8, 256])
@pytest.mark.parametrize("k,n,rank", [(1536, 8, 4), (96, 85, 16)])
def test_narrow_and_ragged_widths_match_jax_oracle(packed, m, k, n, rank):
    _hold(m, k, n, rank, packed, seed=k + n + m)


@pytest.mark.parametrize("n,rank", [(8, 4), (85, 16), (85, 0)])
def test_check_takes_any_width_after_pad_cols(n, rank):
    """The launchers' check raises at N % 4 != 0; ``pad_cols`` widens
    codes (zeros), scale (ones) and R (zeros) to the next multiple,
    leaves a multiple uncopied, and the check then passes; N = 8 takes
    the router tile."""
    k = 96
    codes = torch.randint(-4, 4, (k, n), dtype=torch.int8)
    scale = torch.full((k // MXINT_BLOCK, n), 0.5)
    ops = dict(x=torch.zeros((8, k)), l=torch.zeros((k, rank)))
    r = torch.randn((rank, n))
    if n % QLR_COL_VEC:
        with pytest.raises(ValueError, match="multiple"):
            _check(codes=codes, scale=scale, r=r, **ops, rank_rows=k)
    pc, ps, pr = pad_cols(codes, scale, r)
    width = -(-n // QLR_COL_VEC) * QLR_COL_VEC
    assert _check(codes=pc, scale=ps, r=pr, **ops, rank_rows=k) == \
        (k, width, rank)
    assert torch.equal(pc[:, :n], codes) and not pc[:, n:].any()
    assert bool((ps[:, n:] == 1).all()) and not pr[:, n:].any()
    if n % QLR_COL_VEC == 0:
        assert pc is codes and ps is scale and pr is r
        assert qlr_plan(8, k, n)[0] == QLR_TILE_ROUTER


@pytest.mark.parametrize("m", [8, 130])
def test_tiles_bf16_x_match_jax_oracle(m):
    _hold(m, 1056, 200, 16, False, seed=m, bf16=True)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("m", [8, 130])
def test_tiles_extreme_exponents(packed, m):
    _hold(m, 256, 96, 16, packed, seed=7, extreme=True)


def test_plan_splits_cover_k():
    """Every MXINT block lies in exactly one split, splits stay within a
    cluster, and the shapes the port serves get a ragged last split where
    K/32 does not divide."""
    for m, k, n in [(8, 3072, 8192), (8, 2048, 64), (8, 8192, 3072),
                    (8, 10944, 2048), (256, 3072, 3072), (64, 1056, 200),
                    (130, 1056, 200), (1, 64, 96)]:
        tile, splits, per = qlr_plan(m, k, n)
        blocks = k // MXINT_BLOCK
        assert 1 <= splits <= QLR_MAX_SPLITS
        assert splits & (splits - 1) == 0
        assert (splits - 1) * per < blocks <= splits * per
    assert qlr_plan(8, 10944, 2048)[1:] == (8, 43)     # 342 = 7·43 + 41
    assert qlr_plan(8, 2048, 64)[1:] == (8, 8)         # the router


def test_stacked_plan_covers_the_grid():
    """The K6 grid of :func:`qlr_stacked_plan` — (splits, column tiles,
    entries × row tiles), entry and row tile from grid.z as the kernel
    takes them — covers every (entry, row, column, MXINT block) exactly
    once and stays within the grid's limits; the serving shapes take one
    split (64 experts × 11 column tiles are blocks enough)."""
    for e, m, k, n in [(6, 45, 1088, 200), (2, 30, 1056, 64), (3, 1, 2048, 96),
                       (8, 3, 64, 32), (4, 64, 256, 128), (5, 8, 1088, 136)]:
        tile, splits, per = qlr_stacked_plan(e, m, k, n)
        cols, rows = QLR_TILES[tile][:2]
        k32 = k // MXINT_BLOCK
        row_tiles = -(-m // rows)
        grid = (splits, -(-n // cols), e * row_tiles)
        assert 1 <= splits <= QLR_MAX_SPLITS
        assert max(grid[1:]) <= CUDA_MAX_GRID_YZ
        cover = np.zeros((e, m, n, k32), np.int32)
        for z in range(grid[2]):
            ent, m0 = z // row_tiles, (z % row_tiles) * rows
            for yy in range(grid[1]):
                for s in range(grid[0]):
                    cover[ent, m0:m0 + rows, yy * cols:(yy + 1) * cols,
                          s * per:min(k32, (s + 1) * per)] += 1
        assert (cover == 1).all(), (e, m, k, n)
    for m in (8, 30):
        for k, n in ((2048, 1408), (1408, 2048)):
            tile, splits, per = qlr_stacked_plan(64, m, k, n)
            assert (splits, per) == (1, k // MXINT_BLOCK)
            assert QLR_TILES[tile][1] == (8 if m == 8 else 32)


def test_bf16_dequant_is_exact():
    """bf16(code · 2^e) equals the f32 product bit for bit for every int8
    code and every exponent whose products are bf16 normals."""
    codes = torch.arange(-128, 128, dtype=torch.float32)
    # every nonzero |code| lies in [1, 2^7]: normal for e >= -126, below
    # bf16's largest finite value (2^128·(1 − 2^-8)) for e <= 120
    for e in range(-126, 121):
        w = codes * torch.tensor(2.0 ** e, dtype=torch.float32)
        nz = w[w != 0].abs()
        assert bool(torch.isfinite(w).all()) and bool((nz >= 2.0 ** -126).all())
        assert torch.equal(w.bfloat16().float(), w), e


@pytest.mark.parametrize("which", ["x", "r"])
def test_check_refuses_misaligned_operands(which):
    """x and R are read by 16-byte copies (R by the decode tiles, which
    stage it for the epilogue): the wrapper's check raises on a view 4
    bytes off, before any launch, and passes the aligned tensors."""
    k, n, rank = 64, 96, 16
    ops = dict(x=torch.zeros((8, k)), codes=torch.zeros((k, n), dtype=torch.int8),
               scale=torch.ones((k // MXINT_BLOCK, n)), l=torch.zeros((k, rank)),
               r=torch.zeros((rank, n)))
    assert _check(**ops, rank_rows=k) == (k, n, rank)
    t = ops[which]
    off = torch.zeros(t.numel() + 1)[1:].view(t.shape)
    assert off.is_contiguous() and off.data_ptr() % 16
    ops[which] = off
    with pytest.raises(ValueError, match="aligned"):
        _check(**ops, rank_rows=k)
