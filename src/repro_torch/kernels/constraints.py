"""Layout and tile limits the port's CUDA kernels rely on — one home.

The wrappers check every limit here before a launch and raise on an
input the kernel does not take; the CUDA sources carry the same numbers
as ``constexpr`` values, with a comment pointing back here.

The TPU's Mosaic floors of the JAX package (a page of at least 32
logical slots, 64 for packed4: ``repro/kernels/constraints.py``) do not
apply on Hopper: K5 resolves the page of every slot inside its tile, so
any even page size runs.
"""
from __future__ import annotations

import torch
from torch._subclasses.fake_tensor import FakeTensor

# MXINT shared-exponent block: one scale per 32 codes along K. The
# quantizer and the matmul kernels' scale indexing both assume it.
MXINT_BLOCK = 32

# packed4 container: two 4-bit codes per byte along the row (weights) or
# slot (KV cache) axis, so those counts must be even.
PACKED4_ALIGN = 2

# --- K1/K2/K6 (kernels/csrc/mxint_matmul.cu, qlr_tc_body) ----------------
# Output columns come in groups of four: the scale rows are read as
# 16-byte vectors, and K6 writes an empty tile's zeros as 16-byte vectors.
# K1/K2's launchers widen another N to the next multiple (pad_cols).
QLR_COL_VEC = 4
# Largest low-rank width: x·L runs as at most four 16-rank mma tiles.
QLR_MAX_RANK = 64
# Rows above which the wrapper takes K2 (x·L precomputed outside) —
# the same threshold as the JAX dispatch (kernels/ops.py:196-198).
QLR_FUSED_MAX_ROWS = 128
# The kernel's tile shapes (the .cu's launch_tile cases): output columns
# a block, rows of x a block, 32-row MXINT blocks a pipeline stage, and
# warps across K (block b of a stage goes to warp b mod that).
# Decode (rows <= QLR_DECODE_ROWS, the lanes as one 8-row mma n-tile),
# the same at the router's narrow outputs (N <= QLR_ROUTER_COLS) and twice
# as wide below QLR_WIDE_MAX_COLS outputs (few column tiles, so each
# block's fixed cost covers more columns), and the prefill tile (8 n-tiles
# of rows). K2 takes only the prefill tile.
QLR_TILE_DECODE, QLR_TILE_ROUTER, QLR_TILE_PREFILL, QLR_TILE_WIDE = 0, 1, 2, 3
# K6's tiles (the .cu's launch_stacked_tile cases), two blocks an SM:
# 8 rows up to QLR_DECODE_ROWS, 32 rows above.
QLR_TILE_STACK_DECODE, QLR_TILE_STACK_PREFILL = 4, 5
QLR_TILES = {QLR_TILE_DECODE: (128, 8, 4, 4), QLR_TILE_ROUTER: (64, 8, 4, 4),
             QLR_TILE_PREFILL: (128, 64, 2, 2), QLR_TILE_WIDE: (256, 8, 4, 4),
             QLR_TILE_STACK_DECODE: (256, 8, 2, 2),
             QLR_TILE_STACK_PREFILL: (256, 32, 2, 1)}
QLR_DECODE_ROWS = 8
QLR_ROUTER_COLS = 64
QLR_WIDE_MAX_COLS = 4096
# K is split into at most this many slices, one block each, summed inside
# one thread-block cluster (8 is the portable cluster size); splits double
# while the grid stays within the target count of blocks: one wave of the
# decode tiles (one block an SM: their shared memory), two blocks an SM
# of the prefill tile.
QLR_MAX_SPLITS = 8
QLR_DECODE_TARGET_BLOCKS = 132
QLR_PREFILL_TARGET_BLOCKS = 264
# K6's grid (entries × column tiles × row tiles) is wide already: splits
# only while it stays within two blocks an SM.
QLR_STACK_TARGET_BLOCKS = 264
# x, and R in the decode tiles, are read by 16-byte cp.async: their base
# addresses must be 16-byte aligned.
QLR_X_ALIGN = 16

# --- K3/K4 (kernels/csrc/decode_attention.cu, flash_attention.cu) ---------
# Head-dim limits: K4 keeps a warp's 16 query rows and output rows in
# registers as mma fragments sized for 128 columns, in 8-column tiles.
ATTN_MAX_HEAD_DIM = 128
ATTN_HEAD_DIM_ALIGN = 8
# K4's tiles: 64 query rows a block (16 a warp, 4 row warps, times 2
# warps splitting each key tile) against 64-key tiles of K and V,
# double-buffered in shared memory.
ATTN_Q_TILE = 64
ATTN_K_TILE = 64
# K3 (unpaged GQA) and K4 at a wider head, up to ATTN_WIDE_HEAD_DIM
# (recurrentgemma-9b: hd 256, one KV head, G = 16). K4's wide instance
# splits the output columns between a row's two warps (each owning
# ATTN_MAX_HEAD_DIM of them) instead of the key tile, reads Q's fragments
# from shared memory, and walks ATTN_WIDE_K_TILE-key tiles so that two
# f32 stages of K and V fit beside the Q tile. K3's wide instance keeps
# DECODE_BLOCK_GROUP heads a block (64 accumulator floats a lane) and
# aims at DECODE_WIDE_BLOCKS_PER_SM blocks an SM (its shared memory: 141
# KB a block in f32, 76 KB in bf16). K5 keeps ATTN_MAX_HEAD_DIM.
ATTN_WIDE_HEAD_DIM = 256
ATTN_WIDE_K_TILE = 32
DECODE_WIDE_BLOCKS_PER_SM = 2
# K3/K5 take up to DECODE_MAX_GROUP query heads a KV head (chatglm3-6b:
# 16). A block keeps one accumulator per query head in registers for at
# most DECODE_BLOCK_GROUP heads, so a wider group is split across
# ceil(G / DECODE_BLOCK_GROUP) blocks, each reading the head's K/V.
DECODE_MAX_GROUP = 16
DECODE_BLOCK_GROUP = 8
# K3 at MLA's latent head (deepseek-v2-lite-16b: kv_lora_rank 512 +
# rope_head_dim 64 = 576, one KV head, G = H = 16): a head wider than
# ATTN_MAX_HEAD_DIM, up to DECODE_MAX_HEAD_DIM, takes K3's latent
# instance — f32/bf16 cache, unpaged, V the first dv <=
# DECODE_LATENT_MAX_DV columns of K's rows (one tensor, read in place),
# DECODE_LATENT_BLOCK_GROUP query heads a block (16 accumulators a head a
# lane), about DECODE_LATENT_BLOCKS_PER_SM blocks an SM (its shared
# memory fits two: one tile stage in f32, two in bf16). K4 and K5 stay at ATTN_MAX_HEAD_DIM.
DECODE_MAX_HEAD_DIM = 576
DECODE_LATENT_MAX_DV = 512
DECODE_LATENT_BLOCK_GROUP = 4
DECODE_LATENT_BLOCKS_PER_SM = 2
# K3/K4/K5 copy K/V rows into shared memory in 16-byte (f32/bf16) or
# 8-byte (int8/packed4) chunks: the tensors' base address must be 16-byte
# aligned (a fresh allocation is; a view at an odd offset may not be).
KV_PTR_ALIGN = 16
# K3/K5 walk the slot axis in tiles of this many slots (one valid-slot
# bit each in a 32-bit mask; 8 slots for each of a block's 4 warps).
DECODE_TILE_SLOTS = 32
# ... split across blocks (flash-decoding): at most this many tiles a
# split, so a block's per-slot row table fits in shared memory ...
DECODE_MAX_SPLIT_TILES = 16
# ... into as many splits as it takes for about this many blocks per SM
# (never a split shorter than one tile).
DECODE_BLOCKS_PER_SM = 4

# --- K5 (kernels/csrc/decode_attention.cu, paged) --------------------------
# K5 walks a row's logical slots in K3's tiles and looks up the page of
# each slot, so a page may be smaller or larger than a tile; the only
# limit is the packed4 one: a page holds whole byte pairs.
PAGE_ALIGN = PACKED4_ALIGN

# CUDA's limit on a grid's y and z extents (K6 puts (stack entry, row
# tile) on z: E · ceil(M / row tile) must stay within it).
CUDA_MAX_GRID_YZ = 65535

# --- K7 (kernels/csrc/mxint_quantize.cu) -----------------------------------
# Code widths K7 takes: int8 holds codes in [-qmax-1, qmax] for bits <= 8,
# and 1 bit has no magnitude (qmax = 0).
MXINT_MIN_BITS = 2
MXINT_MAX_BITS = 8
# K7's paths (the .cu's kPath*). The register path loads float4s, so it
# needs w's address 16-byte aligned and every row's start too (N a
# multiple of MXINT_VEC floats); otherwise the scalar path takes every
# column in the same launch.
MXINT_PATH_SCALAR, MXINT_PATH_REGISTERS = 0, 1
MXINT_ALIGN = 16
MXINT_VEC = 4
# K7's persistent grid: MXINT_THREADS-thread blocks (the .cu's kThreads),
# at most MXINT_BLOCKS_PER_SM an SM (a register-path thread holds its 32
# float4s in ~254 registers, so four 64-thread blocks fill an SM's
# register file).
MXINT_THREADS = 64
MXINT_BLOCKS_PER_SM = 4
# Work items (quads or columns, each of one 32-row block) are counted in
# int32.
MXINT_MAX_ITEMS = 2 ** 31 - 1


def validate_page_size(page_size: int, what: str = "page_size") -> None:
    """Raise ``ValueError`` unless ``page_size`` logical slots can back a
    page of the paged KV cache: positive and even (an int4 nibble pair
    must not straddle two pages)."""
    if page_size < PAGE_ALIGN or page_size % PAGE_ALIGN:
        raise ValueError(
            f"{what}={page_size} must be a positive multiple of "
            f"{PAGE_ALIGN}: int4 packs two slots per byte and a nibble pair "
            f"must not straddle a page")


def check_head_dim(hd: int, max_hd: int = ATTN_MAX_HEAD_DIM) -> None:
    """The GQA attention kernels' limit: K5 at ATTN_MAX_HEAD_DIM, K3
    (unpaged) and K4 at ATTN_WIDE_HEAD_DIM."""
    if hd > max_hd or hd % ATTN_HEAD_DIM_ALIGN:
        raise ValueError(
            f"head_dim={hd} unsupported: this attention kernel takes at "
            f"most {max_hd} and a multiple of {ATTN_HEAD_DIM_ALIGN}")


def check_decode_head_dim(hd: int) -> None:
    """The limit of K3's latent instance."""
    if hd > DECODE_MAX_HEAD_DIM or hd % ATTN_HEAD_DIM_ALIGN:
        raise ValueError(
            f"head_dim={hd} unsupported: K3 takes at most "
            f"{DECODE_MAX_HEAD_DIM} and a multiple of {ATTN_HEAD_DIM_ALIGN}")


def runs_plain(t: torch.Tensor) -> bool:
    """Whether a wrapper given ``t`` runs its plain version: a CPU tensor,
    and a meta or fake tensor (an abstract count, ``launch.cost``), which
    computes nothing there. A CUDA tensor goes to the kernel."""
    return t.device.type != "cuda" or isinstance(t, FakeTensor)


def refuse_grad(kernel: str, *tensors) -> None:
    """The kernels (and so their wrappers, whichever version runs) define
    no backward: raise when grad mode is on and an operand requires grad,
    instead of returning an output that silently cuts the gradient. A
    model differentiates through ``fused="off"``, as training does."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel} has no backward, and an operand requires grad: run "
            f"the model with fused='off' to differentiate it, or call the "
            f"wrapper under torch.no_grad() / on detached tensors")
