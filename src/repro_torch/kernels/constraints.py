"""Layout and tile limits the port's CUDA kernels rely on — one home.

The wrappers check every limit here before a launch and raise on an
input the kernel does not take; the CUDA sources carry the same numbers
as ``constexpr`` values, with a comment pointing back here.
"""
from __future__ import annotations

# MXINT shared-exponent block: one scale per 32 codes along K. The
# quantizer and the matmul kernels' scale indexing both assume it.
MXINT_BLOCK = 32

# packed4 container: two 4-bit codes per byte along the row (weights) or
# slot (KV cache) axis, so those counts must be even.
PACKED4_ALIGN = 2

# --- K1/K2 (kernels/csrc/mxint_matmul.cu) ---------------------------------
# Each thread reads four neighbouring output columns as one 32-bit word.
QLR_COL_VEC = 4
# Largest low-rank width: the fused kernel keeps x·L for two rank
# entries per lane of a warp.
QLR_MAX_RANK = 64
# Rows above which the wrapper takes K2 (x·L precomputed outside) —
# the same threshold as the JAX dispatch (kernels/ops.py:196-198).
QLR_FUSED_MAX_ROWS = 128
# K rows one block reduces before the split-K partials are summed.
QLR_SPLIT_ROWS = 512

# --- K3/K4 (kernels/csrc/decode_attention.cu, flash_attention.cu) ---------
# One thread per head-dim column in the P·V product of a 128-thread block.
ATTN_MAX_HEAD_DIM = 128
ATTN_HEAD_DIM_ALIGN = 8
# K3 keeps one accumulator per query head of a KV group in registers.
DECODE_MAX_GROUP = 8


def check_head_dim(hd: int) -> None:
    if hd > ATTN_MAX_HEAD_DIM or hd % ATTN_HEAD_DIM_ALIGN:
        raise ValueError(
            f"head_dim={hd} unsupported: the attention kernels take at most "
            f"{ATTN_MAX_HEAD_DIM} and a multiple of {ATTN_HEAD_DIM_ALIGN}")
