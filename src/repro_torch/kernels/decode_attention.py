"""K3 and K5: single-query flash-decode attention over the head-major
slot cache (K3) and over the paged cache through a block table (K5).

Port of ``repro/kernels/decode_attention.py::flash_decode_bkgd`` and
``::flash_decode_paged``, of ``repro/kernels/ops.py::gather_pages`` and
of both branches of ``ops.decode_attention_op``. The CUDA source of both
kernels is ``csrc/decode_attention.cu``; its header says what bounds
them and how.

The cache is ``(B, KV, S, hd)`` in f32 or bf16, int8 codes with
``(B, KV, S)`` f32 scales, or the packed4 container ``(B, KV, S/2, hd)``
uint8 (two slots per byte along the slot axis) with the same scales.
Scales fold into the score and probability columns; a row with no valid
slot outputs zeros. The kernel masks the ragged tail of the slot axis
itself, so the wrapper pads nothing (the TPU wrapper padded S to its
block size).

On the card the slot axis is split across blocks (flash-decoding):
:func:`decode_splits` picks the split count, each split leaves f32
partials ``(m, l, acc)`` in scratch this module allocates, and a second
kernel merges them as :func:`combine_splits_plain` does. A group of more
than ``DECODE_BLOCK_GROUP`` query heads a KV head is split across
:func:`group_blocks` blocks too, each over its own heads. The launch
counts stay one per wrapper call.

The route is explicit (``latent=``). The GQA route takes V as wide as K,
in its own tensor, at a head dim up to 128, or (unpaged) up to 256:
K3's wide instance (recurrentgemma-9b's local layers: hd 256, one KV
head, G = 16), 8 heads a block as at 128, aiming at
``DECODE_WIDE_BLOCKS_PER_SM`` blocks an SM. The latent route (MLA's
absorbed decode: head dim r + pe = 576 over one KV head, ``scale``
1/√(hd + pe)) takes K3's latent instance, which reads an f32 or bf16
cache whose V is K's first dv ≤ 512 columns — ``v`` must be the view
``k[..., :dv]`` of the same storage, so each row is loaded once — and
returns (B, KV, G, dv). A group there takes
``DECODE_LATENT_BLOCK_GROUP`` heads a block. Anything neither route
takes raises.

Paged (``block_table`` given): k/v are page pools ``(P, KV, ps, hd)``
(packed4 ``(P, KV, ps/2, hd)`` uint8), the scales ``(P, KV, ps)``, and
row b's logical slot j lives in page ``block_table[b, j // ps]``, row
``j % ps``; ``k_pos`` covers the ``nb·ps`` logical slots.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.constraints import (ATTN_HEAD_DIM_ALIGN,
                                             ATTN_MAX_HEAD_DIM,
                                             ATTN_WIDE_HEAD_DIM,
                                             CUDA_MAX_GRID_YZ,
                                             DECODE_BLOCK_GROUP,
                                             DECODE_BLOCKS_PER_SM,
                                             DECODE_LATENT_BLOCK_GROUP,
                                             DECODE_LATENT_BLOCKS_PER_SM,
                                             DECODE_LATENT_MAX_DV,
                                             DECODE_MAX_GROUP,
                                             DECODE_MAX_SPLIT_TILES,
                                             DECODE_TILE_SLOTS,
                                             DECODE_WIDE_BLOCKS_PER_SM,
                                             KV_PTR_ALIGN,
                                             PACKED4_ALIGN, check_head_dim,
                                             check_decode_head_dim,
                                             refuse_grad, runs_plain,
                                             validate_page_size)
from repro_torch.quant.mxint import unpack_codes_4bit

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)

# launches of the kernel since the last reset; a plain count per wrapper
LAUNCHES = {"flash_decode": 0, "flash_decode_paged": 0}

_KV_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
            torch.uint8: 3}


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           q_pos: torch.Tensor, k_pos: torch.Tensor,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None,
                           window: int = 0,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Plain version of K3: q (B, KV, G, hd) → (B, KV, G, dv) in q.dtype,
    where v (B, KV, S, dv) may be narrower than k (the latent head)."""
    hd = q.shape[-1]
    if k.dtype == torch.uint8:      # packed4: two slots per byte on axis -2
        k, v = unpack_codes_4bit(k), unpack_codes_4bit(v)
    if scale is None:
        scale = 1.0 / (hd ** 0.5)
    s = torch.einsum("bkgd,bksd->bkgs", q.float(), k.float())
    if k_scale is not None:
        s = s * k_scale.float()[:, :, None, :]
    s = s * scale
    mask = (k_pos >= 0) & (k_pos <= q_pos[:, None])            # (B, S)
    if window > 0:
        mask = mask & (q_pos[:, None] - k_pos < window)
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    p = torch.where(mask.any(-1)[:, None, None, None], p, 0.0)
    if v_scale is not None:
        p = p * v_scale.float()[:, :, None, :]
    return torch.einsum("bkgs,bksd->bkgd", p, v.float()).to(q.dtype)


def combine_splits_plain(m: torch.Tensor, l: torch.Tensor,
                         acc: torch.Tensor) -> torch.Tensor:
    """Plain version of the combine kernel: merge per-split partials of an
    online softmax, in split order. ``m``/``l`` (..., splits) are each
    split's running max and sum (``NEG_INF`` / 0 for a split with no valid
    slot), ``acc`` (..., splits, hd) its unnormalized ``Σ p·v``. Returns
    ``Σ acc·e^(m−M) / Σ l·e^(m−M)`` in f32, zeros where every split is
    empty (the empty-row rule)."""
    mx = m.amax(-1, keepdim=True)
    live = mx > 0.5 * NEG_INF
    w = torch.where(live, torch.exp(m - mx), 0.0)
    den = (l * w).sum(-1, keepdim=True)
    num = (acc * w[..., None]).sum(-2)
    return torch.where(den > 0, num / den.clamp_min(1e-30), 0.0)


def group_blocks(g: int, latent: bool = False) -> int:
    """Blocks a KV head's group of ``g`` query heads takes: each holds
    accumulators for at most ``DECODE_BLOCK_GROUP`` heads
    (``DECODE_LATENT_BLOCK_GROUP`` in the latent instance)."""
    per = DECODE_LATENT_BLOCK_GROUP if latent else DECODE_BLOCK_GROUP
    return -(-g // per)


def decode_splits(rows: int, slots: int, sm_count: int,
                  per_sm: int = DECODE_BLOCKS_PER_SM) -> Tuple[int, int]:
    """(splits, tiles per split) for ``rows`` = B·KV·:func:`group_blocks`
    blocks over ``slots`` logical slots: about ``per_sm`` blocks per SM
    (``DECODE_BLOCKS_PER_SM``; the latent instance's shared memory holds
    ``DECODE_LATENT_BLOCKS_PER_SM``), at most ``DECODE_MAX_SPLIT_TILES``
    tiles a split, whole tiles only, and never more splits than tiles (so
    no split is shorter than one tile)."""
    tiles = -(-slots // DECODE_TILE_SLOTS)
    want = -(-per_sm * sm_count // rows)
    splits = max(1, min(want, tiles), -(-tiles // DECODE_MAX_SPLIT_TILES))
    per = -(-tiles // splits)
    return -(-tiles // per), per


def blocks_per_sm(hd: int, latent: bool) -> int:
    """The blocks an SM the split plan aims at: the latent and the wide
    instances' shared memory holds fewer than the narrow one's."""
    if latent:
        return DECODE_LATENT_BLOCKS_PER_SM
    return DECODE_WIDE_BLOCKS_PER_SM if hd > ATTN_MAX_HEAD_DIM \
        else DECODE_BLOCKS_PER_SM


def _scratch(q: torch.Tensor, slots: int, dv: int, latent: bool) -> tuple:
    """(splits, tiles per split, m, l, acc) for q's device and ``dv``
    output columns: the split plan and the combine's f32 scratch, None
    with one split. Freed after the launch, the scratch goes back to the
    caching allocator in stream order, so the kernels still own it while
    they run."""
    b, kvh, g, hd = q.shape
    splits, per = decode_splits(
        b * kvh * group_blocks(g, latent), slots,
        _build.sm_count(q.device.index or 0), blocks_per_sm(hd, latent))
    if splits > CUDA_MAX_GRID_YZ:
        raise ValueError(f"{slots} slots need {splits} splits, over the grid "
                         f"limit {CUDA_MAX_GRID_YZ}")
    if splits == 1:
        return splits, per, None, None, None
    m = torch.empty((b, kvh, splits, g), dtype=torch.float32, device=q.device)
    return (splits, per, m, torch.empty_like(m),
            torch.empty((b, kvh, splits, g, dv), dtype=torch.float32,
                        device=q.device))


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _check_decode_args(q, k, v, k_scale, v_scale, rows: int,
                       slots: int, max_hd: int = ATTN_MAX_HEAD_DIM) -> None:
    """The checks K3's GQA route and K5 share; ``rows`` × ``slots`` is the
    leading shape of k/v (B × S for K3, P × ps for K5); ``max_hd`` the
    route's widest head."""
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if k.dtype not in _KV_KIND or v.dtype != k.dtype:
        raise TypeError(f"k/v must share one of {list(_KV_KIND)}, got "
                        f"{k.dtype}/{v.dtype}")
    _, kvh, g, hd = q.shape
    packed = k.dtype == torch.uint8
    quantized = k.dtype in (torch.int8, torch.uint8)
    check_head_dim(hd, max_hd)
    if g > DECODE_MAX_GROUP:
        raise ValueError(f"G={g} query heads per KV head exceeds "
                         f"{DECODE_MAX_GROUP}")
    if packed and slots % PACKED4_ALIGN:
        raise ValueError("packed4 pages need an even slot count")
    page = (rows, kvh, slots // (2 if packed else 1), hd)
    if k.shape != page or v.shape != page:
        raise ValueError(f"k/v {tuple(k.shape)}/{tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if k.data_ptr() % KV_PTR_ALIGN or v.data_ptr() % KV_PTR_ALIGN:
        raise ValueError(f"k/v must start {KV_PTR_ALIGN}-byte aligned (the "
                         f"kernel loads rows as vectors)")
    if quantized != (k_scale is not None) or (k_scale is None) != (v_scale is None):
        raise ValueError("k/v scales go with int8/packed4 pages, and only "
                         "with them")
    if quantized:
        for t in (k_scale, v_scale):
            if t.dtype != torch.float32 or t.shape != (rows, kvh, slots):
                raise ValueError(f"scales must be float32 {(rows, kvh, slots)}"
                                 f", got {t.dtype} {tuple(t.shape)}")


def _check_latent_args(q, k, v, k_scale, v_scale, rows: int,
                       slots: int) -> int:
    """K3's latent instance: an
    f32/bf16 cache ``k`` (rows, KV, slots, hd), contiguous, and ``v`` the
    view of its first dv columns (same storage, same strides, dv at most
    ``DECODE_LATENT_MAX_DV`` and a multiple of 8). Returns dv."""
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if k.dtype not in (torch.float32, torch.bfloat16) or v.dtype != k.dtype:
        raise TypeError(f"the latent head takes an f32 or bf16 cache, got "
                        f"{k.dtype}/{v.dtype}")
    if k_scale is not None or v_scale is not None:
        raise ValueError("the latent head takes no k/v scales")
    _, kvh, g, hd = q.shape
    check_decode_head_dim(hd)
    if g > DECODE_MAX_GROUP:
        raise ValueError(f"G={g} query heads per KV head exceeds "
                         f"{DECODE_MAX_GROUP}")
    if k.shape != (rows, kvh, slots, hd) or not k.is_contiguous():
        raise ValueError(f"k {tuple(k.shape)} must be a contiguous "
                         f"{(rows, kvh, slots, hd)} cache")
    dv = v.shape[-1]
    if (v.shape[:-1] != k.shape[:-1] or v.stride() != k.stride()
            or v.data_ptr() != k.data_ptr()
            or dv > min(hd, DECODE_LATENT_MAX_DV) or dv % ATTN_HEAD_DIM_ALIGN):
        raise ValueError(
            f"at head dim {hd} v must be k's first dv columns (k[..., :dv], "
            f"dv <= {DECODE_LATENT_MAX_DV}, a multiple of "
            f"{ATTN_HEAD_DIM_ALIGN}), got v {tuple(v.shape)} strides "
            f"{v.stride()}")
    if k.data_ptr() % KV_PTR_ALIGN:
        raise ValueError(f"k must start {KV_PTR_ALIGN}-byte aligned (the "
                         f"kernel loads rows as vectors)")
    return dv


def _check_rows(rows: int) -> None:
    """The kernel keeps each valid slot's flat row as a 32-bit int."""
    if rows >= 2 ** 31:
        raise ValueError(f"{rows} cache rows exceed the kernel's 32-bit row "
                         f"index")


def _check_on_one_device(what: str, q, *tensors) -> None:
    for t in tensors:
        if t is not None and (t.device != q.device or not t.is_contiguous()):
            raise ValueError(f"{what} needs contiguous tensors on one device")


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 q_pos: torch.Tensor, k_pos: torch.Tensor,
                 k_scale: Optional[torch.Tensor] = None,
                 v_scale: Optional[torch.Tensor] = None, window: int = 0,
                 scale: Optional[float] = None,
                 latent: bool = False) -> torch.Tensor:
    """Launch K3; raises on anything the kernel does not take. The
    latent route (module docstring) returns ``v``'s dv columns."""
    b, kvh, g, hd = q.shape
    packed = k.dtype == torch.uint8
    s_len = k.shape[2] * (2 if packed else 1)
    if latent:
        dv = _check_latent_args(q, k, v, k_scale, v_scale, b, s_len)
    else:
        _check_decode_args(q, k, v, k_scale, v_scale, b, s_len,
                           ATTN_WIDE_HEAD_DIM)
        dv = hd
    q_pos = q_pos.to(torch.int32).contiguous()
    k_pos = k_pos.to(torch.int32).contiguous()
    if q_pos.shape != (b,) or k_pos.shape != (b, s_len):
        raise ValueError(f"q_pos {tuple(q_pos.shape)} / k_pos "
                         f"{tuple(k_pos.shape)} must be ({b},) / ({b}, {s_len})")
    # the latent head's v is a strided view of k (checked above)
    _check_on_one_device("flash_decode", q, k, None if latent else v, q_pos,
                         k_pos, k_scale, v_scale)
    if scale is None:
        scale = 1.0 / (hd ** 0.5)
    _check_rows(b * kvh * s_len)
    out = torch.empty((b, kvh, g, dv), dtype=q.dtype, device=q.device)
    splits, per, m_p, l_p, acc_p = _scratch(q, s_len, dv, latent)
    fn = _build.function("decode_attention", "flash_decode_launch", 11, 12, 1)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(k_scale),
             _ptr(v_scale), q_pos.data_ptr(), k_pos.data_ptr(),
             out.data_ptr(), _ptr(m_p), _ptr(l_p), _ptr(acc_p),
             b, kvh, g, s_len, hd, dv, int(latent), window, _KV_KIND[k.dtype],
             int(q.dtype == torch.bfloat16), splits, per, float(scale),
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_decode_launch (K3)")
    LAUNCHES["flash_decode"] += 1
    return out


def gather_pages(pool: torch.Tensor, block_table: torch.Tensor
                 ) -> torch.Tensor:
    """The logical head-major view of a paged pool: pool ``(P, KV, ps,
    ...)`` + table ``(B, nb)`` → ``(B, KV, nb·ps, ...)``. Works for K/V
    pools (trailing hd axis; packed4 byte rows concatenate along the
    packed slot axis, since pages hold whole pairs) and for the
    ``(P, KV, ps)`` scale pools. A copy: the plain version's one gather
    per step; K5 never builds it."""
    g = pool[block_table.long()]               # (B, nb, KV, ps, ...)
    g = g.movedim(2, 1)                        # (B, KV, nb, ps, ...)
    return g.reshape(g.shape[:2] + (g.shape[2] * g.shape[3],) + g.shape[4:])


def decode_attention_paged_plain(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, q_pos: torch.Tensor,
                                 k_pos: torch.Tensor,
                                 block_table: torch.Tensor,
                                 k_scale: Optional[torch.Tensor] = None,
                                 v_scale: Optional[torch.Tensor] = None,
                                 window: int = 0,
                                 scale: Optional[float] = None
                                 ) -> torch.Tensor:
    """Plain version of K5: :func:`gather_pages`, then K3's plain
    version on the logical view."""
    if k_scale is not None:
        k_scale = gather_pages(k_scale, block_table)
        v_scale = gather_pages(v_scale, block_table)
    return decode_attention_plain(q, gather_pages(k, block_table),
                                  gather_pages(v, block_table), q_pos, k_pos,
                                  k_scale, v_scale, window, scale)


def flash_decode_paged(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       q_pos: torch.Tensor, k_pos: torch.Tensor,
                       block_table: torch.Tensor,
                       k_scale: Optional[torch.Tensor] = None,
                       v_scale: Optional[torch.Tensor] = None,
                       window: int = 0,
                       scale: Optional[float] = None) -> torch.Tensor:
    """Launch K5; raises on anything the kernel does not take. Every
    table entry must be a page id of the pool (the serving layer parks
    unused entries on a private page); the kernel does not check."""
    b, kvh, g, hd = q.shape
    packed = k.dtype == torch.uint8
    n_pages = k.shape[0]
    ps = k.shape[2] * (2 if packed else 1)
    validate_page_size(ps)
    _check_decode_args(q, k, v, k_scale, v_scale, n_pages, ps)
    block_table = block_table.to(torch.int32).contiguous()
    if block_table.ndim != 2 or block_table.shape[0] != b:
        raise ValueError(f"block_table {tuple(block_table.shape)} must be "
                         f"({b}, nb)")
    nb = block_table.shape[1]
    q_pos = q_pos.to(torch.int32).contiguous()
    k_pos = k_pos.to(torch.int32).contiguous()
    if q_pos.shape != (b,) or k_pos.shape != (b, nb * ps):
        raise ValueError(f"q_pos {tuple(q_pos.shape)} / k_pos "
                         f"{tuple(k_pos.shape)} must be ({b},) / "
                         f"({b}, {nb * ps})")
    _check_on_one_device("flash_decode_paged", q, k, v, q_pos, k_pos,
                         block_table, k_scale, v_scale)
    if scale is None:
        scale = 1.0 / (hd ** 0.5)
    _check_rows(n_pages * kvh * ps)
    out = torch.empty_like(q)
    splits, per, m_p, l_p, acc_p = _scratch(q, nb * ps, hd, False)
    fn = _build.function("decode_attention", "flash_decode_paged_launch", 12,
                         11, 1)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(k_scale),
             _ptr(v_scale), q_pos.data_ptr(), k_pos.data_ptr(),
             block_table.data_ptr(), out.data_ptr(), _ptr(m_p), _ptr(l_p),
             _ptr(acc_p), b, kvh, g, nb, ps, hd, window, _KV_KIND[k.dtype],
             int(q.dtype == torch.bfloat16), splits, per, float(scale),
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_decode_paged_launch (K5)")
    LAUNCHES["flash_decode_paged"] += 1
    return out


def decode_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        q_pos: torch.Tensor, k_pos: torch.Tensor, *,
                        k_scale: Optional[torch.Tensor] = None,
                        v_scale: Optional[torch.Tensor] = None,
                        window: int = 0,
                        scale: Optional[float] = None,
                        block_table: Optional[torch.Tensor] = None,
                        latent: bool = False) -> torch.Tensor:
    """Single-query attention over the slot cache, or over the page pools
    through ``block_table``: the plain version for CPU tensors, K3 (K5
    when paged) for CUDA tensors. ``scale`` overrides 1/√hd. ``latent``
    (unpaged) picks K3's route (module docstring): ``v`` is then ``k``'s
    first dv columns, and the output has dv. Raises for an operand that
    requires grad (``constraints.refuse_grad``)."""
    refuse_grad("K3/K5 (decode_attention_op)", q, k, v, k_scale, v_scale)
    if block_table is not None:
        if runs_plain(q):
            return decode_attention_paged_plain(q, k, v, q_pos, k_pos,
                                                block_table, k_scale, v_scale,
                                                window, scale)
        return flash_decode_paged(q, k, v, q_pos, k_pos, block_table, k_scale,
                                  v_scale, window, scale)
    if runs_plain(q):
        return decode_attention_plain(q, k, v, q_pos, k_pos, k_scale,
                                      v_scale, window, scale)
    return flash_decode(q, k, v, q_pos, k_pos, k_scale, v_scale, window,
                        scale, latent)
