"""K3: single-query flash-decode attention over the head-major slot cache.

Port of ``repro/kernels/decode_attention.py::flash_decode_bkgd`` and of
the unpaged branch of ``repro/kernels/ops.py::decode_attention_op``. The
CUDA source is ``csrc/decode_attention.cu``; its header says what bounds
it and how.

The cache is ``(B, KV, S, hd)`` in f32 or bf16, int8 codes with
``(B, KV, S)`` f32 scales, or the packed4 container ``(B, KV, S/2, hd)``
uint8 (two slots per byte along the slot axis) with the same scales.
Scales fold into the score and probability columns; a row with no valid
slot outputs zeros. The kernel masks the ragged tail of the slot axis
itself, so the wrapper pads nothing (the TPU wrapper padded S to its
block size).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.constraints import (DECODE_MAX_GROUP, PACKED4_ALIGN,
                                             check_head_dim)
from repro_torch.quant.mxint import unpack_codes_4bit

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)

# launches of the kernel since the last reset; a plain count per wrapper
LAUNCHES = {"flash_decode": 0}

_KV_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
            torch.uint8: 3}


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           q_pos: torch.Tensor, k_pos: torch.Tensor,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None,
                           window: int = 0,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Plain version of K3: q (B, KV, G, hd) → (B, KV, G, hd) in q.dtype."""
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


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 q_pos: torch.Tensor, k_pos: torch.Tensor,
                 k_scale: Optional[torch.Tensor] = None,
                 v_scale: Optional[torch.Tensor] = None, window: int = 0,
                 scale: Optional[float] = None) -> torch.Tensor:
    """Launch K3; raises on anything the kernel does not take."""
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if k.dtype not in _KV_KIND or v.dtype != k.dtype:
        raise TypeError(f"k/v must share one of {list(_KV_KIND)}, got "
                        f"{k.dtype}/{v.dtype}")
    b, kvh, g, hd = q.shape
    packed = k.dtype == torch.uint8
    quantized = k.dtype in (torch.int8, torch.uint8)
    s_len = k.shape[2] * (2 if packed else 1)
    check_head_dim(hd)
    if g > DECODE_MAX_GROUP:
        raise ValueError(f"G={g} query heads per KV head exceeds "
                         f"{DECODE_MAX_GROUP}")
    page = (b, kvh, s_len // (2 if packed else 1), hd)
    if k.shape != page or v.shape != page:
        raise ValueError(f"k/v {tuple(k.shape)}/{tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if packed and s_len % PACKED4_ALIGN:
        raise ValueError("packed4 pages need an even slot count")
    if quantized != (k_scale is not None) or (k_scale is None) != (v_scale is None):
        raise ValueError("k/v scales go with int8/packed4 pages, and only "
                         "with them")
    q_pos = q_pos.to(torch.int32).contiguous()
    k_pos = k_pos.to(torch.int32).contiguous()
    tensors = [q, k, v, q_pos, k_pos]
    if quantized:
        for t in (k_scale, v_scale):
            if t.dtype != torch.float32 or t.shape != (b, kvh, s_len):
                raise ValueError(f"scales must be float32 {(b, kvh, s_len)}, "
                                 f"got {t.dtype} {tuple(t.shape)}")
        tensors += [k_scale, v_scale]
    if q_pos.shape != (b,) or k_pos.shape != (b, s_len):
        raise ValueError(f"q_pos {tuple(q_pos.shape)} / k_pos "
                         f"{tuple(k_pos.shape)} must be ({b},) / ({b}, {s_len})")
    for t in tensors:
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("flash_decode needs contiguous tensors on one "
                             "device")
    if scale is None:
        scale = 1.0 / (hd ** 0.5)
    out = torch.empty_like(q)
    fn = _build.function("decode_attention", "flash_decode_launch", 8, 8, 1)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
             k_scale.data_ptr() if quantized else None,
             v_scale.data_ptr() if quantized else None,
             q_pos.data_ptr(), k_pos.data_ptr(), out.data_ptr(),
             b, kvh, g, s_len, hd, window, _KV_KIND[k.dtype],
             int(q.dtype == torch.bfloat16), float(scale),
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_decode_launch (K3)")
    LAUNCHES["flash_decode"] += 1
    return out


def decode_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        q_pos: torch.Tensor, k_pos: torch.Tensor, *,
                        k_scale: Optional[torch.Tensor] = None,
                        v_scale: Optional[torch.Tensor] = None,
                        window: int = 0,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Single-query attention over the slot cache: the plain version for
    CPU tensors, K3 for CUDA tensors. ``scale`` overrides 1/√hd."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, q_pos, k_pos, k_scale,
                                      v_scale, window, scale)
    return flash_decode(q, k, v, q_pos, k_pos, k_scale, v_scale, window,
                        scale)
