"""GQA attention over the head-major slot cache (port of the full-
attention parts of ``repro/models/attention.py``).

Cache per layer (unpaged, full attention):
  ``k``/``v``  (B, KV, S, hd) in f32 or bf16, int8 codes, or the packed4
               int4 container (B, KV, S/2, hd) uint8 — two slots per byte
               along the slot axis, slot 2j in the low nibble;
  ``k_scale``/``v_scale`` (B, KV, S) f32 for int8/int4;
  ``slot_pos`` (B, S) int32 — the position each slot holds, -1 empty;
  ``pos``      (B,) int32 — the row's next write position.

Rows decode independently: each writes at its own slot and masks against
its own slot map. Unlike the JAX package, whose caches are immutable
pytrees, a decode step writes its token into the cache tensors in place
(one K/V row per batch row instead of a copy of the whole cache);
prefill builds fresh tensors.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.decode_attention import NEG_INF, decode_attention_op
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)
from repro_torch.models.layers import apply_rope
from repro_torch.models.linear import Ctx, fused_mode, linear
from repro_torch.quant.mxint import pack_codes_4bit, unpack_codes_4bit

INT4 = "int4"   # kv-cache dtype sentinel: packed4 nibble container


class Attention(nn.Module):
    def __init__(self, wq: nn.Module, wk: nn.Module, wv: nn.Module,
                 wo: nn.Module):
        super().__init__()
        self.wq, self.wk, self.wv, self.wo = wq, wk, wv, wo


def init_attn_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                    device) -> Dict[str, torch.Tensor]:
    """Zeroed head-major pages for ``batch`` rows of ``max_len`` slots.
    ``dtype=torch.int8`` is the int8 cache (codes + scales), ``"int4"``
    the packed4 one, whose slot count rounds up to even so byte pairs
    never straddle the end."""
    packed4 = dtype == INT4
    kv, hd = cfg.n_kv_heads, cfg.head_dim_
    slots = max_len + (max_len % 2 if packed4 else 0)
    if packed4:
        pshape, pdtype = (batch, kv, slots // 2, hd), torch.uint8
    else:
        pshape, pdtype = (batch, kv, slots, hd), dtype
    cache = {
        "k": torch.zeros(pshape, dtype=pdtype, device=device),
        "v": torch.zeros(pshape, dtype=pdtype, device=device),
        "slot_pos": torch.full((batch, slots), -1, dtype=torch.int32,
                               device=device),
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
    }
    if dtype == torch.int8 or packed4:
        cache["k_scale"] = torch.zeros((batch, kv, slots), device=device)
        cache["v_scale"] = torch.zeros((batch, kv, slots), device=device)
    return cache


def kv_quantize(x: torch.Tensor, qmax: int = 127
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, S, KV, hd) → symmetric int codes in [-qmax, qmax] + per-(B, S,
    KV) f32 scale. ``qmax=127`` is the int8 cache, ``qmax=7`` the int4."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1).clamp_min(1e-8) / qmax
    codes = torch.clamp(torch.round(xf / scale[..., None]), -qmax, qmax)
    return codes.to(torch.int8), scale


def kv_dequantize(codes: torch.Tensor, scale: torch.Tensor,
                  dtype) -> torch.Tensor:
    return codes.to(dtype) * scale[..., None].to(dtype)


def _cache_kv(cache: Dict, dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """The cache's K/V in ``dtype``, dequantized (the ``fused="off"``
    path)."""
    if "k_scale" in cache:
        k, v = cache["k"], cache["v"]
        if k.dtype == torch.uint8:
            k, v = unpack_codes_4bit(k), unpack_codes_4bit(v)
        return (kv_dequantize(k, cache["k_scale"], dtype),
                kv_dequantize(v, cache["v_scale"], dtype))
    return cache["k"].to(dtype), cache["v"].to(dtype)


def _qkv(ctx: Ctx, p: Attention, x: torch.Tensor, cfg: ModelConfig,
         positions: torch.Tensor):
    b, s, _ = x.shape
    hd = cfg.head_dim_
    q = linear(ctx, p.wq, x).reshape(b, s, cfg.n_heads, hd)
    k = linear(ctx, p.wk, x).reshape(b, s, cfg.n_kv_heads, hd)
    v = linear(ctx, p.wv, x).reshape(b, s, cfg.n_kv_heads, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    g = cfg.n_heads // cfg.n_kv_heads
    return q.reshape(b, s, cfg.n_kv_heads, g, hd), k, v


def _populate_kv_cache(cache: Dict, k: torch.Tensor, v: torch.Tensor,
                       lengths: torch.Tensor) -> Dict:
    """Fresh cache tensors holding each row's valid prefix of the
    prefilled (B, S, KV, hd) K/V: slot j holds the latest position
    p ≡ j (mod slots) with p < length (p = j for a full-attention cache
    of at least S slots), or is empty (slot_pos = -1)."""
    b, s = k.shape[:2]
    slots = cache["slot_pos"].shape[1]
    j = torch.arange(slots, device=k.device)[None, :]
    last = lengths.to(torch.int64)[:, None] - 1
    p = j + slots * torch.div(last - j, slots, rounding_mode="floor")
    valid = p >= 0
    idx = p.clamp(0, s - 1)

    def gather(src):  # (B, S, ...) → (B, slots, ...)
        ix = idx.reshape(idx.shape + (1,) * (src.ndim - 2))
        return torch.take_along_dim(src, ix, dim=1)

    out = dict(cache)
    packed4 = cache["k"].dtype == torch.uint8
    if "k_scale" in cache:
        qmax = 7 if packed4 else 127
        k, ksc = kv_quantize(k, qmax)
        v, vsc = kv_quantize(v, qmax)
        m3 = valid[..., None]
        out["k_scale"] = torch.where(m3, gather(ksc), 0.0).transpose(1, 2) \
            .contiguous()
        out["v_scale"] = torch.where(m3, gather(vsc), 0.0).transpose(1, 2) \
            .contiguous()

    def to_pages(src, page_dtype):
        hm = torch.where(valid[..., None, None], gather(src),
                         torch.zeros((), dtype=src.dtype, device=src.device)
                         ).transpose(1, 2)               # (B, KV, slots, hd)
        if packed4:
            return pack_codes_4bit(hm).contiguous()
        return hm.to(page_dtype).contiguous()

    out["k"] = to_pages(k, cache["k"].dtype)
    out["v"] = to_pages(v, cache["v"].dtype)
    out["slot_pos"] = torch.where(valid, p, -1).to(torch.int32)
    out["pos"] = lengths.to(torch.int32)
    return out


def attention_seq(ctx: Ctx, p: Attention, x: torch.Tensor, cfg: ModelConfig,
                  cache: Optional[Dict] = None,
                  lengths: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Prefill attention over a full (right-padded) sequence; with a
    cache, populate each row's valid prefix (``lengths``)."""
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32, device=x.device)
    q, k, v = _qkv(ctx, p, x, cfg, positions)
    if fused_mode(ctx) == "off":
        out = flash_attention_plain(q, k, v, positions, positions)
    else:
        out = flash_attention(q, k, v, positions, positions)
    y = linear(ctx, p.wo, out.reshape(b, s, cfg.n_heads * cfg.head_dim_))
    if cache is not None:
        if lengths is None:
            lengths = torch.full((b,), s, dtype=torch.int32, device=x.device)
        cache = _populate_kv_cache(cache, k, v, lengths)
    return y, cache


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     q_pos: torch.Tensor, k_pos: torch.Tensor) -> torch.Tensor:
    """Single-token attention over a dequantized cache — the
    ``fused="off"`` baseline. q (B, 1, KV, G, hd); k, v (B, KV, S, hd)."""
    hd = q.shape[-1]
    s = torch.einsum("bqkgd,bksd->bkgqs", q.float(), k.float()) / (hd ** 0.5)
    mask = (k_pos >= 0) & (k_pos <= q_pos[:, None])            # (B, S)
    s = torch.where(mask[:, None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    p = torch.where(mask.any(-1)[:, None, None, None, None], p, 0.0)
    return torch.einsum("bkgqs,bksd->bqkgd", p, v.float()).to(q.dtype)


def _write_nibble(pages: torch.Tensor, codes: torch.Tensor,
                  rows: torch.Tensor, slot: torch.Tensor) -> None:
    """Write one token's int4 codes (B, KV, hd) into the packed4 pages at
    each row's logical ``slot``, in place; the pair nibble is kept."""
    byte = pages[rows, :, slot // 2]                          # (B, KV, hd)
    u = (codes.to(torch.int32) & 0xF).to(torch.uint8)
    lo = (slot % 2 == 0)[:, None, None]
    pages[rows, :, slot // 2] = torch.where(lo, (byte & 0xF0) | u,
                                            (byte & 0x0F) | (u << 4))


def attention_step(ctx: Ctx, p: Attention, x: torch.Tensor, cache: Dict,
                   cfg: ModelConfig) -> Tuple[torch.Tensor, Dict]:
    """One decode step, x: (B, 1, D). Writes each row's token into its
    slot in place, then attends over the updated cache."""
    b = x.shape[0]
    hd = cfg.head_dim_
    pos = cache["pos"]                                        # (B,) int32
    q, k, v = _qkv(ctx, p, x, cfg, pos[:, None])
    rows = torch.arange(b, device=x.device)
    slots = cache["slot_pos"].shape[1]
    slot = torch.clamp(pos, max=slots - 1).to(torch.int64)
    packed4 = cache["k"].dtype == torch.uint8
    if "k_scale" in cache:
        qmax = 7 if packed4 else 127
        k, ksc = kv_quantize(k, qmax)
        v, vsc = kv_quantize(v, qmax)
        cache["k_scale"][rows, :, slot] = ksc[:, 0]
        cache["v_scale"][rows, :, slot] = vsc[:, 0]
    if packed4:
        _write_nibble(cache["k"], k[:, 0], rows, slot)
        _write_nibble(cache["v"], v[:, 0], rows, slot)
    else:
        cache["k"][rows, :, slot] = k[:, 0].to(cache["k"].dtype)
        cache["v"][rows, :, slot] = v[:, 0].to(cache["v"].dtype)
    cache["slot_pos"][rows, slot] = pos
    cache["pos"] = pos + 1

    if fused_mode(ctx) == "off":
        kd, vd = _cache_kv(cache, x.dtype)
        out = decode_attention(q, kd, vd, pos, cache["slot_pos"])
    else:
        out = decode_attention_op(
            q[:, 0], cache["k"], cache["v"], pos, cache["slot_pos"],
            k_scale=cache.get("k_scale"),
            v_scale=cache.get("v_scale"))[:, None].to(x.dtype)
    y = linear(ctx, p.wo, out.reshape(b, 1, cfg.n_heads * hd))
    return y, cache
