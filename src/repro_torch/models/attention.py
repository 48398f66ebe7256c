"""GQA attention over the head-major slot cache, full or sliding-window,
and MLA over its latent cache (port of the full-attention, local and MLA
parts of ``repro/models/attention.py``).

Cache per layer (unpaged, full attention or a local ring):
  ``k``/``v``  (B, KV, S, hd) in f32 or bf16, int8 codes, or the packed4
               int4 container (B, KV, S/2, hd) uint8 — two slots per byte
               along the slot axis, slot 2j in the low nibble;
  ``k_scale``/``v_scale`` (B, KV, S) f32 for int8/int4;
  ``slot_pos`` (B, S) int32 — the position each slot holds, -1 empty;
  ``pos``      (B,) int32 — the row's next write position.
A local layer's ring holds S = min(window, max_len) slots (even for
int4) and writes position p at slot p mod S, so its valid slots are not
in position order once it wraps; the mask reads ``slot_pos``.

Cache per layer (paged, ``init_attn_cache(pages=, page_size=)``):
  ``k``/``v``  page pools (P, KV, ps, hd), packed4 (P, KV, ps/2, hd) uint8,
               shared by every batch row;
  ``k_scale``/``v_scale`` (P, KV, ps) f32 for int8/int4;
  ``block_table`` (B, nb) int32 — row b's logical slot j lives in page
               ``block_table[b, j // ps]``, row ``j % ps``;
  ``pos``      (B,) int32.
There is no slot map: logical slot j of a row holds position j.

Cache per MLA layer (``init_mla_cache``):
  ``lat``      (B, S, r + pe) f32 or bf16 — each token's normed latent
               ``ckv`` (its first r columns) and its RoPE'd shared key
               ``kpe`` (the last pe), in one row;
  ``pos``      (B,) int32.
Slot j holds position j. The JAX package keeps ``ckv`` and ``kpe`` in two
tensors and concatenates them (and pads ``ckv`` to r + pe) for its decode
kernel on every step; one row per token lets K3 read the row once as the
key and its first r columns as the value, in place.

Cross attention (the encoder-decoder's decoder layers): a layer's cache
dict also holds ``cross_k``/``cross_v`` (B, KV, enc_seq, hd), the
encoder memory's K/V, head-major as the self cache is (the JAX package
keeps them (B, enc_seq, KV, hd)), in the cache's float type (bf16 under
int8/int4 KV, never quantized). Prefill writes them; decode reads them
through K3 with every slot valid.

Rows decode independently: each writes at its own slot and masks against
its own slot map. Unlike the JAX package, whose caches are immutable
pytrees, a decode step and a prefill chunk write their K/V into the
cache tensors in place (one K/V row per batch row, or the chunk's rows,
instead of a copy of the whole cache); prefill builds fresh tensors.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import work
from repro_torch.kernels.constraints import validate_page_size
from repro_torch.kernels.decode_attention import (NEG_INF, decode_attention_op,
                                                  gather_pages)
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)
from repro_torch.models.layers import RMSNorm, apply_rope, rmsnorm
from repro_torch.models.linear import Ctx, fused_mode, linear, weight_of
from repro_torch.quant.mxint import pack_codes_4bit, unpack_codes_4bit

INT4 = "int4"   # kv-cache dtype sentinel: packed4 nibble container


class Attention(nn.Module):
    def __init__(self, wq: nn.Module, wk: nn.Module, wv: nn.Module,
                 wo: nn.Module):
        super().__init__()
        self.wq, self.wk, self.wv, self.wo = wq, wk, wv, wo


def init_attn_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                    device, pages: Optional[int] = None,
                    page_size: Optional[int] = None, local: bool = False
                    ) -> Dict[str, torch.Tensor]:
    """Zeroed head-major pages for ``batch`` rows of ``max_len`` slots
    (``local``: a ring of ``min(window, max_len)`` slots, position p in
    slot p mod slots). ``dtype=torch.int8`` is the int8 cache (codes +
    scales), ``"int4"`` the packed4 one, whose slot count rounds up to
    even so byte pairs never straddle the end (of the ring too).

    ``pages``/``page_size`` select the paged layout (module docstring):
    ``pages`` physical pages of ``page_size`` (even) slots shared by the
    rows, and a ``block_table`` of ``ceil(max_len / page_size)`` entries
    per row, which the serving layer fills with valid page ids."""
    packed4 = dtype == INT4
    kv, hd = cfg.n_kv_heads, cfg.head_dim_
    if pages is not None:
        if local:
            raise ValueError(
                "paged KV supports full attention only (a sliding-window "
                "ring buffer wraps inside blocks, breaking block sharing)")
        validate_page_size(page_size)
        n_blocks = -(-max_len // page_size)
        if packed4:
            pshape, pdtype = (pages, kv, page_size // 2, hd), torch.uint8
        else:
            pshape, pdtype = (pages, kv, page_size, hd), dtype
        cache = {
            "k": torch.zeros(pshape, dtype=pdtype, device=device),
            "v": torch.zeros(pshape, dtype=pdtype, device=device),
            "block_table": torch.zeros((batch, n_blocks), dtype=torch.int32,
                                       device=device),
            "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
        }
        if dtype == torch.int8 or packed4:
            cache["k_scale"] = torch.zeros((pages, kv, page_size),
                                           device=device)
            cache["v_scale"] = torch.zeros((pages, kv, page_size),
                                           device=device)
        return cache
    slots = min(cfg.window, max_len) if local else max_len
    slots += slots % 2 if packed4 else 0
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
    """q (B, S, KV, G, hd), k and v (B, S, KV, hd), RoPE'd at
    ``positions`` — in every attention call, the encoder's too, as JAX's
    ``_qkv`` has it."""
    b, s, _ = x.shape
    hd = cfg.head_dim_
    q = linear(ctx, p.wq, x, "attn.wq").reshape(b, s, cfg.n_heads, hd)
    k = linear(ctx, p.wk, x, "attn.wk").reshape(b, s, cfg.n_kv_heads, hd)
    v = linear(ctx, p.wv, x, "attn.wv").reshape(b, s, cfg.n_kv_heads, hd)
    q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_kind)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.rope_kind)
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
                  lengths: Optional[torch.Tensor] = None, local: bool = False,
                  causal: bool = True
                  ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Prefill attention over a full (right-padded) sequence; with a
    cache, populate each row's valid prefix (``lengths``). ``local``:
    sliding-window attention (``q − k < cfg.window``) into a ring cache,
    whose slots keep each row's latest positions. ``causal=False``: the
    encoder's bidirectional attention (no cache)."""
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32, device=x.device)
    q, k, v = _qkv(ctx, p, x, cfg, positions)
    out = prefill_attention(ctx, q, k, v, positions, positions,
                            causal=causal, window=cfg.window if local else 0)
    y = linear(ctx, p.wo, out.reshape(b, s, cfg.n_heads * cfg.head_dim_),
               "attn.wo")
    if cache is not None:
        if lengths is None:
            lengths = torch.full((b,), s, dtype=torch.int32, device=x.device)
        cache = _populate_kv_cache(cache, k, v, lengths)
    return y, cache


def cross_memory(ctx: Ctx, p: Attention, memory: torch.Tensor,
                 cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """The cross attention's K/V (B, enc_seq, KV, hd) of the encoder's
    output ``memory`` (B, enc_seq, D), through ``wk``/``wv`` (taps
    ``xattn.wk``/``xattn.wv``, one moment set: the same input). No RoPE,
    as in JAX's ``cross_memory``."""
    b, sm, _ = memory.shape
    hd = cfg.head_dim_
    k = linear(ctx, p.wk, memory, "xattn.wk").reshape(b, sm, cfg.n_kv_heads,
                                                      hd)
    v = linear(ctx, p.wv, memory, "xattn.wv").reshape(b, sm, cfg.n_kv_heads,
                                                      hd)
    return k, v


def cross_attention(ctx: Ctx, p: Attention, x: torch.Tensor,
                    mem_k: torch.Tensor, mem_v: torch.Tensor,
                    cfg: ModelConfig, head_major: bool = False
                    ) -> torch.Tensor:
    """The decoder's cross attention of x (B, S, D) over every slot of
    the encoder memory (no mask, no RoPE): q from ``wq``, the output
    through ``wo`` (taps ``xattn.wq``/``xattn.wo``).

    Prefill (``head_major=False``): the fresh memory K/V (B, enc_seq,
    KV, hd) from :func:`cross_memory`, through K4 with ``causal=False``
    (q_pos ``arange(S)``, k_pos ``arange(enc_seq)``). Decode
    (``head_major=True``, S = 1): the cached (B, KV, enc_seq, hd) memory,
    through K3 with q_pos ``enc_seq − 1`` on every row, which admits every
    slot (``0 ≤ k_pos ≤ q_pos``): an f32 query over the cache's bf16 as
    the self-attention decode has it, where K4 would need one dtype.
    ``fused="off"`` runs their plain versions (JAX computes both in its
    plain ``blockwise_attention``)."""
    b, s, _ = x.shape
    hd = cfg.head_dim_
    g = cfg.n_heads // cfg.n_kv_heads
    q = linear(ctx, p.wq, x, "xattn.wq").reshape(b, s, cfg.n_kv_heads, g, hd)
    sm = mem_k.shape[2] if head_major else mem_k.shape[1]
    k_pos = torch.arange(sm, dtype=torch.int32, device=x.device)
    if head_major:
        q_pos = torch.full((b,), sm - 1, dtype=torch.int32, device=x.device)
        k_pos = k_pos.expand(b, sm)
        out = work.kernel(lambda: work.decode_attention_work(
            b, cfg.n_kv_heads, g, hd, sm, kv_itemsize=mem_k.element_size(),
            q_itemsize=q.element_size()), _cross_decode, ctx, q, mem_k, mem_v,
            q_pos, k_pos)
    else:
        q_pos = torch.arange(s, dtype=torch.int32, device=x.device)
        out = prefill_attention(ctx, q, mem_k, mem_v, q_pos, k_pos,
                                causal=False)
    out = out.to(x.dtype).reshape(b, s, cfg.n_heads * hd)
    return linear(ctx, p.wo, out, "xattn.wo")


def _cross_decode(ctx: Ctx, q: torch.Tensor, mem_k: torch.Tensor,
                  mem_v: torch.Tensor, q_pos: torch.Tensor,
                  k_pos: torch.Tensor) -> torch.Tensor:
    """K3's function over the cross memory by the route ``ctx.fused``
    picks."""
    if fused_mode(ctx) == "off":
        return decode_attention(q, mem_k.to(q.dtype), mem_v.to(q.dtype),
                                q_pos, k_pos)
    return decode_attention_op(q[:, 0], mem_k, mem_v, q_pos,
                               k_pos.contiguous())[:, None]


def prefill_attention(ctx: Ctx, q: torch.Tensor, k: torch.Tensor,
                      v: torch.Tensor, q_pos: torch.Tensor,
                      k_pos: torch.Tensor, *, causal: bool = True,
                      window: int = 0, start: Optional[int] = None
                      ) -> torch.Tensor:
    """K4's function — q (B, Sq, KV, G, hd) over k, v (B, Sk, KV, hd) —
    by the route ``ctx.fused`` picks (the wrapper, or its plain version
    for ``fused="off"``), recorded for :mod:`repro_torch.launch.cost`.
    ``start``: a chunk at positions ``start…`` over [stored context ‖
    chunk], whose valid keys are the ``start`` stored ones and the chunk
    (the rest of the context is masked)."""
    def prefill_work() -> work.Work:
        b, sq, kvh, g, hd = q.shape
        sk = k.shape[1]
        return work.flash_attention_work(
            sq, kvh * g, kvh, hd, pairs=work.attention_pairs(
                sq, sk, causal=causal, window=window, start=start or 0),
            kv_rows=sk if start is None else start + sq, positions=sq + sk,
            itemsize=q.element_size(), b=b)

    attend = flash_attention_plain if fused_mode(ctx) == "off" \
        else flash_attention
    return work.kernel(prefill_work, attend, q, k, v, q_pos, k_pos,
                       causal=causal, window=window)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     q_pos: torch.Tensor, k_pos: torch.Tensor,
                     window: int = 0) -> torch.Tensor:
    """Single-token attention over a dequantized cache — the
    ``fused="off"`` baseline. q (B, 1, KV, G, hd); k, v (B, KV, S, hd);
    ``window`` > 0 also masks ``q_pos − k_pos >= window``."""
    hd = q.shape[-1]
    s = torch.einsum("bqkgd,bksd->bkgqs", q.float(), k.float()) / (hd ** 0.5)
    mask = (k_pos >= 0) & (k_pos <= q_pos[:, None])            # (B, S)
    if window > 0:
        mask = mask & (q_pos[:, None] - k_pos < window)
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


def _paged_page_size(cache: Dict) -> int:
    """Logical slots per physical page (uint8 pool rows hold two)."""
    rows = cache["k"].shape[2]
    return rows * 2 if cache["k"].dtype == torch.uint8 else rows


def _step_write_index(cache: Dict, local: bool = False
                      ) -> Tuple[torch.Tensor, ...]:
    """Where a decode step over this layer's ``cache`` writes each row's
    token: (rows, logical slot, storage row, storage slot). The storage
    row is the batch row (unpaged) or the physical page through the
    block table (paged). The slot is ``pos`` held to the last slot, or,
    on a ``local`` ring, ``pos`` mod the (even-rounded) slot count."""
    pos = cache["pos"]
    rows = torch.arange(pos.shape[0], device=pos.device)
    if "block_table" in cache:
        bt = cache["block_table"]                             # (B, nb)
        ps = _paged_page_size(cache)
        slot = torch.clamp(pos, max=bt.shape[1] * ps - 1).to(torch.int64)
        return rows, slot, bt[rows, slot // ps].to(torch.int64), slot % ps
    slots = cache["slot_pos"].shape[1]
    slot = (torch.remainder(pos, slots) if local
            else torch.clamp(pos, max=slots - 1)).to(torch.int64)
    return rows, slot, rows, slot


def save_step_writes(cache: Dict, local: bool = False) -> Dict:
    """Copies of everything a decode step over this layer's ``cache``
    overwrites: each row's K/V at its write slot (packed4: the whole
    byte, both nibbles; ``local``: the ring slot), the int8/int4 scales
    there, the unpaged ``slot_pos`` entry, and the ``pos`` tensor itself
    (a step rebinds it); of an MLA cache, each row's latent row at its
    write slot; of a recurrent state (RG-LRU ``h``/``conv``/``pos``,
    mLSTM ``C``/``n``/``m``/``pos``, sLSTM ``c``/``n``/``h``/``m``/
    ``pos``), its tensors themselves (a step rebinds every one and writes
    into none). :func:`restore_step_writes` puts them back bit for bit,
    so a shadow decode (the drift monitor's reference pass) leaves the
    cache as it found it."""
    if "k" not in cache and "lat" not in cache:
        return dict(cache)
    if "lat" in cache:
        rows, slot = _latent_write_index(cache)
        return {"pos": cache["pos"], "index": (rows, slot),
                "lat": cache["lat"][rows, slot].clone()}
    rows, slot, wrow, wslot = _step_write_index(cache, local)
    kv_slot = wslot // 2 if cache["k"].dtype == torch.uint8 else wslot
    saved = {"pos": cache["pos"], "index": (rows, slot, wrow, wslot, kv_slot)}
    for key in ("k", "v"):
        saved[key] = cache[key][wrow, :, kv_slot].clone()
    for key in ("k_scale", "v_scale"):
        if key in cache:
            saved[key] = cache[key][wrow, :, wslot].clone()
    if "slot_pos" in cache:
        saved["slot_pos"] = cache["slot_pos"][rows, slot].clone()
    return saved


def restore_step_writes(cache: Dict, saved: Dict) -> None:
    """Undo a decode step over ``cache`` from :func:`save_step_writes`'s
    copies, in place."""
    if "k" not in cache and "lat" not in cache:
        cache.update(saved)
        return
    if "lat" in cache:
        rows, slot = saved["index"]
        cache["lat"][rows, slot] = saved["lat"]
        cache["pos"] = saved["pos"]
        return
    rows, slot, wrow, wslot, kv_slot = saved["index"]
    for key in ("k", "v"):
        cache[key][wrow, :, kv_slot] = saved[key]
    for key in ("k_scale", "v_scale"):
        if key in saved:
            cache[key][wrow, :, wslot] = saved[key]
    if "slot_pos" in saved:
        cache["slot_pos"][rows, slot] = saved["slot_pos"]
    cache["pos"] = saved["pos"]


def attention_step(ctx: Ctx, p: Attention, x: torch.Tensor, cache: Dict,
                   cfg: ModelConfig, local: bool = False
                   ) -> Tuple[torch.Tensor, Dict]:
    """One decode step, x: (B, 1, D). Writes each row's token into its
    slot in place, then attends over the updated cache; ``local``: into
    its ring slot ``pos mod slots``, attending over ``q − k <
    cfg.window`` (paged caches are full attention only). A paged cache
    (``block_table`` present) writes at ``(block_table[row, pos // ps],
    pos % ps)`` and attends through the table; every table entry is a
    valid page (a retired row points at its private parked page), so a
    dead row's write never lands in a page another request owns."""
    b = x.shape[0]
    hd = cfg.head_dim_
    pos = cache["pos"]                                        # (B,) int32
    q, k, v = _qkv(ctx, p, x, cfg, pos[:, None])
    rows, slot, wrow, wslot = _step_write_index(cache, local)
    paged = "block_table" in cache
    window = cfg.window if local else 0
    if paged:
        bt = cache["block_table"]                             # (B, nb)
        nslots = bt.shape[1] * _paged_page_size(cache)
    packed4 = cache["k"].dtype == torch.uint8
    if "k_scale" in cache:
        qmax = 7 if packed4 else 127
        k, ksc = kv_quantize(k, qmax)
        v, vsc = kv_quantize(v, qmax)
        cache["k_scale"][wrow, :, wslot] = ksc[:, 0]
        cache["v_scale"][wrow, :, wslot] = vsc[:, 0]
    if packed4:
        _write_nibble(cache["k"], k[:, 0], wrow, wslot)
        _write_nibble(cache["v"], v[:, 0], wrow, wslot)
    else:
        cache["k"][wrow, :, wslot] = k[:, 0].to(cache["k"].dtype)
        cache["v"][wrow, :, wslot] = v[:, 0].to(cache["v"].dtype)
    if paged:
        spos = torch.arange(nslots, dtype=torch.int32,
                            device=x.device).expand(b, nslots)
        block_table = bt
    else:
        cache["slot_pos"][rows, slot] = pos
        spos = cache["slot_pos"]
        block_table = None
    cache["pos"] = pos + 1

    def step_work() -> work.Work:
        g = cfg.n_heads // cfg.n_kv_heads
        kw = dict(kv_itemsize=0.5 if packed4 else cache["k"].element_size(),
                  scaled="k_scale" in cache, q_itemsize=q.element_size())
        if paged:
            return work.paged_decode_work(b, cfg.n_kv_heads, g, hd,
                                          spos.shape[1], bt.numel(), **kw)
        return work.decode_attention_work(b, cfg.n_kv_heads, g, hd,
                                          spos.shape[1], **kw)

    out = work.kernel(step_work, _step_attention, ctx, q, cache, pos, spos,
                      window, block_table)
    y = linear(ctx, p.wo, out.reshape(b, 1, cfg.n_heads * hd))
    return y, cache


def _step_attention(ctx: Ctx, q: torch.Tensor, cache: Dict, pos: torch.Tensor,
                    spos: torch.Tensor, window: int,
                    block_table: Optional[torch.Tensor]) -> torch.Tensor:
    """K3's (K5's, through ``block_table``) function for a decode step by
    the route ``ctx.fused`` picks: (B, 1, KV, G, hd) in q's dtype."""
    if fused_mode(ctx) == "off":
        if block_table is not None:
            flat = {key: gather_pages(cache[key], block_table)
                    for key in ("k", "v", "k_scale", "v_scale") if key in cache}
            kd, vd = _cache_kv(flat, q.dtype)
        else:
            kd, vd = _cache_kv(cache, q.dtype)
        return decode_attention(q, kd, vd, pos, spos, window)
    return decode_attention_op(
        q[:, 0], cache["k"], cache["v"], pos, spos.contiguous(),
        k_scale=cache.get("k_scale"), v_scale=cache.get("v_scale"),
        window=window, block_table=block_table)[:, None].to(q.dtype)


def _chunk_nibble_rmw(plane: torch.Tensor, row: int,
                      bt_row: Optional[torch.Tensor], ps: int,
                      codes: torch.Tensor, start: int, length: int) -> None:
    """Merge a chunk's int4 codes (C, KV, hd) for positions ``[start,
    start+length)`` into one row's packed4 storage, in place, by a
    per-byte read-modify-write at any ``start`` parity and ``length``:
    the paged pool ``plane`` (P, KV, ps/2, hd) through the row's block
    table ``bt_row``, or (``bt_row=None``) row ``row`` of the unpaged
    (B, KV, S/2, hd) pages. Only the bytes the chunk touches are visited
    (``length`` is known on the host), and a boundary byte keeps its
    out-of-chunk partner nibble — a verify chunk starting mid-byte never
    clobbers the token stored beside it."""
    byte_idx = torch.arange(start // 2, (start + length - 1) // 2 + 1,
                            device=codes.device)
    if bt_row is None:
        page = torch.full_like(byte_idx, row)
        off = byte_idx
    else:
        page = bt_row[(2 * byte_idx) // ps].to(torch.int64)
        off = (2 * byte_idx % ps) // 2          # byte row inside the page
    ol = 2 * byte_idx - start                   # chunk offset of the low slot
    oh = ol + 1
    lo_in = ((ol >= 0) & (ol < length))[:, None, None]
    hi_in = ((oh >= 0) & (oh < length))[:, None, None]
    old = plane[page, :, off]                   # (NB, KV, hd) uint8
    cl = codes[ol.clamp(0, length - 1)].to(torch.int32)
    ch = codes[oh.clamp(0, length - 1)].to(torch.int32)
    lo_u = (cl & 0xF).to(torch.uint8)
    hi_u = ((ch & 0xF) << 4).to(torch.uint8)
    plane[page, :, off] = (torch.where(lo_in, lo_u, old & 0x0F)
                           | torch.where(hi_in, hi_u, old & 0xF0))


def attention_chunk(ctx: Ctx, p: Attention, x: torch.Tensor, cache: Dict,
                    cfg: ModelConfig, row: int, start: int, length: int
                    ) -> Tuple[torch.Tensor, Dict]:
    """Multi-token chunk attention for one cache row: ``length`` tokens
    at positions ``[start, start+length)`` of slot ``row``, x (1, C, D)
    right-padded to the chunk width C. Serves chunked prefill and the
    speculative verify (k drafted tokens scored at once; there ``start``
    is the row's decode position, of any parity). The chunk attends to
    the row's stored context below ``start`` (earlier chunks, prefix-
    cache pages, decoded tokens) and to itself, causally: K4 over
    [stored context ‖ chunk], the context masked by ``k_pos = -1`` at
    and above ``start``.

    Both layouts: a paged cache (``block_table`` present) is read and
    written through the row's page table; the unpaged slot cache through
    row ``row`` of its (B, KV, S, hd) pages and ``slot_pos``, where slot
    j holds position j.

    The chunk reads its own K/V fresh (compute dtype) and the context
    from storage, so a one-chunk prompt runs the ops of the one-shot
    prefill. ``ctx.step_parity`` (the verify) reads the chunk's K/V
    through the int8/int4 storage round trip instead, as a decode step
    reads its own token back; bf16/f32 storage has no round trip there,
    as in the JAX package.

    Unless ``ctx.chunk_store`` is off (a read-only verify), the chunk's
    ``length`` valid tokens are written into the row's storage in its
    container, in place, with ``pos[row] = start + length`` (unpaged:
    ``slot_pos`` too); pad lanes write nothing (``length`` is a host int,
    so the write is sliced to it instead of steering pad lanes out of
    bounds as the JAX scatter does)."""
    _, c, _ = x.shape
    hd = cfg.head_dim_
    positions = torch.arange(start, start + c, dtype=torch.int32,
                             device=x.device)
    q, k, v = _qkv(ctx, p, x, cfg, positions)
    paged = "block_table" in cache
    packed4 = cache["k"].dtype == torch.uint8
    quant = "k_scale" in cache
    kw, vw = k[0, :length], v[0, :length]                    # (L, KV, hd)
    if quant:
        qmax = 7 if packed4 else 127
        kc, ksc = kv_quantize(k, qmax)
        vc, vsc = kv_quantize(v, qmax)
        kw, vw = kc[0, :length], vc[0, :length]
        if ctx.step_parity:
            k = kv_dequantize(kc, ksc, torch.float32).to(k.dtype)
            v = kv_dequantize(vc, vsc, torch.float32).to(v.dtype)

    # ---- context: the row's storage as it stands before the chunk -----
    if paged:
        bt_row = cache["block_table"][row]                   # (nb,)
        ps = _paged_page_size(cache)
        nslots = bt_row.shape[0] * ps
        src = {key: gather_pages(cache[key], bt_row[None])   # (1, KV, S', …)
               for key in ("k", "v", "k_scale", "v_scale") if key in cache}
    else:
        bt_row, ps = None, 0
        nslots = cache["slot_pos"].shape[1]
        src = {key: cache[key][row][None]
               for key in ("k", "v", "k_scale", "v_scale") if key in cache}
    ctxk, ctxv = _cache_kv(src, torch.float32) if quant \
        else (src["k"], src["v"])
    sctx = torch.arange(nslots, dtype=torch.int32, device=x.device)
    k_pos = torch.cat([torch.where(sctx < start, sctx, -1), positions])
    kk = torch.cat([ctxk.to(k.dtype).transpose(1, 2), k], dim=1)
    vv = torch.cat([ctxv.to(v.dtype).transpose(1, 2), v], dim=1)

    # ---- write the chunk's valid tokens into the row's storage --------
    if ctx.chunk_store:
        sl = torch.arange(start, start + length, device=x.device)
        if paged:
            wrow = bt_row[sl // ps].to(torch.int64)
            woff = sl % ps
        else:
            wrow = torch.full_like(sl, row)
            woff = sl
            cache["slot_pos"][row, start:start + length] = positions[:length]
        if quant:
            cache["k_scale"][wrow, :, woff] = ksc[0, :length]
            cache["v_scale"][wrow, :, woff] = vsc[0, :length]
        if packed4:
            _chunk_nibble_rmw(cache["k"], row, bt_row, ps, kw, start, length)
            _chunk_nibble_rmw(cache["v"], row, bt_row, ps, vw, start, length)
        else:
            cache["k"][wrow, :, woff] = kw.to(cache["k"].dtype)
            cache["v"][wrow, :, woff] = vw.to(cache["v"].dtype)
        cache["pos"][row] = start + length

    # ---- attention: [stored context ‖ chunk], causal -----------------
    out = prefill_attention(ctx, q, kk, vv, positions, k_pos, start=start)
    y = linear(ctx, p.wo, out.reshape(1, c, cfg.n_heads * hd))
    return y, cache


# ==========================================================================
# MLA: multi-head latent attention (DeepSeek-V2)
# ==========================================================================
class MLA(nn.Module):
    """MLA's projections (``repro/models/attention.py::init_mla``):
    ``w_dkv`` (d, r) with ``ckv_norm``, ``w_kpe`` (d, pe), ``w_uk`` and
    ``w_uv`` (r, H·hd), ``wo`` (H·hd, d), and either ``w_q`` (d,
    H·(hd + pe)) or the q-LoRA trio ``w_dq`` (d, q_lora), ``q_norm``,
    ``w_uq`` (q_lora, H·(hd + pe))."""

    def __init__(self, w_dkv: nn.Module, w_kpe: nn.Module, w_uk: nn.Module,
                 w_uv: nn.Module, wo: nn.Module, ckv_norm: RMSNorm, *,
                 w_q: Optional[nn.Module] = None,
                 w_dq: Optional[nn.Module] = None,
                 q_norm: Optional[RMSNorm] = None,
                 w_uq: Optional[nn.Module] = None):
        super().__init__()
        if (w_q is None) == (w_dq is None) \
                or (w_dq is None) != (w_uq is None) \
                or (w_dq is None) != (q_norm is None):
            raise ValueError("MLA takes w_q or the q-LoRA trio w_dq / "
                             "q_norm / w_uq")
        self.w_dkv, self.w_kpe, self.w_uk, self.w_uv = w_dkv, w_kpe, w_uk, w_uv
        self.wo, self.ckv_norm = wo, ckv_norm
        self.w_q, self.w_dq, self.q_norm, self.w_uq = w_q, w_dq, q_norm, w_uq


# the projections of an MLA mixer, in the order a forward pass runs them
MLA_PROJECTIONS = ("w_q", "w_dq", "w_uq", "w_dkv", "w_kpe", "w_uk", "w_uv",
                   "wo")


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                   device) -> Dict[str, torch.Tensor]:
    """Zeroed latent rows (module docstring) for ``batch`` rows of
    ``max_len`` slots, in the float ``dtype``."""
    return {"lat": torch.zeros((batch, max_len,
                                cfg.kv_lora_rank + cfg.rope_head_dim),
                               dtype=dtype, device=device),
            "pos": torch.zeros((batch,), dtype=torch.int32, device=device)}


def _mla_q(ctx: Ctx, p: MLA, x: torch.Tensor, cfg: ModelConfig,
           positions: torch.Tensor):
    """(q_nope (B, S, H, hd), q_pe (B, S, H, pe) with full RoPE)."""
    b, s, _ = x.shape
    hd, pe, h = cfg.head_dim_, cfg.rope_head_dim, cfg.n_heads
    if p.w_q is None:
        cq = rmsnorm(p.q_norm, linear(ctx, p.w_dq, x, "attn.w_dq"))
        q = linear(ctx, p.w_uq, cq, "attn.w_uq")
    else:
        q = linear(ctx, p.w_q, x, "attn.w_q")
    q = q.reshape(b, s, h, hd + pe)
    return q[..., :hd], apply_rope(q[..., hd:], positions, cfg.rope_theta,
                                   "full")


def _mla_compress(ctx: Ctx, p: MLA, x: torch.Tensor, cfg: ModelConfig,
                  positions: torch.Tensor):
    """(ckv (B, S, r) RMS-normed, kpe (B, S, pe) with full RoPE): what the
    latent cache stores of each token."""
    ckv = rmsnorm(p.ckv_norm, linear(ctx, p.w_dkv, x, "attn.w_dkv"))
    kpe = linear(ctx, p.w_kpe, x, "attn.w_kpe")
    kpe = apply_rope(kpe[:, :, None, :], positions, cfg.rope_theta, "full")
    return ckv, kpe[:, :, 0, :]


def mla_seq(ctx: Ctx, p: MLA, x: torch.Tensor, cfg: ModelConfig,
            cache: Optional[Dict] = None,
            lengths: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Prefill / training MLA: K and V expanded per head from the latent
    (``w_uk``/``w_uv``), the shared ``kpe`` broadcast over the heads, and
    plain masked softmax attention as MHA (KV = H, G = 1) at head dim hd +
    pe, V hd wide (the JAX package runs its plain ``blockwise_attention``
    there, V zero-padded to hd + pe and sliced back, which changes
    nothing; no kernel: K4 takes at most 128).
    With a cache: a fresh latent tensor whose rows ``0..S-1`` hold the
    prefilled tokens (a pad token's row too; the decode mask keeps it
    invisible until overwritten), and ``pos = lengths``."""
    b, s, _ = x.shape
    hd, pe, h, r = cfg.head_dim_, cfg.rope_head_dim, cfg.n_heads, \
        cfg.kv_lora_rank
    positions = torch.arange(s, dtype=torch.int32, device=x.device)
    q_nope, q_pe = _mla_q(ctx, p, x, cfg, positions)
    ckv, kpe = _mla_compress(ctx, p, x, cfg, positions)
    k_nope = linear(ctx, p.w_uk, ckv, "attn.w_uk").reshape(b, s, h, hd)
    v = linear(ctx, p.w_uv, ckv, "attn.w_uv").reshape(b, s, h, hd)
    k = torch.cat([k_nope, kpe[:, :, None, :].expand(b, s, h, pe)
                   .to(k_nope.dtype)], dim=-1)
    q = torch.cat([q_nope, q_pe], dim=-1).reshape(b, s, h, 1, hd + pe)
    out = flash_attention_plain(q, k, v, positions, positions)
    y = linear(ctx, p.wo, out.reshape(b, s, h * hd), "attn.wo")
    if cache is not None:
        lat = cache["lat"]
        if s > lat.shape[1]:
            raise ValueError(f"prefill of {s} tokens exceeds the cache's "
                             f"{lat.shape[1]} slots")
        rows = torch.cat([ckv, kpe.to(ckv.dtype)], dim=-1).to(lat.dtype)
        cache = dict(cache)
        cache["lat"] = torch.cat([rows, lat[:, s:]], dim=1)
        cache["pos"] = (torch.full((b,), s, dtype=torch.int32,
                                   device=x.device) if lengths is None
                        else lengths.to(torch.int32))
    return y, cache


def absorb_mla_weights(p: MLA) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dense up-projections ``(W_uk, W_uv)`` (r, H·hd) in f32 that
    :func:`mla_step` folds q and the attention output through: dequant(Q)
    + L·R of a quantized mixer, computed once (the engine keeps them in
    ``Ctx.absorbed``) instead of on every step."""
    return weight_of(p.w_uk, torch.float32), weight_of(p.w_uv, torch.float32)


def _latent_write_index(cache: Dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rows, slot) a decode step over an MLA cache writes: each row's
    ``pos``, held to the last slot (a row at or past it writes nothing;
    see :func:`mla_step`)."""
    pos = cache["pos"]
    rows = torch.arange(pos.shape[0], device=pos.device)
    return rows, torch.clamp(pos, max=cache["lat"].shape[1] - 1).to(
        torch.int64)


def _latent_attention(ctx: Ctx, q_lat: torch.Tensor, q_pe: torch.Tensor,
                      lat: torch.Tensor, pos: torch.Tensor, r: int,
                      scale: float) -> torch.Tensor:
    """K3's latent function (B, 1, H, r) by the route ``ctx.fused``
    picks: one K3 call (the wrapper), or JAX's two-einsum form."""
    b, smax = lat.shape[:2]
    if fused_mode(ctx) == "kernel":
        q_cat = torch.cat([q_lat, q_pe.float()], dim=-1)     # (B, 1, H, r+pe)
        k_pos = torch.arange(smax, dtype=torch.int32,
                             device=lat.device).expand(b, smax)
        return decode_attention_op(q_cat, lat[:, None], lat[:, None, :, :r],
                                   pos, k_pos, scale=scale, latent=True)
    ckv, kpe = lat[..., :r].float(), lat[..., r:].float()
    scores = (torch.einsum("bqhr,bsr->bhqs", q_lat, ckv)
              + torch.einsum("bqhp,bsp->bhqs", q_pe.float(), kpe))
    scores = scores * scale
    mask = torch.arange(smax, device=lat.device)[None, :] <= pos[:, None]
    scores = torch.where(mask[:, None, None, :], scores, NEG_INF)
    return torch.einsum("bhqs,bsr->bqhr", torch.softmax(scores, dim=-1), ckv)


def mla_step(ctx: Ctx, p: MLA, x: torch.Tensor, cache: Dict,
             cfg: ModelConfig) -> Tuple[torch.Tensor, Dict]:
    """One absorbed MLA decode step, x (B, 1, D): scores and values in the
    r-wide latent space, q folded through W_uk and the output through
    W_uv (from ``ctx.absorbed`` when the engine built them, else
    materialized here). Each row writes its token's latent row at its own
    ``pos``, in place; a row whose ``pos`` is at or past the last slot
    writes nothing, as JAX's scatter drops it (masked on the device, no
    host read), and still attends over every slot.

    The kernel route (``fused`` auto/on) is JAX's ``fused="kernel"``
    form: one K3 call with KV = 1, G = H, head dim r + pe, the score
    scale 1/√(hd + pe), K the latent rows and V their first r columns
    (a view: K3 reads each row once). ``fused="off"`` keeps JAX's
    two-einsum form."""
    b = x.shape[0]
    hd, pe, h, r = cfg.head_dim_, cfg.rope_head_dim, cfg.n_heads, \
        cfg.kv_lora_rank
    pos = cache["pos"]
    positions = pos[:, None]
    q_nope, q_pe = _mla_q(ctx, p, x, cfg, positions)        # (B, 1, H, ·)
    ckv_t, kpe_t = _mla_compress(ctx, p, x, cfg, positions)
    lat = cache["lat"]
    smax = lat.shape[1]
    rows, slot = _latent_write_index(cache)
    new = torch.cat([ckv_t, kpe_t.to(ckv_t.dtype)], dim=-1)[:, 0]
    lat[rows, slot] = torch.where((pos < smax)[:, None], new.to(lat.dtype),
                                  lat[rows, slot])

    absorbed = ctx.absorbed.get(p) if ctx.absorbed is not None else None
    w_uk, w_uv = absorbed if absorbed is not None else absorb_mla_weights(p)
    q_lat = torch.einsum("bqhd,rhd->bqhr", q_nope.float(),
                         w_uk.float().reshape(r, h, hd))     # (B, 1, H, r)
    out_lat = work.kernel(lambda: work.latent_decode_work(
        b, h, smax, r, pe, lat_itemsize=lat.element_size()), _latent_attention,
        ctx, q_lat, q_pe, lat, pos, r, 1.0 / ((hd + pe) ** 0.5))
    out = torch.einsum("bqhr,rhd->bqhd", out_lat.float(),
                       w_uv.float().reshape(r, h, hd))
    y = linear(ctx, p.wo, out.reshape(b, 1, h * hd).to(x.dtype), "attn.wo")
    cache["pos"] = pos + 1
    return y, cache
