"""Decoder: config → init / forward / prefill / decode (port of the
full-attention, MLA, RG-LRU hybrid and xLSTM parts of
``repro/models/transformer.py``).

The JAX package folds depth into a ``lax.scan`` over stacked params; here
the layers are an ``nn.ModuleList`` walked by a Python loop, and the
cache is a list with one dict per layer (see ``models.attention``).
Each block's FFN is a SwiGLU :class:`~repro_torch.models.layers.MLP` or,
past the config's ``first_dense`` lead-in layers of an MoE config, an
:class:`~repro_torch.models.moe.MoE`; :func:`ffn` applies either, for
prefill, chunks and decode alike. Each block's mixer is GQA
(:class:`~repro_torch.models.attention.Attention`) or, for an
``attn_kind="mla"`` config, MLA (:class:`~repro_torch.models.attention.MLA`,
over a latent cache; no paged cache and no chunked prefill, as in the JAX
package). A hybrid config's ``block_pattern`` cycles through the depth
(recurrentgemma-9b: ``(rglru, rglru, local)``, the remainder at the end):
each :class:`Block` knows its kind, and its mixer is an
:class:`~repro_torch.models.rglru.RGLRU` or a sliding-window GQA over a
ring cache (no paged cache and no chunked prefill, as in the JAX
package). An xLSTM config's pattern alternates ``mlstm`` and ``slstm``
blocks (:mod:`~repro_torch.models.xlstm`), which carry their own
projections and take no FFN after the mixer; its norms are LayerNorms
(``cfg.norm`` picks the kind for every block and the final norm).
An encoder-decoder config (whisper-large-v3) adds the encoder: blocks
of bidirectional GQA attention and a GELU MLP over the ``frames`` stub
plus a sinusoid (:func:`encode`), whose output every decoder block reads
through its cross attention (``norm_x`` then ``cross``, after the self
mixer and before the FFN); the decoder's cache carries each layer's
cross memory (``models.attention``), written at prefill and read at
decode. A VLM config (internvl2-2b) puts ``vision_proj`` of the
``vision`` stub's patch embeddings in front of the token embeddings, so
RoPE positions run over vision + prompt and the cache holds the prefix
like any prompt row. Embeddings, ``vision_proj`` and the LM head stay
full precision by PTQ policy. :func:`lm_loss` is the calibration pass's
forward (and the training objective): token cross-entropy (over the
token rows only) plus the MoE load-balance term.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple, Union

import torch
import torch.utils.checkpoint
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models.layers import (MLP, RMSNorm, chunked_softmax_xent,
                                       embed, init_linear, init_norm, mlp,
                                       norm)
from repro_torch.models.linear import Ctx, FpLinear, linear
from repro_torch.models.moe import MoE, init_moe, moe_apply
from repro_torch.models.rglru import (RGLRU, init_rglru, init_rglru_cache,
                                      rglru_seq, rglru_step)
from repro_torch.models.xlstm import (MLSTM, SLSTM, init_mlstm,
                                      init_mlstm_cache, init_slstm,
                                      init_slstm_cache, mlstm_seq, mlstm_step,
                                      slstm_seq, slstm_step)

AUX_WEIGHT = 0.01  # MoE load-balance loss coefficient


MIXER_KINDS = ("attn", "local", "rglru")
XLSTM_KINDS = ("mlstm", "slstm")


def check_supported(cfg: ModelConfig) -> None:
    """The port serves RoPE/SwiGLU/RMSNorm decoders, dense or MoE (routed
    + shared experts after ``first_dense`` dense layers), with GQA (full
    or half RoPE, optional QKV biases) or MLA attention (a latent of
    ``kv_lora_rank`` and a shared RoPE key of ``rope_head_dim``, full
    RoPE whatever ``rope_kind`` says, as in the JAX package), GQA
    hybrids whose ``block_pattern`` mixes full attention, sliding-window
    (``local``) attention and RG-LRU blocks, xLSTM stacks (a pattern
    of ``mlstm``/``slstm`` blocks only, no FFN after them, no RoPE read,
    LayerNorm or RMSNorm), encoder-decoders (full-attention GQA
    blocks with full RoPE, a GELU MLP and LayerNorm on both sides, dense,
    over a fixed ``enc_seq``-frame input), and a vision prefix in front
    of a dense full-attention GQA decoder (the JAX package's only VLM);
    raise for anything else (mixes of xLSTM and attention blocks, a
    vision prefix beside an encoder, an MoE, MLA or a hybrid) rather than
    run it wrongly."""
    kinds = set(cfg.block_pattern)
    plain = not cfg.is_encoder_decoder and bool(kinds)
    vision_ok = not cfg.n_vision_tokens or (
        kinds == {"attn"} and cfg.attn_kind == "gqa" and not cfg.moe
        and not cfg.first_dense)
    if cfg.is_encoder_decoder:
        ok = (not cfg.n_vision_tokens and kinds == {"attn"}
              and cfg.attn_kind == "gqa" and not cfg.moe
              and not cfg.first_dense and cfg.rope_kind == "full"
              and cfg.act == "gelu" and cfg.norm == "layernorm"
              and cfg.d_ff > 0 and cfg.enc_seq > 0 and cfg.d_frontend > 0)
    elif kinds <= set(XLSTM_KINDS):
        ok = (plain and not cfg.n_vision_tokens and not cfg.moe
              and not cfg.first_dense
              and cfg.attn_kind == "gqa" and cfg.d_ff == 0
              and cfg.norm in ("rmsnorm", "layernorm"))
    else:
        moe_ok = not cfg.moe or (cfg.n_routed > 0
                                 and 0 < cfg.top_k <= cfg.n_routed
                                 and cfg.d_expert > 0)
        hybrid = kinds != {"attn"}
        attn_ok = cfg.attn_kind == "gqa" or (
            cfg.attn_kind == "mla" and not hybrid and cfg.kv_lora_rank > 0
            and cfg.rope_head_dim > 0 and cfg.rope_head_dim % 2 == 0)
        ok = (plain and vision_ok and kinds <= set(MIXER_KINDS) and attn_ok
              and moe_ok and (cfg.moe or not cfg.first_dense)
              and (cfg.conv_width >= 1 or "rglru" not in kinds)
              and cfg.rope_kind in ("full", "half") and cfg.act == "swiglu"
              and cfg.norm == "rmsnorm" and cfg.d_ff > 0)
    if not ok:
        raise NotImplementedError(
            f"{cfg.name}: the port serves GQA or MLA decoders (dense or MoE)"
            f" and GQA hybrids of attn/local/rglru blocks, with full or half "
            f"RoPE, SwiGLU and RMSNorm, xLSTM stacks of mlstm/slstm "
            f"blocks only, GELU/LayerNorm encoder-decoders, and a vision "
            f"prefix on a dense full-attention GQA decoder only "
            f"(block_pattern={cfg.block_pattern}, "
            f"attn_kind={cfg.attn_kind!r}, rope_kind={cfg.rope_kind!r}, "
            f"moe={cfg.moe}, n_vision_tokens={cfg.n_vision_tokens})")


def kind_at(cfg: ModelConfig, i: int) -> str:
    """Layer ``i``'s block kind (``repro/models/transformer.py::_kind_at``):
    the pattern cycles from the first layer past ``first_dense``, and the
    lead-in layers take the pattern's first kind."""
    if i < cfg.first_dense:
        return cfg.block_pattern[0]
    return cfg.block_pattern[(i - cfg.first_dense) % len(cfg.block_pattern)]


def layer_layout(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(n_prefix, n_groups, n_suffix) of the JAX package's parameter tree
    (``repro/models/transformer.py::layer_layout``): the ``first_dense``
    lead-in layers, the scanned groups of one ``block_pattern`` period
    each, and the remainder."""
    period = len(cfg.block_pattern)
    n_main = cfg.n_layers - cfg.first_dense
    return cfg.first_dense, n_main // period, n_main % period


def reference_lead(cfg: ModelConfig, name: str) -> int:
    """Leading axes the JAX package's tree stacks in front of the port's
    leaf ``name`` (a dotted buffer path, ``blocks.<i>.…`` or
    ``encoder.<e>.…``): 1 for a layer of a scanned group and for every
    encoder layer (vmapped), 0 for the prefix and suffix layers and the
    top-level leaves. The port keeps every layer unstacked."""
    parts = name.split(".")
    if parts[0] == "encoder" and len(parts) > 1:
        return 1
    if parts[0] != "blocks" or len(parts) < 2:
        return 0
    n_prefix, n_groups, _ = layer_layout(cfg)
    i = int(parts[1])
    return int(n_prefix <= i < n_prefix + n_groups * len(cfg.block_pattern))


class Block(nn.Module):
    """``kind`` is the mixer's block kind (``attn``, ``local``,
    ``rglru``, ``mlstm`` or ``slstm``); ``mlp`` is the block's FFN: a
    SwiGLU or GELU :class:`MLP`, an :class:`MoE`, or ``None`` (with
    ``norm2``) for an xLSTM block. An encoder-decoder's decoder block
    also has ``norm_x`` and the ``cross`` attention (JAX's ``norm_x`` /
    ``cross``); every other block has ``None`` there."""

    def __init__(self, norm1: nn.Module,
                 mixer: Union[attn.Attention, attn.MLA, RGLRU, MLSTM, SLSTM],
                 norm2: Optional[nn.Module], mlp_: Union[MLP, MoE, None],
                 kind: str, norm_x: Optional[nn.Module] = None,
                 cross: Optional[attn.Attention] = None):
        super().__init__()
        self.norm1, self.mixer, self.norm2, self.mlp = norm1, mixer, norm2, mlp_
        self.kind = kind
        if (norm_x is None) != (cross is None):
            raise ValueError("a cross-attention block takes norm_x and cross")
        self.norm_x, self.cross = norm_x, cross


def ffn(ctx: Ctx, blk: Block, x: torch.Tensor, cfg: ModelConfig
        ) -> torch.Tensor:
    """The block's FFN (SwiGLU or MoE) applied to ``norm2(x)``; the
    caller adds it to the residual stream ``x``."""
    h = norm(blk.norm2, x, cfg.norm)
    if isinstance(blk.mlp, MoE):
        return moe_apply(ctx, blk.mlp, h, cfg)
    return mlp(ctx, blk.mlp, h)


class LM(nn.Module):
    """Embedding, blocks, final norm, LM head (``None``: tied to the
    embedding); an encoder-decoder also has the ``encoder`` blocks
    (``cfg.enc_layers``, no cross attention), their final ``enc_norm``,
    and ``frontend_proj`` (full precision) when ``cfg.d_frontend`` is not
    ``d_model``; a VLM has ``vision_proj`` (full precision, d_frontend →
    d_model)."""

    def __init__(self, cfg: ModelConfig, embed_w: torch.Tensor,
                 blocks: List[Block], final_norm: nn.Module,
                 lm_head: Optional[FpLinear],
                 encoder: Optional[List[Block]] = None,
                 enc_norm: Optional[nn.Module] = None,
                 frontend_proj: Optional[FpLinear] = None,
                 vision_proj: Optional[FpLinear] = None):
        super().__init__()
        check_supported(cfg)
        kinds = [kind_at(cfg, i) for i in range(cfg.n_layers)]
        if [blk.kind for blk in blocks] != kinds:
            raise ValueError(f"block kinds {[blk.kind for blk in blocks]} do "
                             f"not follow {cfg.name}'s layout {kinds}")
        enc_dec = cfg.is_encoder_decoder
        if (any((blk.cross is None) == enc_dec for blk in blocks)
                or (encoder is None) == enc_dec
                or (enc_norm is None) == enc_dec
                or len(encoder or []) != cfg.enc_layers
                or any(blk.cross is not None for blk in encoder or [])
                or (frontend_proj is not None)
                != (enc_dec and cfg.d_frontend != cfg.d_model)):
            raise ValueError(f"{cfg.name}: an encoder-decoder takes "
                             f"{cfg.enc_layers} encoder blocks, enc_norm, a "
                             f"cross attention in every decoder block and "
                             f"frontend_proj iff d_frontend != d_model; "
                             f"any other model none of them")
        if (vision_proj is not None) != bool(cfg.n_vision_tokens):
            raise ValueError(f"{cfg.name}: a model with n_vision_tokens "
                             f"takes vision_proj, any other none")
        self.cfg = cfg
        self.register_buffer("embed", embed_w)
        self.blocks = nn.ModuleList(blocks)
        self.final_norm = final_norm
        self.lm_head = lm_head
        self.encoder = nn.ModuleList(encoder) if encoder is not None else None
        self.enc_norm = enc_norm
        self.frontend_proj = frontend_proj
        self.vision_proj = vision_proj

    @property
    def device(self) -> torch.device:
        return self.embed.device


def _init_qkv(gen: torch.Generator, cfg: ModelConfig, n: int, dev
              ) -> FpLinear:
    d = cfg.d_model
    p = init_linear(gen, d, n, d ** -0.5, dev)
    if cfg.qkv_bias:
        p.b = torch.zeros((n,), device=dev)
    return p


def _init_wo(gen: torch.Generator, cfg: ModelConfig, dev) -> FpLinear:
    qd = cfg.n_heads * cfg.head_dim_
    return init_linear(gen, qd, cfg.d_model,
                       1.0 / (qd ** 0.5 * (2 * cfg.n_layers) ** 0.5), dev)


def _init_gqa(gen: torch.Generator, cfg: ModelConfig, dev) -> attn.Attention:
    qd = cfg.n_heads * cfg.head_dim_
    kvd = cfg.n_kv_heads * cfg.head_dim_
    return attn.Attention(_init_qkv(gen, cfg, qd, dev),
                          _init_qkv(gen, cfg, kvd, dev),
                          _init_qkv(gen, cfg, kvd, dev),
                          _init_wo(gen, cfg, dev))


def _init_mla(gen: torch.Generator, cfg: ModelConfig, dev) -> attn.MLA:
    d, hd = cfg.d_model, cfg.head_dim_
    qd = cfg.n_heads * hd
    r, pe, ql = cfg.kv_lora_rank, cfg.rope_head_dim, cfg.q_lora_rank
    qw = cfg.n_heads * (hd + pe)
    if ql:
        q = dict(w_dq=init_linear(gen, d, ql, d ** -0.5, dev),
                 w_uq=init_linear(gen, ql, qw, ql ** -0.5, dev),
                 q_norm=RMSNorm(torch.ones((ql,), device=dev)))
    else:
        q = dict(w_q=init_linear(gen, d, qw, d ** -0.5, dev))
    return attn.MLA(init_linear(gen, d, r, d ** -0.5, dev),
                    init_linear(gen, d, pe, d ** -0.5, dev),
                    init_linear(gen, r, qd, r ** -0.5, dev),
                    init_linear(gen, r, qd, r ** -0.5, dev),
                    _init_wo(gen, cfg, dev),
                    RMSNorm(torch.ones((r,), device=dev)), **q)


def _init_ffn(gen: torch.Generator, cfg: ModelConfig, i: int, dev
              ) -> Union[MLP, MoE]:
    """Layer ``i``'s FFN (``-1``: an encoder block's)."""
    if i >= 0 and cfg.uses_moe_at(i):
        return init_moe(gen, cfg, dev)
    d, ff = cfg.d_model, cfg.d_ff
    up = init_linear(gen, d, ff, d ** -0.5, dev)
    gate = (init_linear(gen, d, ff, d ** -0.5, dev)
            if cfg.act == "swiglu" else None)
    return MLP(up, gate, init_linear(gen, ff, d, ff ** -0.5, dev))


def init_block(gen: torch.Generator, cfg: ModelConfig, i: int, device
               ) -> Block:
    """Decoder layer ``i`` as :func:`init_lm` draws it from ``gen``."""
    d, dev = cfg.d_model, device
    kind = kind_at(cfg, i)
    if kind in XLSTM_KINDS:
        mixer = (init_mlstm if kind == "mlstm" else init_slstm)(gen, cfg, dev)
        return Block(init_norm(d, cfg.norm, dev), mixer, None, None, kind)
    if kind == "rglru":
        mixer = init_rglru(gen, cfg, dev)
    elif cfg.attn_kind == "mla":
        mixer = _init_mla(gen, cfg, dev)
    else:
        mixer = _init_gqa(gen, cfg, dev)
    cross = {}
    if cfg.is_encoder_decoder:
        cross = dict(norm_x=init_norm(d, cfg.norm, dev),
                     cross=_init_gqa(gen, cfg, dev))
    return Block(init_norm(d, cfg.norm, dev), mixer,
                 init_norm(d, cfg.norm, dev), _init_ffn(gen, cfg, i, dev),
                 kind, **cross)


def init_encoder_block(gen: torch.Generator, cfg: ModelConfig, device
                       ) -> Block:
    """An encoder layer as :func:`init_lm` draws it from ``gen``."""
    d = cfg.d_model
    return Block(init_norm(d, cfg.norm, device), _init_gqa(gen, cfg, device),
                 init_norm(d, cfg.norm, device),
                 _init_ffn(gen, cfg, -1, device), "attn")


@dataclasses.dataclass
class Tail:
    """Everything of an :class:`LM` but its blocks, under the LM's own
    attribute names: the embedding, the final norm, the LM head, and the
    encoder's ``enc_norm``, ``frontend_proj`` and the ``vision_proj``
    where the config has them."""

    embed: torch.Tensor
    final_norm: nn.Module
    lm_head: Optional[FpLinear]
    enc_norm: Optional[nn.Module] = None
    frontend_proj: Optional[FpLinear] = None
    vision_proj: Optional[FpLinear] = None


def init_tail(gen: torch.Generator, cfg: ModelConfig, device) -> Tail:
    """The tail as :func:`init_lm` draws it from ``gen`` once the blocks
    and the encoder are drawn."""
    d, dev = cfg.d_model, device
    enc_norm = proj = None
    if cfg.is_encoder_decoder:
        enc_norm = init_norm(d, cfg.norm, dev)
        if cfg.d_frontend != d:
            proj = init_linear(gen, cfg.d_frontend, d,
                               cfg.d_frontend ** -0.5, dev)
    vision = None
    if cfg.n_vision_tokens:
        dv = cfg.d_frontend or d
        vision = init_linear(gen, dv, d, dv ** -0.5, dev)
    embed_w = torch.randn((cfg.vocab, d), generator=gen, device=dev) * 0.02
    head = None if cfg.tie_embeddings else init_linear(gen, d, cfg.vocab,
                                                        d ** -0.5, dev)
    return Tail(embed_w, init_norm(d, cfg.norm, dev), head, enc_norm, proj,
                vision)


def assemble_lm(cfg: ModelConfig, blocks: List[Block],
                encoder: Optional[List[Block]], tail: Tail) -> LM:
    """The :class:`LM` of ``blocks``, the ``encoder`` blocks (None
    without one) and ``tail``."""
    return LM(cfg, tail.embed, blocks, tail.final_norm, tail.lm_head,
              encoder, tail.enc_norm, tail.frontend_proj, tail.vision_proj)


def init_lm(cfg: ModelConfig, seed: int = 0, *, device="cuda") -> LM:
    """Random f32 model from ``seed`` with the JAX package's init scales
    (``transformer.init_lm``); the numbers differ from JAX's, since the
    generators differ. One generator draws the decoder blocks in order
    (:func:`init_block`), then the encoder's (:func:`init_encoder_block`),
    then the tail (:func:`init_tail`: ``frontend_proj``, ``vision_proj``,
    the embedding, the LM head). An MoE config gets ``first_dense`` dense
    layers of width ``d_ff``, then MoE blocks; ``cfg.qkv_bias`` gives
    wq/wk/wv a zero bias, as JAX's ``init_linear(..., bias=True)`` does;
    an MLA config gets MLA mixers (``init_mla``'s scales); an ``rglru``
    layer an RG-LRU mixer (``init_rglru``'s); an ``mlstm``/``slstm`` layer
    its xLSTM mixer (``init_mlstm``'s / ``init_slstm``'s) and no FFN. An
    encoder-decoder's blocks take a GELU MLP (``up``/``down``), each
    decoder block a cross attention with ``init_attention``'s scales, and
    the encoder ``enc_layers`` attention blocks; a VLM config gets
    ``vision_proj`` (``init_linear``'s scale). Norms follow
    ``cfg.norm``."""
    check_supported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    blocks = [init_block(gen, cfg, i, dev) for i in range(cfg.n_layers)]
    encoder = ([init_encoder_block(gen, cfg, dev)
                for _ in range(cfg.enc_layers)]
               if cfg.is_encoder_decoder else None)
    return assemble_lm(cfg, blocks, encoder, init_tail(gen, cfg, dev))


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
               device, pages: Optional[int] = None,
               page_size: Optional[int] = None
               ) -> List[Dict[str, torch.Tensor]]:
    """One zeroed slot-cache dict per layer (``dtype``: a float dtype,
    ``torch.int8``, or ``"int4"``). ``pages``/``page_size`` switch every
    layer to the paged layout: its own page pools and its own copy of
    the block table and positions (``serve.pages`` keeps the copies
    equal). A ``local`` layer gets a ring of ``min(window, max_len)``
    slots. An MLA layer's latent cache and an RG-LRU layer's state stay
    in a float type as JAX's rule has it (int8/int4 → bf16), and neither
    takes the paged layout (nor does a ring). An xLSTM layer's state is
    f32 whatever ``dtype`` says, as in JAX. An encoder-decoder's layers
    also hold ``cross_k``/``cross_v`` (B, KV, enc_seq, hd) in that float
    type (``models.attention``)."""
    kinds = [kind_at(cfg, i) for i in range(cfg.n_layers)]
    if pages is not None:
        for kind in kinds:
            if not (kind == "attn" and cfg.attn_kind != "mla"):
                raise ValueError(
                    f"paged KV cache supports full GQA attention layers only, "
                    f"got kind={kind!r} (attn_kind={cfg.attn_kind!r}) — "
                    f"recurrent states and MLA latents have no "
                    f"block-granular sharing story")
    fdtype = torch.bfloat16 if dtype in (torch.int8, attn.INT4) else dtype
    out = []
    for kind in kinds:
        if kind == "mlstm":
            out.append(init_mlstm_cache(cfg, batch, device))
        elif kind == "slstm":
            out.append(init_slstm_cache(cfg, batch, device))
        elif kind == "rglru":
            out.append(init_rglru_cache(cfg, batch, fdtype, device))
        elif kind == "attn" and cfg.attn_kind == "mla":
            out.append(attn.init_mla_cache(cfg, batch, max_len, fdtype,
                                           device))
        else:
            out.append(attn.init_attn_cache(cfg, batch, max_len, dtype,
                                            device, pages=pages,
                                            page_size=page_size,
                                            local=kind == "local"))
        if cfg.is_encoder_decoder:
            shape = (batch, cfg.n_kv_heads, cfg.enc_seq, cfg.head_dim_)
            out[-1]["cross_k"] = torch.zeros(shape, dtype=fdtype,
                                             device=device)
            out[-1]["cross_v"] = torch.zeros(shape, dtype=fdtype,
                                             device=device)
    return out


def _mix_seq(ctx: Ctx, blk: Block, h: torch.Tensor, cfg: ModelConfig,
             cache: Optional[Dict], lengths: Optional[torch.Tensor]):
    """The block's mixer over a full sequence (prefill / calibration)."""
    if blk.kind == "mlstm":
        return mlstm_seq(ctx, blk.mixer, h, cfg, cache=cache, lengths=lengths)
    if blk.kind == "slstm":
        return slstm_seq(ctx, blk.mixer, h, cfg, cache=cache, lengths=lengths)
    if blk.kind == "rglru":
        return rglru_seq(ctx, blk.mixer, h, cfg, cache=cache, lengths=lengths)
    if isinstance(blk.mixer, attn.MLA):
        return attn.mla_seq(ctx, blk.mixer, h, cfg, cache=cache,
                            lengths=lengths)
    return attn.attention_seq(ctx, blk.mixer, h, cfg, cache=cache,
                              lengths=lengths, local=blk.kind == "local")


def _mix_step(ctx: Ctx, blk: Block, h: torch.Tensor, cache: Dict,
              cfg: ModelConfig):
    """The block's mixer for one decode step, its cache updated in
    place."""
    if blk.kind == "mlstm":
        return mlstm_step(ctx, blk.mixer, h, cache, cfg)
    if blk.kind == "slstm":
        return slstm_step(ctx, blk.mixer, h, cache, cfg)
    if blk.kind == "rglru":
        return rglru_step(ctx, blk.mixer, h, cache, cfg)
    if isinstance(blk.mixer, attn.MLA):
        return attn.mla_step(ctx, blk.mixer, h, cache, cfg)
    return attn.attention_step(ctx, blk.mixer, h, cache, cfg,
                               local=blk.kind == "local")


def _head(ctx: Ctx, model: LM, x: torch.Tensor) -> torch.Tensor:
    if model.lm_head is None:
        return x.to(ctx.compute_dtype) @ model.embed.T.to(ctx.compute_dtype)
    return linear(ctx, model.lm_head, x)


def _sinusoid(s: int, d: int, device) -> torch.Tensor:
    """(s, d) f32 [sin ‖ cos] of ``pos / 10000^(2i/d)`` (JAX's
    ``_sinusoid``: the halves side by side, not interleaved)."""
    pos = torch.arange(s, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / torch.pow(torch.tensor(10000.0, device=device), 2 * dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def encoder_input(ctx: Ctx, parts: Union[LM, Tail], frames: torch.Tensor
                  ) -> torch.Tensor:
    """The encoder's input over (B, enc_seq, d_frontend) frame embeddings:
    ``frontend_proj`` of ``parts`` (an :class:`LM` or its :class:`Tail`)
    where there is one, plus the sinusoid."""
    x = frames.to(ctx.compute_dtype)
    if parts.frontend_proj is not None:
        x = linear(ctx, parts.frontend_proj, x)
    return x + _sinusoid(x.shape[1], x.shape[-1], x.device).to(x.dtype)[None]


def encoder_block_seq(ctx: Ctx, blk: Block, x: torch.Tensor,
                      cfg: ModelConfig) -> torch.Tensor:
    """One encoder block: bidirectional attention (RoPE inside, as JAX's
    ``_qkv`` applies it), then the GELU MLP."""
    y, _ = attn.attention_seq(ctx, blk.mixer, norm(blk.norm1, x, cfg.norm),
                              cfg, causal=False)
    x = x + y
    return x + ffn(ctx, blk, x, cfg)


def encode(ctx: Ctx, model: LM, frames: torch.Tensor) -> torch.Tensor:
    """The encoder over (B, enc_seq, d_frontend) frame embeddings
    (:func:`encoder_input`), its blocks (:func:`encoder_block_seq`), then
    ``enc_norm``. Calibration records encoder layer ``e`` under
    ``E<e>.``."""
    cfg = model.cfg
    x = encoder_input(ctx, model, frames)
    for e, blk in enumerate(model.encoder):
        if ctx.tap is not None:
            ctx.prefix = f"E{e}."
        x = encoder_block_seq(ctx, blk, x, cfg)
    ctx.prefix = ""
    return norm(model.enc_norm, x, cfg.norm)


def vision_prefix(ctx: Ctx, parts: Union[LM, Tail], x: torch.Tensor,
                  vision: torch.Tensor) -> torch.Tensor:
    """``vision_proj`` of ``parts`` over (B, n_vision_tokens, d_frontend)
    ``vision``, put in front of the token embeddings ``x``."""
    vis = linear(ctx, parts.vision_proj,
                 vision.to(x.device, ctx.compute_dtype))
    return torch.cat([vis, x], dim=1)


def _cross(ctx: Ctx, blk: Block, x: torch.Tensor, cfg: ModelConfig,
           memory: Optional[torch.Tensor], cache: Optional[Dict]
           ) -> torch.Tensor:
    """A decoder block's cross attention, added to ``x``: over the fresh
    memory K/V of ``memory`` (prefill / scoring; written into ``cache``
    head-major in its float type), or, with ``memory`` None (decode), over
    the cache's."""
    hx = norm(blk.norm_x, x, cfg.norm)
    if memory is None:
        return x + attn.cross_attention(ctx, blk.cross, hx, cache["cross_k"],
                                        cache["cross_v"], cfg,
                                        head_major=True)
    mk, mv = attn.cross_memory(ctx, blk.cross, memory, cfg)
    if cache is not None:
        for key, t in (("cross_k", mk), ("cross_v", mv)):
            cache[key] = t.transpose(1, 2).to(cache[key].dtype).contiguous()
    return x + attn.cross_attention(ctx, blk.cross, hx, mk, mv, cfg)


def block_seq(ctx: Ctx, blk: Block, x: torch.Tensor, cfg: ModelConfig,
               memory: Optional[torch.Tensor], cache: Optional[Dict],
               lengths: Optional[torch.Tensor]):
    """One decoder block over a full sequence: (x, the block's cache)."""
    y, c = _mix_seq(ctx, blk, norm(blk.norm1, x, cfg.norm), cfg, cache,
                    lengths)
    x = x + y
    if blk.cross is not None:
        x = _cross(ctx, blk, x, cfg, memory, c)
    if blk.mlp is not None:
        x = x + ffn(ctx, blk, x, cfg)
    return x, c


def _block_remat(ctx: Ctx, blk: Block, x: torch.Tensor, cfg: ModelConfig,
                 memory: Optional[torch.Tensor]) -> torch.Tensor:
    """:func:`block_seq` under ``torch.utils.checkpoint`` (JAX's
    ``jax.checkpoint`` around its group body): the block keeps only its
    input for the backward pass and runs again there. The rerun appends
    an MoE layer's load-balance term to ``ctx.aux_log`` a second time,
    after :func:`lm_loss` has summed the list."""
    return torch.utils.checkpoint.checkpoint(
        lambda h, mem: block_seq(ctx, blk, h, cfg, mem, None, None)[0],
        x, memory, use_reentrant=False)


def forward(ctx: Ctx, model: LM, tokens: torch.Tensor,
            cache: Optional[List[Dict]] = None,
            lengths: Optional[torch.Tensor] = None,
            frames: Optional[torch.Tensor] = None, remat: str = "none",
            vision: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Optional[List[Dict]]]:
    """Prefill/scoring pass over (B, S) tokens; returns the final-normed
    hidden states (B, S, D) and, with ``cache``, the populated cache. An
    encoder-decoder encodes ``frames`` (zeros when None) once per call;
    its decoder layers record their taps under ``L<i>.``. A VLM given
    ``vision`` (B, n_vision_tokens, d_frontend) puts ``vision_proj`` of
    it in front of the token embeddings (JAX's ``"vision" in batch``: no
    prefix when None), so the hidden states are (B, n_vision_tokens + S,
    D) and ``lengths`` count the prefix; the projection records its tap
    under the bare name ``""``, as JAX's does. ``remat="full"`` (no
    cache) recomputes each decoder block in the backward pass."""
    if remat not in ("none", "full"):
        raise ValueError(f"remat must be none|full, got {remat!r}")
    if remat == "full" and cache is not None:
        raise ValueError("remat='full' is for training: no cache")
    cfg = model.cfg
    x = embed(model.embed, tokens, ctx.compute_dtype)
    memory = None
    if cfg.is_encoder_decoder:
        if frames is None:      # zeros, as the JAX engine feeds them
            frames = torch.zeros((x.shape[0], cfg.enc_seq, cfg.d_frontend),
                                 device=x.device)
        memory = encode(ctx, model, frames.to(x.device))
    if cfg.n_vision_tokens and vision is not None:
        x = vision_prefix(ctx, model, x, vision)
    new_cache = [] if cache is not None else None
    for i, blk in enumerate(model.blocks):
        if ctx.tap is not None:
            ctx.prefix = f"L{i}."
        if remat == "full":
            x = _block_remat(ctx, blk, x, cfg, memory)
            continue
        x, c = block_seq(ctx, blk, x, cfg, memory,
                          cache[i] if cache is not None else None, lengths)
        if new_cache is not None:
            new_cache.append(c)
    ctx.prefix = ""
    return norm(model.final_norm, x, cfg.norm), new_cache


def lm_loss(ctx: Ctx, model: LM, batch: Dict[str, torch.Tensor],
            remat: str = "none") -> torch.Tensor:
    """Mean token cross-entropy of ``batch["tokens"]`` (B, S) against
    ``batch["labels"]`` plus ``AUX_WEIGHT`` × the MoE layers' summed
    load-balance terms; a scalar f32. An encoder-decoder reads
    ``batch["frames"]``; a VLM ``batch["vision"]``, whose rows it drops
    from the hidden states before the loss. ``remat`` as :func:`forward`
    takes it (the training steps' ``StepConfig.remat``)."""
    aux: List[torch.Tensor] = []
    vision = batch.get("vision")
    hidden, _ = forward(dataclasses.replace(ctx, aux_log=aux), model,
                        batch["tokens"], frames=batch.get("frames"),
                        remat=remat, vision=vision)
    if model.cfg.n_vision_tokens and vision is not None:
        hidden = hidden[:, model.cfg.n_vision_tokens:]
    head = model.lm_head if model.lm_head is not None \
        else FpLinear(model.embed.T)
    xent = chunked_softmax_xent(hidden, head, batch["labels"], ctx)
    return xent + AUX_WEIGHT * sum(aux, torch.zeros_like(xent))


def prefill(ctx: Ctx, model: LM, tokens: torch.Tensor, cache: List[Dict],
            lengths: Optional[torch.Tensor] = None,
            frames: Optional[torch.Tensor] = None,
            vision: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, List[Dict]]:
    """Process right-padded prompts; returns (logits (B, 1, V) at each
    row's last valid position, populated cache). An encoder-decoder
    encodes ``frames`` (B, enc_seq, d_frontend), zeros when None, and
    writes each layer's cross memory into the cache. A VLM prepends
    ``vision`` where given; ``lengths`` then count its rows too."""
    hidden, cache = forward(ctx, model, tokens, cache=cache, lengths=lengths,
                            frames=frames, vision=vision)
    if lengths is None:
        last = hidden[:, -1:, :]
    else:
        ix = (lengths.to(torch.int64) - 1)[:, None, None]
        last = torch.take_along_dim(hidden, ix, dim=1)
    return _head(ctx, model, last), cache


def _chunk_stack(ctx: Ctx, model: LM, tokens: torch.Tensor,
                 cache: List[Dict], row: int, start: int, length: int
                 ) -> torch.Tensor:
    """Run a (1, C) chunk through every layer in chunk mode (append its
    K/V to row ``row``'s storage, paged or unpaged, and attend over
    [stored context ‖ chunk]); returns the final-normed hidden states
    (1, C, D). :func:`prefill_chunk` and :func:`verify_chunk` differ only
    in the positions they push through the LM head."""
    cfg = model.cfg
    if cfg.attn_kind == "mla":
        raise ValueError(f"chunked prefill needs full GQA attention layers, "
                         f"got attn_kind={cfg.attn_kind!r}: MLA latents have "
                         f"no chunked path")
    if cfg.is_encoder_decoder:
        raise ValueError(f"chunked prefill has no encoder pass: "
                         f"{cfg.name}'s cross memory is written by a "
                         f"one-shot prefill")
    for blk in model.blocks:
        if blk.kind != "attn":
            raise ValueError(f"chunked prefill needs full-attention layers, "
                             f"got kind={blk.kind!r}")
    x = embed(model.embed, tokens, ctx.compute_dtype)
    for blk, c in zip(model.blocks, cache):
        y, _ = attn.attention_chunk(ctx, blk.mixer,
                                    norm(blk.norm1, x, cfg.norm), c, cfg,
                                    row, start, length)
        x = x + y
        x = x + ffn(ctx, blk, x, cfg)
    return norm(model.final_norm, x, cfg.norm)


def prefill_chunk(ctx: Ctx, model: LM, tokens: torch.Tensor,
                  cache: List[Dict], row: int, start: int, length: int
                  ) -> Tuple[torch.Tensor, List[Dict]]:
    """One chunk of a chunked prefill into a paged or unpaged cache:
    ``tokens`` (1, C) hold positions ``[start, start+length)`` of slot
    ``row``, right-padded to the chunk width C. Returns (logits (1, 1, V) at chunk
    position ``length - 1``, the cache updated in place): the logits
    matter on a prompt's final chunk, where they give the first token."""
    x = _chunk_stack(ctx, model, tokens, cache, row, start, length)
    return _head(ctx, model, x[:, length - 1:length]), cache


def verify_chunk(ctx: Ctx, model: LM, tokens: torch.Tensor,
                 cache: List[Dict], row: int, start: int, length: int,
                 store: bool = False) -> Tuple[torch.Tensor, List[Dict]]:
    """Speculative-decoding verify: score a chunk of drafted tokens in
    one pass. The stack walk of :func:`prefill_chunk`, with the LM head
    at **every** chunk position — logits (1, C, V) — since acceptance
    needs the full model's next-token distribution after each draft.
    Chunk attention reads its own K/V through the storage round trip
    (``step_parity``), as the decode steps it stands in for do.

    ``store=False`` (a model without low-rank corrections: the Q-only
    draft IS the model) leaves the cache untouched — the draft steps
    already wrote these slots exactly as plain decode would, so verify
    only gates acceptance and greedy speculative output is plain
    decode's by construction. ``store=True`` (the model has LR slivers)
    overwrites the drafts' Q-only K/V at ``[start, start+length)`` with
    the full model's, and sets ``pos[row] = start + length``: the
    chunk's reduction order leaves ulp-level residue in the cache, so
    parity holds unless logits tie at that width. The caller rewinds
    ``pos`` past any rejected tail; the stale slots above it stay masked
    until the next write lands there."""
    ctx = dataclasses.replace(ctx, step_parity=True, chunk_store=store)
    x = _chunk_stack(ctx, model, tokens, cache, row, start, length)
    return _head(ctx, model, x), cache


def decode_step(ctx: Ctx, model: LM, token: torch.Tensor,
                cache: List[Dict]) -> Tuple[torch.Tensor, List[Dict]]:
    """One token for every row; token (B, 1). The cache is updated in
    place and returned (an encoder-decoder's cross memory is read, never
    written)."""
    cfg = model.cfg
    x = embed(model.embed, token, ctx.compute_dtype)
    for blk, c in zip(model.blocks, cache):
        y, _ = _mix_step(ctx, blk, norm(blk.norm1, x, cfg.norm), c, cfg)
        x = x + y
        if blk.cross is not None:
            x = _cross(ctx, blk, x, cfg, None, c)
        if blk.mlp is not None:
            x = x + ffn(ctx, blk, x, cfg)
    x = norm(model.final_norm, x, cfg.norm)
    return _head(ctx, model, x), cache
