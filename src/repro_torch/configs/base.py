"""Architecture configuration: the port's copy of ``repro.configs.base``.

One :class:`ModelConfig` describes every family the JAX package
supports; the port serves the dense GQA decoder, its MoE variant
(DeepSeek-style: dense lead-in layers, then routed + shared experts),
MLA attention over either FFN, the RG-LRU hybrid, xLSTM and the
encoder-decoder; ``models.transformer`` rejects the rest (vision
prefixes). ``reduced()``
shrinks a config to smoke-test size while preserving the family
structure, exactly as the JAX package does, so parity tests build the
same shapes on both sides.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | audio | hybrid | moe | vlm | ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    head_dim: int = 0               # 0 → d_model // n_heads
    block_pattern: Tuple[str, ...] = ("attn",)  # attn|local|rglru|slstm|mlstm
    attn_kind: str = "gqa"          # gqa | mla
    qkv_bias: bool = False
    rope_kind: str = "full"         # full | half | none
    rope_theta: float = 10_000.0
    act: str = "swiglu"             # swiglu | gelu
    norm: str = "rmsnorm"           # rmsnorm | layernorm

    # --- MoE ---
    moe: bool = False
    n_routed: int = 0
    n_shared: int = 0
    top_k: int = 0
    d_expert: int = 0
    first_dense: int = 0            # leading dense-MLP layers (deepseek style)
    capacity_factor: float = 1.25

    # --- MLA (deepseek-v2) ---
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    rope_head_dim: int = 64

    # --- local attention / RG-LRU (recurrentgemma) ---
    window: int = 2048
    d_rnn: int = 0                  # 0 → d_model
    conv_width: int = 4

    # --- xLSTM ---
    slstm_proj_factor: float = 4.0 / 3.0
    mlstm_proj_factor: float = 2.0

    # --- encoder-decoder (whisper) ---
    enc_layers: int = 0
    enc_seq: int = 0                # fixed encoder length (whisper: 1500)
    cross_attn: bool = False
    d_frontend: int = 0             # frontend embedding dim (stub input)

    # --- VLM ---
    n_vision_tokens: int = 0        # prepended stub patch embeddings

    tie_embeddings: bool = False

    # ------------------------------------------------------------------
    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def d_rnn_(self) -> int:
        return self.d_rnn or self.d_model

    def layer_kind(self, i: int) -> str:
        return self.block_pattern[i % len(self.block_pattern)]

    def layer_kinds(self) -> Tuple[str, ...]:
        return tuple(self.layer_kind(i) for i in range(self.n_layers))

    def uses_moe_at(self, i: int) -> bool:
        return self.moe and i >= self.first_dense

    @property
    def is_encoder_decoder(self) -> bool:
        return self.enc_layers > 0

    @property
    def supports_long_context(self) -> bool:
        """True iff every sequence mixer is sub-quadratic (no global attn)."""
        return all(k != "attn" for k in set(self.block_pattern))

    @property
    def has_decode(self) -> bool:
        return True  # every assigned arch has a decoder (whisper: its decoder)

    # ------------------------------------------------------------------
    def n_params(self) -> int:
        """Approximate parameter count (embeddings + blocks), used for
        MODEL_FLOPS accounting in the roofline."""
        d, hd = self.d_model, self.head_dim_
        total = self.vocab * d  # embed
        if not self.tie_embeddings:
            total += self.vocab * d
        for i in range(self.n_layers):
            kind = self.layer_kind(i)
            if kind in ("attn", "local"):
                if self.attn_kind == "mla" and kind == "attn":
                    r, pe = self.kv_lora_rank, self.rope_head_dim
                    qdim = self.n_heads * (hd + pe)
                    total += d * (r + pe)                 # kv down + k_pe
                    total += r * self.n_heads * (hd + hd)  # k_up, v_up
                    total += (d * self.q_lora_rank + self.q_lora_rank * qdim
                              if self.q_lora_rank else d * qdim)
                    total += self.n_heads * hd * d         # o proj
                else:
                    total += d * self.n_heads * hd
                    total += 2 * d * self.n_kv_heads * hd
                    total += self.n_heads * hd * d
            elif kind == "rglru":
                dr = self.d_rnn_
                total += 2 * d * dr + dr * d  # branch, gate, out
                total += dr * self.conv_width + 3 * dr  # conv + lru gates-ish
                total += 2 * dr * dr  # gate projections W_a, W_x
            elif kind in ("slstm", "mlstm"):
                pf = (self.slstm_proj_factor if kind == "slstm"
                      else self.mlstm_proj_factor)
                dp = int(d * pf)
                total += 2 * d * dp + dp * d + 4 * dp * dp // self.n_heads
            # MLP
            if self.uses_moe_at(i):
                e_params = 3 * d * self.d_expert
                total += (self.n_routed + self.n_shared) * e_params
                total += d * self.n_routed  # router
            elif self.d_ff > 0:
                nmat = 3 if self.act == "swiglu" else 2
                total += nmat * d * self.d_ff
        if self.enc_layers:
            enc = self.enc_layers * (4 * d * self.n_heads * hd
                                     + 2 * d * self.d_ff)
            dec_cross = self.n_layers * 4 * d * self.n_heads * hd
            total += enc + dec_cross
        return total

    def n_active_params(self) -> int:
        """Active params per token (MoE: only top-k + shared experts)."""
        if not self.moe:
            return self.n_params()
        total = self.n_params()
        e_params = 3 * self.d_model * self.d_expert
        moe_layers = sum(1 for i in range(self.n_layers) if self.uses_moe_at(i))
        inactive = moe_layers * (self.n_routed - self.top_k) * e_params
        return total - inactive

    # ------------------------------------------------------------------
    def reduced(self) -> "ModelConfig":
        """Family-preserving tiny config for CPU smoke tests."""
        period = len(self.block_pattern)
        heads = 4
        kv = max(1, min(self.n_kv_heads, heads))
        while heads % kv:
            kv -= 1
        return dataclasses.replace(
            self,
            n_layers=max(2 * period, 2),
            d_model=64,
            n_heads=heads,
            n_kv_heads=kv,
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            vocab=256,
            moe=self.moe,
            n_routed=8 if self.moe else 0,
            n_shared=min(self.n_shared, 1),
            top_k=2 if self.moe else 0,
            d_expert=32 if self.moe else 0,
            first_dense=min(self.first_dense, 1),
            kv_lora_rank=16 if self.kv_lora_rank else 0,
            q_lora_rank=16 if self.q_lora_rank else 0,
            rope_head_dim=8 if self.attn_kind == "mla" else self.rope_head_dim,
            window=16,
            d_rnn=64 if self.d_rnn_ else 0,
            enc_layers=2 if self.enc_layers else 0,
            enc_seq=8 if self.enc_seq else 0,
            d_frontend=64 if self.d_frontend else 0,
            n_vision_tokens=4 if self.n_vision_tokens else 0,
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One dry-run cell: what to run and at which sizes (the JAX
    package's ``repro.configs.base.ShapeConfig``)."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """(runnable?, reason-if-skipped) for an (arch, shape) cell."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, "pure full-attention arch: 500k context needs sub-quadratic mixing"
    return True, ""
