"""RG-LRU recurrent block (Griffin / RecurrentGemma; port of
``repro/models/rglru.py``).

Block:  x → [gate branch: W_gate → GeLU] ⊙ [W_branch → causal conv1d(w) →
RG-LRU] → W_out.  The RG-LRU recurrence

    r_t = σ(W_a h̃_t + b_a)         (recurrence gate)
    i_t = σ(W_x h̃_t + b_x)         (input gate)
    log a_t = −c · r_t · softplus(Λ)
    y_t = a_t ⊙ y_{t−1} + sqrt(1 − a_t²) ⊙ (i_t ⊙ h̃_t)

is a diagonal linear recurrence: prefill runs it as a log-depth scan over
the sequence (:func:`linear_scan`, in place of JAX's
``associative_scan``), decode carries the state (y in f32, the last
``conv_width − 1`` branch inputs, ``pos``) at O(1) cost a step.

Cache per RG-LRU layer (``init_rglru_cache``):
  ``h``    (B, dr) f32 — the pre-gate recurrent state y;
  ``conv`` (B, cw − 1, dr) in the cache's float dtype (bf16 under an
           int8/int4 KV request, as the JAX package's rule has it);
  ``pos``  (B,) int32.
Prefill returns fresh tensors (a serving template stays zero); a decode
step rebinds the three entries of the layer's dict to new tensors and
never writes into the old ones, so keeping references undoes it
(``models.attention.save_step_writes``).

The conv is written as the JAX package writes it: a sum of ``cw`` shifted
products in x's dtype, in its order — not ``F.conv1d``, which runs a
float32 convolution on the card through cuDNN in TF32.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import gelu, init_linear
from repro_torch.models.linear import Ctx, linear

C_GATE = 8.0  # Griffin's fixed gate sharpness

# the projections of an RG-LRU mixer, in the JAX tree's order
RGLRU_PROJECTIONS = ("w_gate", "w_branch", "w_out", "w_a", "w_x")


class RGLRU(nn.Module):
    """``w_gate``/``w_branch`` (d, dr), ``w_out`` (dr, d), ``w_a``/``w_x``
    (dr, dr) with biases; ``conv_w`` (cw, dr), ``conv_b`` (dr,) and
    ``lam`` (dr,) stay full precision (the PTQ pass leaves them)."""

    def __init__(self, w_gate: nn.Module, w_branch: nn.Module,
                 w_out: nn.Module, w_a: nn.Module, w_x: nn.Module,
                 conv_w: torch.Tensor, conv_b: torch.Tensor,
                 lam: torch.Tensor):
        super().__init__()
        self.w_gate, self.w_branch, self.w_out = w_gate, w_branch, w_out
        self.w_a, self.w_x = w_a, w_x
        self.register_buffer("conv_w", conv_w)
        self.register_buffer("conv_b", conv_b)
        self.register_buffer("lam", lam)


def init_rglru(gen: torch.Generator, cfg: ModelConfig, device) -> RGLRU:
    """Random f32 mixer with ``repro/models/rglru.py::init_rglru``'s
    scales: Λ so that a = σ(Λ)^c lies in (0.9, 0.999) (Griffin's
    appendix), ``lam = log(expm1(−log u / c))``, u ~ U(0.9, 0.999)."""
    d, dr, cw = cfg.d_model, cfg.d_rnn_, cfg.conv_width

    def biased(m: int, n: int):
        p = init_linear(gen, m, n, m ** -0.5, device)
        p.b = torch.zeros((n,), device=device)
        return p

    w_gate = init_linear(gen, d, dr, d ** -0.5, device)
    w_branch = init_linear(gen, d, dr, d ** -0.5, device)
    w_out = init_linear(gen, dr, d, dr ** -0.5, device)
    w_a, w_x = biased(dr, dr), biased(dr, dr)
    conv_w = torch.randn((cw, dr), generator=gen, device=device) / cw ** 0.5
    u = 0.9 + 0.099 * torch.rand((dr,), generator=gen, device=device)
    lam = torch.log(torch.expm1(-torch.log(u) / C_GATE))
    return RGLRU(w_gate, w_branch, w_out, w_a, w_x, conv_w,
                 torch.zeros((dr,), device=device), lam)


def init_rglru_cache(cfg: ModelConfig, batch: int, dtype,
                     device) -> Dict[str, torch.Tensor]:
    """Zeroed state for ``batch`` rows; ``dtype`` is the float type of
    the conv history."""
    dr = cfg.d_rnn_
    return {"h": torch.zeros((batch, dr), device=device),
            "conv": torch.zeros((batch, cfg.conv_width - 1, dr), dtype=dtype,
                                device=device),
            "pos": torch.zeros((batch,), dtype=torch.int32, device=device)}


def _conv(p: RGLRU, xp: torch.Tensor, s: int) -> torch.Tensor:
    """Depthwise causal conv of the history-prefixed ``xp`` (B, cw − 1 + s,
    dr) → (B, s, dr): JAX's ``sum(xp[:, i:i+s] · w[i]) + b`` in x's
    dtype, in its order."""
    w = p.conv_w.to(xp.dtype)
    y = xp[:, 0:s] * w[0]
    for i in range(1, w.shape[0]):
        y = y + xp[:, i:i + s] * w[i]
    return y + p.conv_b.to(xp.dtype)


def _gates(ctx: Ctx, p: RGLRU, h: torch.Tensor, prefix: str
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(a, b) in f32: the recurrence's transition and input terms."""
    r = torch.sigmoid(linear(ctx, p.w_a, h, f"{prefix}.w_a").float())
    i = torch.sigmoid(linear(ctx, p.w_x, h, f"{prefix}.w_x").float())
    log_a = -C_GATE * r * F.softplus(p.lam.float())
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), 1e-12, 1.0))
    return a, beta * i * h.float()


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """All prefixes of ``y_t = a_t · y_{t−1} + b_t`` (y_{−1} = 0) over axis
    1, by Hillis–Steele doubling: ⌈log₂ S⌉ passes, each combining step t
    with step t − d. The same prefixes as JAX's ``associative_scan`` of
    ``(a1·a2, a2·b1 + b2)``, summed in another order (ulp-level in
    f32)."""
    d = 1
    while d < a.shape[1]:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def rglru_seq(ctx: Ctx, p: RGLRU, x: torch.Tensor, cfg: ModelConfig,
              cache: Optional[Dict] = None,
              lengths: Optional[torch.Tensor] = None, prefix: str = "rglru"
              ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Full-sequence block (prefill / calibration); x (B, S, D).

    ``lengths`` (B,): each row's valid prefix of a right-padded prompt.
    Pad steps take the identity transition (a = 1, b = 0), so the scan
    carries each row's state at its last valid step to the end; the conv
    history kept for decode is each row's ``cw − 1`` branch inputs before
    its length. With a cache: a fresh ``h``/``conv``/``pos``."""
    b, s, _ = x.shape
    gate = gelu(linear(ctx, p.w_gate, x, f"{prefix}.w_gate"))
    branch = linear(ctx, p.w_branch, x, f"{prefix}.w_branch")
    cw = p.conv_w.shape[0]
    hist = cache["conv"] if cache is not None else torch.zeros(
        (b, cw - 1, branch.shape[-1]), dtype=branch.dtype, device=x.device)
    xp = torch.cat([hist.to(branch.dtype), branch], dim=1)
    h = _conv(p, xp, s)
    a, bb = _gates(ctx, p, h, prefix)                    # (B, S, dr) f32
    if lengths is not None:
        valid = (torch.arange(s, device=x.device)[None, :]
                 < lengths.to(x.device)[:, None])[..., None]
        a = torch.where(valid, a, 1.0)
        bb = torch.where(valid, bb, 0.0)
    y_scan = linear_scan(a, bb)
    y = y_scan.to(x.dtype) * gate
    out = linear(ctx, p.w_out, y, f"{prefix}.w_out")
    if cache is None:
        return out, None
    new = {"h": y_scan[:, -1].contiguous()}
    if lengths is None:
        new["conv"] = xp[:, xp.shape[1] - (cw - 1):].to(cache["conv"].dtype)
        new["pos"] = torch.full((b,), s, dtype=torch.int32, device=x.device)
    else:
        ix = (lengths.to(torch.int64)[:, None]
              + torch.arange(cw - 1, device=x.device)[None, :])[..., None]
        new["conv"] = torch.take_along_dim(xp, ix, dim=1).to(
            cache["conv"].dtype)
        new["pos"] = lengths.to(torch.int32)
    new["conv"] = new["conv"].contiguous()
    return out, new


def rglru_step(ctx: Ctx, p: RGLRU, x: torch.Tensor, cache: Dict,
               cfg: ModelConfig, prefix: str = "rglru"
               ) -> Tuple[torch.Tensor, Dict]:
    """One decode step, x (B, 1, D): the cache's three entries are
    rebound to the new state (module docstring)."""
    gate = gelu(linear(ctx, p.w_gate, x, f"{prefix}.w_gate"))
    branch = linear(ctx, p.w_branch, x, f"{prefix}.w_branch")
    hist = torch.cat([cache["conv"].to(branch.dtype), branch], dim=1)
    h = _conv(p, hist, 1)
    a, b = _gates(ctx, p, h, prefix)                    # (B, 1, dr)
    y = a[:, 0] * cache["h"] + b[:, 0]
    out = linear(ctx, p.w_out, y[:, None, :].to(x.dtype) * gate,
                 f"{prefix}.w_out")
    cache["h"] = y
    cache["conv"] = hist[:, 1:].to(cache["conv"].dtype).contiguous()
    cache["pos"] = cache["pos"] + 1
    return out, cache
