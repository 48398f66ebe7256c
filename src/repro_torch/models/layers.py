"""Shared building blocks: RMSNorm and LayerNorm, RoPE (full or half),
the SwiGLU and GELU MLPs, the embedding and the chunked cross-entropy
(port of ``repro/models/layers.py``, the parts the models use)."""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from repro_torch.models.linear import Ctx, FpLinear, linear


class RMSNorm(nn.Module):
    def __init__(self, g: torch.Tensor):
        super().__init__()
        self.register_buffer("g", g)


def rmsnorm(p: RMSNorm, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    y = xf * torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True) + eps)
    return (y * p.g.float()).to(x.dtype)


class LayerNorm(nn.Module):
    """LayerNorm's gain ``g`` and shift ``b`` (JAX's ``init_norm(kind=
    "layernorm")``)."""

    def __init__(self, g: torch.Tensor, b: torch.Tensor):
        super().__init__()
        self.register_buffer("g", g)
        self.register_buffer("b", b)


def layernorm(p: LayerNorm, x: torch.Tensor,
              eps: float = 1e-6) -> torch.Tensor:
    """Mean and variance over the last axis in f32, as JAX's ``norm``
    computes them (the variance as the mean of squared deviations)."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).pow(2).mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p.g.float() + p.b.float()).to(x.dtype)


def init_norm(d: int, kind: str, device) -> nn.Module:
    """Unit gain (and zero shift) for ``cfg.norm``'s kind."""
    g = torch.ones((d,), device=device)
    return RMSNorm(g) if kind == "rmsnorm" else \
        LayerNorm(g, torch.zeros((d,), device=device))


def norm(p: nn.Module, x: torch.Tensor, kind: str) -> torch.Tensor:
    """``cfg.norm``'s normalisation (``rmsnorm`` | ``layernorm``), as
    JAX's ``norm(params, x, kind)``."""
    return rmsnorm(p, x) if kind == "rmsnorm" else layernorm(p, x)


def rope_frequencies(head_dim: int, theta: float, device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               kind: str = "full") -> torch.Tensor:
    """Rotary embedding in interleaved pairs. x: (B, S, H, D); positions:
    (B, S) or (S,). kind: full — rotate all D dims; half — the first D/2
    only, with frequencies over D/2 (the JAX package's ChatGLM 2d-RoPE
    layout), the rest passed through; none — passthrough."""
    if kind == "none":
        return x
    d = x.shape[-1]
    rot_d = d if kind == "full" else d // 2
    freqs = rope_frequencies(rot_d, theta, x.device)
    if positions.ndim == 1:
        positions = positions[None, :]
    ang = positions[..., None].float() * freqs           # (B, S, rot_d/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    xr = x[..., :rot_d].float()
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    rotated = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                          dim=-1).reshape(xr.shape)
    if rot_d < d:
        rotated = torch.cat([rotated, x[..., rot_d:].float()], dim=-1)
    return rotated.to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu's default is the tanh approximation
    return torch.nn.functional.gelu(x, approximate="tanh")


class MLP(nn.Module):
    """SwiGLU, ``down(silu(gate(x)) * up(x))``, or, with ``gate=None``
    (``act="gelu"``: JAX's ``init_mlp`` makes no gate), the GELU MLP
    ``down(gelu(up(x)))``."""

    def __init__(self, up: nn.Module, gate: Optional[nn.Module],
                 down: nn.Module):
        super().__init__()
        self.up, self.gate, self.down = up, gate, down


def mlp(ctx: Ctx, p: MLP, x: torch.Tensor, prefix: str = "") -> torch.Tensor:
    up = linear(ctx, p.up, x, f"{prefix}.up")
    if p.gate is None:
        h = gelu(up)
    else:
        h = torch.nn.functional.silu(
            linear(ctx, p.gate, x, f"{prefix}.gate")) * up
    return linear(ctx, p.down, h, f"{prefix}.down")


def init_linear(gen: torch.Generator, m: int, n: int, std: float,
                device) -> FpLinear:
    return FpLinear(torch.randn((m, n), generator=gen, device=device) * std)


def embed(w: torch.Tensor, tokens: torch.Tensor, dtype) -> torch.Tensor:
    return w[tokens].to(dtype)


def chunked_softmax_xent(x: torch.Tensor, head: nn.Module,
                         labels: torch.Tensor, ctx: Ctx,
                         chunk: int = 512) -> torch.Tensor:
    """Mean token cross-entropy of the (B, S, D) hidden states against
    (B, S) labels, over sequence chunks so the (B, S, V) logits never
    exist at once; the head records no calibration tap (it stays full
    precision). Returns a scalar f32."""
    if ctx.tap is not None:
        ctx = dataclasses.replace(ctx, tap=None)
    b, s, _ = x.shape
    c = min(chunk, s)
    while s % c:
        c -= 1
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, s, c):
        logits = linear(ctx, head, x[:, i:i + c]).float()       # (B, c, V)
        lab = logits.gather(-1, labels[:, i:i + c, None].long())[..., 0]
        total = total + (torch.logsumexp(logits, dim=-1) - lab).sum()
    return total / (b * s)
