"""Fine-grained Mixture-of-Experts, DeepSeek-MoE style (port of
``repro/models/moe.py`` for serving).

``n_shared`` always-on experts (one SwiGLU :class:`~repro_torch.models.
layers.MLP` of width ``n_shared · d_expert``) plus ``n_routed`` experts
with top-k routing. The dispatch is capacity-based scatter/gather
(Switch-style) into an ``(E, capacity, d)`` buffer, and the experts run
on it as stacks: ``experts`` is an :class:`MLP` whose three projections
carry a leading expert axis (``models.linear``), applied by
:func:`~repro_torch.models.linear.linear_stack` — K6 for int8 stacks on
the card, told by each expert's count of kept assignments which rows of
its queue hold a token.

The JAX function also returns the Switch load-balancing term
``E·Σ importance·load``; here :func:`route` appends it to ``ctx.aux_log``
when that is set (``lm_loss`` adds it to the loss; the engine never sets
it), so :func:`moe_apply` returns the output alone.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import MLP, init_linear, mlp
from repro_torch.models.linear import Ctx, FpLinear, linear, linear_stack

# At most this many tokens (or t·k ≤ 2e) the capacity is t itself, so the
# dispatch never drops a token: decode and short prompts are dropless
# (repro/models/moe.py:103-106).
DROPLESS_MAX_TOKENS = 64


class MoE(nn.Module):
    """``router`` (d, E) projection, ``experts`` (stacked SwiGLU),
    ``shared`` (SwiGLU MLP or ``None``)."""

    def __init__(self, router: nn.Module, experts: MLP,
                 shared: Optional[MLP]):
        super().__init__()
        self.router, self.experts, self.shared = router, experts, shared


def _init_stack(gen: torch.Generator, e: int, m: int, n: int, std: float,
                device) -> FpLinear:
    w = torch.randn((e, m, n), generator=gen, device=device)
    return FpLinear(w.mul_(std))


def init_moe(gen: torch.Generator, cfg: ModelConfig, device) -> MoE:
    """Random f32 MoE block with the JAX package's init scales."""
    d, de, e = cfg.d_model, cfg.d_expert, cfg.n_routed
    router = init_linear(gen, d, e, d ** -0.5, device)
    experts = MLP(_init_stack(gen, e, d, de, d ** -0.5, device),
                  _init_stack(gen, e, d, de, d ** -0.5, device),
                  _init_stack(gen, e, de, d, de ** -0.5, device))
    shared = None
    if cfg.n_shared:
        ds = cfg.n_shared * de
        shared = MLP(init_linear(gen, d, ds, d ** -0.5, device),
                     init_linear(gen, d, ds, d ** -0.5, device),
                     init_linear(gen, ds, d, ds ** -0.5, device))
    return MoE(router, experts, shared)


def capacity(t: int, cfg: ModelConfig) -> int:
    """Per-expert queue length for ``t`` tokens: ``t`` (dropless) when
    ``t·k ≤ 2e`` or ``t ≤ 64``, else ``int(max(1, t·k·cf / e))``."""
    e, k = cfg.n_routed, cfg.top_k
    if t * k <= 2 * e or t <= DROPLESS_MAX_TOKENS:
        return t
    return int(max(1, t * k * cfg.capacity_factor / e))


def route(ctx: Ctx, p: MoE, xf: torch.Tensor, k: int
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """(expert index (T, k) int64, gate (T, k) f32): f32 softmax over the
    router logits, top-k with ties to the lower index (as
    ``jax.lax.top_k``), gates renormalised by their sum."""
    probs = torch.softmax(linear(ctx, p.router, xf, "moe.router").float(),
                          dim=-1)
    if ctx.route_replay is not None:
        idx = next(ctx.route_replay).to(probs.device)
    else:
        # a stable descending sort keeps equal probabilities in index
        # order; torch.topk promises no order among ties
        idx = torch.sort(probs, dim=-1, descending=True,
                         stable=True).indices[:, :k]
    if ctx.route_log is not None:
        ctx.route_log.append(idx)
    if ctx.aux_log is not None:
        # importance (mean router probability) × load (share of the top-k
        # assignments) per expert
        flat = idx.reshape(-1)
        load = torch.zeros_like(probs[0]).index_add_(
            0, flat, torch.ones_like(flat, dtype=probs.dtype)) / xf.shape[0]
        ctx.aux_log.append(probs.shape[-1]
                           * (probs.mean(dim=0) * load).sum())
    gate = probs.gather(-1, idx)
    return idx, gate / gate.sum(dim=-1, keepdim=True).clamp_min(1e-9)


def expert_ffn(ctx: Ctx, experts: MLP, buf: torch.Tensor,
               counts: torch.Tensor) -> torch.Tensor:
    """SwiGLU over the whole expert stack; buf (E, C, d). ``counts`` (E,)
    int32: the leading rows of each expert's queue that hold a token (buf
    is zero past them); the kernel path skips the rest."""
    dt = buf.dtype
    gate = linear_stack(ctx, experts.gate, buf, counts)
    h = torch.nn.functional.silu(gate) * linear_stack(ctx, experts.up, buf,
                                                      counts)
    return linear_stack(ctx, experts.down, h.to(dt), counts).to(dt)


def moe_apply(ctx: Ctx, p: MoE, x: torch.Tensor,
              cfg: ModelConfig) -> torch.Tensor:
    """x (B, S, D) → (B, S, D). Every one of the ``B·S`` tokens routes
    (pad tokens of a right-padded prompt too, after the real ones in flat
    order); an assignment whose queue position reaches the capacity is
    dropped."""
    b, s, d = x.shape
    t = b * s
    e, k = cfg.n_routed, cfg.top_k
    cap = capacity(t, cfg)
    xf = x.reshape(t, d)
    idx, gate = route(ctx, p, xf, k)

    # position of each assignment in its expert's queue, in flat
    # (token, k) order
    flat_e = idx.reshape(-1)                                  # (T·k,)
    onehot = torch.nn.functional.one_hot(flat_e, e)           # (T·k, E)
    position = (onehot.cumsum(dim=0) - onehot).gather(
        1, flat_e[:, None])[:, 0]
    keep = position < cap
    # kept (expert, position) pairs are distinct, so the dispatch is a
    # plain copy (no accumulation, deterministic on the card); dropped
    # assignments land in one extra row that is cut off
    dest = torch.where(keep, flat_e * cap + position,
                       torch.full_like(flat_e, e * cap))
    flat_tok = torch.arange(t, device=x.device).repeat_interleave(k)
    buf = xf.new_zeros((e * cap + 1, d))
    buf.index_copy_(0, dest, xf[flat_tok])
    # kept assignments per expert: its queue's leading rows, zero past
    # them (from the one-hot, on the device: no host sync)
    counts = onehot.sum(dim=0).clamp_max(cap).int()
    out = expert_ffn(ctx, p.experts, buf[:-1].reshape(e, cap, d), counts)

    gathered = out.reshape(e * cap, d)[torch.where(keep, dest, 0)]
    gathered = torch.where(keep[:, None], gathered, torch.zeros_like(gathered))
    # the gate-weighted combine sums each token's k outputs in a fixed
    # order (no scatter-add: atomics on the card)
    combined = (gathered * gate.reshape(-1, 1).to(xf.dtype)) \
        .reshape(t, k, d).sum(dim=1)
    if p.shared is not None:
        combined = combined + mlp(ctx, p.shared, xf, "moe.shared")
    return combined.reshape(b, s, d)
