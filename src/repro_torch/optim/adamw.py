"""AdamW and LR schedules (port of ``repro/optim/adamw.py``).

The optimiser is an ``(init, update)`` pair over trees of tensors
(``optim.tree``), the JAX package's optax-like contract, so the SRR
gradient scaling (``optim.transforms``) composes in front of it. The
arithmetic is the JAX package's, written out: ``torch.optim.AdamW``
orders it otherwise. Unlike the JAX pair, the port updates in place,
since a full-width model's four f32 trees (params, grads, μ, ν) take
most of the card: :meth:`AdamW.update` advances μ and ν in their
tensors and writes each update into its gradient's, and
:func:`apply_updates` adds them to the parameters' own tensors.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch.optim.tree import (dotted, tree_leaves, tree_map,
                                    tree_map_with_path)


class AdamState(NamedTuple):
    step: torch.Tensor   # scalar int32
    mu: Any              # first moment, like params (f32)
    nu: Any              # second moment, like params (f32)


@dataclasses.dataclass(frozen=True)
class AdamW:
    learning_rate: Callable[[torch.Tensor], torch.Tensor] | float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    # weight decay mask: leaves whose last name is in this set are excluded
    decay_exclude: Tuple[str, ...] = ("g", "b")

    def init(self, params: Any) -> AdamState:
        leaves = tree_leaves(params)
        device = leaves[0].device if leaves else None
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
        return AdamState(step=torch.zeros((), dtype=torch.int32,
                                          device=device),
                         mu=tree_map(zeros, params), nu=tree_map(zeros, params))

    def _lr(self, step: torch.Tensor) -> torch.Tensor:
        if callable(self.learning_rate):
            return self.learning_rate(step)
        return torch.tensor(self.learning_rate, dtype=torch.float32,
                            device=step.device)

    @torch.no_grad()
    def update(self, grads: Any, state: AdamState, params: Any,
               decay: Optional[Any] = None) -> tuple[Any, AdamState]:
        """Returns ``(updates, new_state)``; apply with
        :func:`apply_updates`. The learning rate is read at the new step
        count. ``decay`` is a tree of 0/1 weights like ``params``
        (:func:`decay_mask`; by default from ``params``' own names and
        ranks). μ and ν advance in place, and each update is written into
        its gradient's tensor (module docstring)."""
        step = state.step + 1
        lr = self._lr(step)
        b1, b2 = self.b1, self.b2
        c1 = 1.0 - b1 ** step.float()
        c2 = 1.0 - b2 ** step.float()
        if decay is None:
            decay = decay_mask(params, self.decay_exclude)

        def upd(g, m, v, p, do_decay):
            gf = g.float()
            m.mul_(b1).add_((1 - b1) * gf)
            v.mul_(b2).add_((1 - b2) * gf * gf)
            u = (m / c1) / (torch.sqrt(v / c2) + self.eps)
            if self.weight_decay:
                u = u + self.weight_decay * do_decay * p.float()
            u = (-lr * u).to(p.dtype)
            if g.dtype != u.dtype:
                return u
            return g.copy_(u)

        updates = tree_map(upd, grads, state.mu, state.nu, params, decay)
        return updates, AdamState(step=step, mu=state.mu, nu=state.nu)


def decay_mask(params: Any, exclude: Tuple[str, ...] = ("g", "b"),
               lead: Optional[Callable[[str], int]] = None) -> Any:
    """JAX's ``_decay_mask``: 0.0 for a leaf whose last name is in
    ``exclude`` or whose rank is at most 1, else 1.0. ``lead(name)``
    gives the leading axes the JAX tree stacks in front of the port's
    leaf ``name`` (its scanned layers; ``models.transformer.
    reference_lead``), so that ranks are counted as JAX counts them."""
    def mask(path, p):
        name = dotted(path)
        ndim = p.ndim + (lead(name) if lead is not None else 0)
        last = name.rsplit(".", 1)[-1]
        return 0.0 if last in exclude or ndim <= 1 else 1.0
    return tree_map_with_path(mask, params)


@torch.no_grad()
def apply_updates(params: Any, updates: Any) -> Any:
    """``p + u`` into each parameter's own tensor; returns ``params``."""
    tree_map(lambda p, u: p.add_(u.to(p.dtype)), params, updates)
    return params


# ==========================================================================
# Schedules
# ==========================================================================
def cosine_schedule(peak: float, warmup_steps: int, total_steps: int,
                    floor: float = 0.0
                    ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Linear warmup → cosine decay to ``floor``."""
    def lr(step: torch.Tensor) -> torch.Tensor:
        s = torch.as_tensor(step).float()
        warm = peak * s / max(warmup_steps, 1)
        t = torch.clamp((s - warmup_steps)
                        / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = floor + 0.5 * (peak - floor) * (1 + torch.cos(math.pi * t))
        return torch.where(s < warmup_steps, warm, cos)
    return lr


def constant_schedule(value: float
                      ) -> Callable[[torch.Tensor], torch.Tensor]:
    return lambda step: torch.tensor(value, dtype=torch.float32,
                                     device=torch.as_tensor(step).device)
