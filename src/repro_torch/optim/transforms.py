"""Gradient transforms: clipping and SRR gradient scaling (port of
``repro/optim/transforms.py``).

The SRR QPEFT rule (paper Eq. 7–9) attenuates gradients along preserved
adapter directions. It is a gradient transform applied before the
optimiser update, so it composes with AdamW; the per-rank scale vectors
are precomputed (the container's ``gscale``).
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.core.qpeft import (AdapterParams, AdapterStatic,
                                    scale_adapter_grads)
from repro_torch.optim.tree import tree_leaves, tree_map


def global_norm(tree: Any) -> torch.Tensor:
    """‖tree‖₂ over all leaves, in f32, summed leaf by leaf."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


@torch.no_grad()
def clip_by_global_norm(grads: Any, max_norm: float
                        ) -> tuple[Any, torch.Tensor]:
    """Returns (clipped grads, pre-clip norm): every leaf times
    ``min(1, max_norm / max(norm, 1e-12))``, in the leaf's own tensor
    (a full-width model's gradients take a fifth of the card)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return tree_map(lambda g: g.copy_((g.float() * scale).to(g.dtype)),
                    grads), norm


def srr_grad_transform(statics: Any) -> Callable[[Any], Any]:
    """Transform scaling ``AdapterParams`` gradients by their per-rank
    vectors. ``statics`` is a tree aligned with the gradient tree, with
    ``AdapterStatic`` where the gradients have ``AdapterParams``; other
    leaves pass through unchanged."""
    def transform(grads: Any) -> Any:
        return _walk_adapters(grads, statics)
    return transform


def _walk_adapters(g: Any, s: Any) -> Any:
    if isinstance(g, AdapterParams):
        return scale_adapter_grads(g, s) if isinstance(s, AdapterStatic) \
            else g
    if isinstance(g, dict):
        return {k: _walk_adapters(v, s[k]) for k, v in g.items()}
    if isinstance(g, (list, tuple)):
        return type(g)(_walk_adapters(v, sv) for v, sv in zip(g, s))
    return g


def scale_lr_grads_by_key(grads: Any, scales: Any) -> Any:
    """The model zoo's QPEFT variant: the trainable tree holds
    ``{"l": (…, m, r), "r": (…, r, n)}`` dicts, ``scales`` matching
    ``{"gscale": (…, r)}`` dicts; ``l``'s columns and ``r``'s rows are
    multiplied by the per-rank vector, over any leading (expert) axes."""
    def walk(g: Any, s: Any) -> Any:
        if isinstance(g, dict) and "l" in g and "r" in g:
            vec = s["gscale"] if isinstance(s, dict) and "gscale" in s \
                else None
            if vec is None:
                return g
            out = dict(g)
            out["l"] = g["l"] * vec[..., None, :]
            out["r"] = g["r"] * vec[..., :, None]
            return out
        if isinstance(g, dict):
            return {k: walk(v, s.get(k) if isinstance(s, dict) else None)
                    for k, v in g.items()}
        if isinstance(g, (list, tuple)):
            ss = s if isinstance(s, (list, tuple)) else [None] * len(g)
            return type(g)(walk(v, sv) for v, sv in zip(g, ss))
        return g
    return walk(grads, scales)
