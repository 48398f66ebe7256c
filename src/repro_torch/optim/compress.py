"""Error-feedback int8 gradient compression for cross-pod data parallelism
(port of ``repro/optim/compress.py``).

Where the ``pod`` mesh axis rides a link an order of magnitude slower
than the links inside a pod, the cross-pod gradient all-reduce dominates;
compressing it from f32 to int8 cuts its bytes 4× at the cost of
quantization noise, which *error feedback* (Karimireddy et al., 2019;
QSGD, Alistarh et al., 2017) makes asymptotically harmless: the residual
of each step's quantization is added back before the next step's
compression, so noise averages out instead of accumulating.

Usage, each process holding its pod's mean gradient (see
``repro_torch.train.steps.make_compressed_sync``):

    g_sync, new_ef = ef_compressed_psum(g_local, ef_state, group)

Per leaf: one ``all_reduce(MAX)`` of the amax (the shared scale) and one
``all_reduce(SUM)`` of the int32 codes. Gradient trees are walked with
:mod:`repro_torch.optim.tree`.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.optim.tree import tree_leaves, tree_map


def _qmax(like: torch.Tensor) -> torch.Tensor:
    """127 as a tensor beside ``like``: the card divides by a Python
    scalar as a multiply by its rounded reciprocal, by a tensor as IEEE
    division, as the CPU and XLA do."""
    return torch.full_like(like, 127.0)


def init_error_feedback(grads_like: Any) -> Any:
    """Zero residual buffers matching the gradient tree (f32)."""
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads_like)


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8: returns (codes int8, scale f32 scalar)."""
    amax = x.abs().max()
    scale = torch.clamp(amax, min=1e-30) / _qmax(amax)
    codes = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return codes, scale


def dequantize_int8(codes: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return codes.float() * scale


def _one(g: torch.Tensor, e: torch.Tensor, n: torch.Tensor,
         group) -> Tuple[torch.Tensor, torch.Tensor]:
    g = g.float() + e
    # shared scale across the group so codes are summable
    amax = g.abs().max()
    dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    scale = torch.clamp(amax, min=1e-30) / _qmax(amax)
    codes = torch.clamp(torch.round(g / scale), -127, 127)
    summed = codes.to(torch.int32)
    dist.all_reduce(summed, op=dist.ReduceOp.SUM, group=group)
    synced = summed.float() * scale / n
    return synced, g - codes * scale


def ef_compressed_psum(grads: Any, ef: Any,
                       group: Optional[dist.ProcessGroup] = None
                       ) -> Tuple[Any, Any]:
    """Compressed mean over ``group``'s ranks (the default group when
    None) with error feedback.

    Per leaf: c = Q8(g + ef);  synced = Σc·scale/n;  ef' = (g + ef) − deq(c).
    The sum runs on int32 accumulations of int8 codes (codes fit: ≤127·n
    for n ≤ 2^24 ranks); the mean divides by n as a tensor, so the card
    and the CPU round it alike."""
    gs, es = tree_leaves(grads), tree_leaves(ef)
    if len(gs) != len(es):
        raise ValueError(f"{len(gs)} gradient leaves, {len(es)} residuals")
    world = float(dist.get_world_size(group))
    out = [_one(g, e, torch.tensor(world, device=g.device), group)
           for g, e in zip(gs, es)]
    synced, new_ef = iter([s for s, _ in out]), iter([r for _, r in out])
    return (tree_map(lambda _: next(synced), grads),
            tree_map(lambda _: next(new_ef), grads))
