"""Training steps: full training, QPEFT adapter training, microbatching
(port of ``repro/train/steps.py``).

``make_train_step`` and ``make_qpeft_step`` return ``step(state, batch)
-> (state, metrics)``. The
state's tensors are updated in place (``optim.adamw``) and the step
returns the state with its new step count; ``metrics`` holds ``loss``,
``grad_norm`` and ``step`` as tensors, with no host read in the step.

Both steps run the model with ``fused="off"``, as the JAX package's do:
the serving kernels define no backward, and their wrappers refuse an
operand that requires grad. The full step trains every float buffer of
the model (``trainable_params``); the QPEFT step (the paper's §4.4)
trains only the adapters of ``models.quantize.split_qpeft``, with the
per-rank gradient scaling (Eq. 7 / SGP, the container's ``gscale``)
applied before clipping and the optimiser, so the frozen backbone gets no
gradient and stays bit for bit as it was.

The decay mask is JAX's leaf for leaf: a scanned layer's leaves count
the stacked axis (``models.transformer.reference_lead``).

Cross-pod int8 error-feedback gradient compression is
:func:`make_compressed_sync`: each process holds its pod's mean gradient,
synced across pods with an int8 all-reduce over the mesh's ``pod`` group
(``optim.compress``).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.linear import Ctx
from repro_torch.models.quantize import merge_qpeft, qpeft_grad_scales
from repro_torch.models.transformer import LM, lm_loss, reference_lead
from repro_torch.optim import (AdamState, AdamW, apply_updates,
                               clip_by_global_norm, decay_mask,
                               ef_compressed_psum, scale_lr_grads_by_key)
from repro_torch.optim.tree import tree_leaves, tree_map


class TrainState(NamedTuple):
    params: LM               # the model; its float buffers train
    opt: AdamState
    step: torch.Tensor       # scalar int32


class QPEFTState(NamedTuple):
    trainable: Any           # {path: {"l", "r"}}: the adapters
    frozen: LM               # the quantized model (codes, scale, gscale, …)
    opt: AdamState
    step: torch.Tensor


def trainable_params(model: LM) -> Dict[str, torch.Tensor]:
    """The full step's parameter tree: every float buffer of ``model``
    by its dotted name (the model's own tensors)."""
    return {name: t for name, t in model.named_buffers()
            if t.is_floating_point()}


def init_train_state(params: LM, opt: AdamW) -> TrainState:
    return TrainState(params=params, opt=opt.init(trainable_params(params)),
                      step=torch.zeros((), dtype=torch.int32,
                                       device=params.device))


def init_qpeft_state(trainable: Any, frozen: LM, opt: AdamW) -> QPEFTState:
    return QPEFTState(trainable=trainable, frozen=frozen,
                      opt=opt.init(trainable),
                      step=torch.zeros((), dtype=torch.int32,
                                       device=frozen.device))


@dataclasses.dataclass(frozen=True)
class StepConfig:
    """``compress_pods`` and ``mesh`` are accepted as JAX's are, and
    change no number: JAX's step bodies read ``compress_pods`` nowhere
    (the compressed sync is :func:`make_compressed_sync`, called apart),
    and read ``mesh`` only for GSPMD's activation-sharding hints, which
    have no counterpart without a partitioner."""
    remat: str = "none"                  # none | full
    grad_clip: float = 1.0
    compute_dtype: Any = torch.bfloat16
    microbatch: int = 0                  # 0 = no microbatching
    compress_pods: bool = False          # int8 EF all-reduce on the 'pod' axis
    mesh: Any = None                     # the run's DeviceMesh


@contextlib.contextmanager
def _differentiable(leaves):
    """Turn on ``requires_grad`` for the duration of a loss and its
    gradients, and off again, so the model serves afterwards through the
    kernels (whose wrappers refuse a tensor that requires grad)."""
    for t in leaves:
        t.requires_grad_(True)
    try:
        yield
    finally:
        for t in leaves:
            t.requires_grad_(False)


def _value_and_grad(loss_fn: Callable, leaves, batch):
    with _differentiable(leaves):
        loss = loss_fn(batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), [torch.zeros_like(p) if g is None else g
                           for g, p in zip(grads, leaves)]


def _grads_of(loss_fn: Callable, params: Any, batch: Dict,
              micro: int) -> Tuple[torch.Tensor, Any]:
    """(loss, grads like ``params``), microbatched: each slice's gradients
    summed from f32 zeros, then the sums scaled by ``1/micro``."""
    leaves = tree_leaves(params)
    if micro <= 1:
        loss, grads = _value_and_grad(loss_fn, leaves, batch)
    else:
        b = batch["tokens"].shape[0]
        if b % micro:
            raise ValueError(f"batch {b} not divisible by microbatch {micro}")
        mb = b // micro
        loss = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
        grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 for p in leaves]
        for i in range(micro):
            li, gi = _value_and_grad(
                loss_fn, leaves,
                {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()})
            loss = loss + li
            grads = [a + g for a, g in zip(grads, gi)]
            del gi
        scale = 1.0 / micro
        loss = loss * scale
        grads = [g * scale for g in grads]
    it = iter(grads)
    return loss, tree_map(lambda _: next(it), params)


def _mask(params: Any, cfg: ModelConfig, opt: AdamW) -> Any:
    return decay_mask(params, opt.decay_exclude,
                      lead=lambda name: reference_lead(cfg, name))


def make_train_step(cfg: ModelConfig, opt: AdamW,
                    sc: StepConfig = StepConfig()) -> Callable:
    """Full-parameter LM training step."""
    ctx = Ctx(compute_dtype=sc.compute_dtype, fused="off")

    def step(state: TrainState, batch: Dict) -> Tuple[TrainState, Dict]:
        model = state.params
        params = trainable_params(model)
        loss, grads = _grads_of(
            lambda b: lm_loss(ctx, model, b, remat=sc.remat), params, batch,
            sc.microbatch)
        grads, gnorm = clip_by_global_norm(grads, sc.grad_clip)
        updates, opt_state = opt.update(grads, state.opt, params,
                                        decay=_mask(params, cfg, opt))
        del grads
        apply_updates(params, updates)
        metrics = {"loss": loss.float(), "grad_norm": gnorm,
                   "step": state.step + 1}
        return TrainState(model, opt_state, state.step + 1), metrics

    return step


def make_qpeft_step(cfg: ModelConfig, opt: AdamW,
                    sc: StepConfig = StepConfig()) -> Callable:
    """Adapter-only training on a frozen quantized backbone (§4.4): loss
    → grads → ``scale_lr_grads_by_key`` with ``qpeft_grad_scales`` →
    ``clip_by_global_norm`` → AdamW → apply."""
    ctx = Ctx(compute_dtype=sc.compute_dtype, fused="off")

    def step(state: QPEFTState, batch: Dict) -> Tuple[QPEFTState, Dict]:
        frozen = state.frozen
        model = merge_qpeft(state.trainable, frozen)
        loss, grads = _grads_of(
            lambda b: lm_loss(ctx, model, b, remat=sc.remat),
            state.trainable, batch, sc.microbatch)
        # paper Eq. 7 / SGP: attenuate preserved-direction gradients
        grads = scale_lr_grads_by_key(
            grads, qpeft_grad_scales(state.trainable, frozen))
        grads, gnorm = clip_by_global_norm(grads, sc.grad_clip)
        updates, opt_state = opt.update(
            grads, state.opt, state.trainable,
            decay=_mask(state.trainable, cfg, opt))
        trainable = apply_updates(state.trainable, updates)
        metrics = {"loss": loss.float(), "grad_norm": gnorm,
                   "step": state.step + 1}
        return QPEFTState(trainable, frozen, opt_state, state.step + 1), \
            metrics

    return step


# ==========================================================================
# Cross-pod compressed gradient sync (opt-in, over the mesh's 'pod' group)
# ==========================================================================
def make_compressed_sync(mesh) -> Callable:
    """Returns ``sync(grads, ef) -> (synced, ef')``: the int8 EF mean over
    ``mesh``'s ``"pod"`` dim group, each process holding its pod's
    gradients as plain tensors (JAX's ``shard_map`` over ``specs`` has no
    counterpart: the gradients are already each process's own)."""
    group = mesh.get_group("pod")

    def sync(grads, ef):
        return ef_compressed_psum(grads, ef, group)

    return sync
