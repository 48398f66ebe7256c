"""Abstract inputs and step builders for the dry run (port of
``repro/launch/specs.py``).

Abstract means shapes and dtypes only: every tensor here is a fake
tensor (``torch._subclasses.FakeTensorMode``), so a 32B model × 32k
context is built and stepped with nothing allocated and nothing
computed. The model is drawn by ``init_lm(cfg, device="cpu")`` under the
fake mode — the meta device is no choice, as ``init_lm``'s
``torch.Generator`` refuses it — and its fake CPU tensors take the
kernels' plain versions, which compute nothing there.

Three step kinds per (arch × shape) cell, as in JAX:

  train   : full-parameter LM training (AdamW state included), bf16
  prefill : prompt processing over the quantized Q + LR model
  decode  : one-token ``decode_step`` over the quantized model + KV cache

The quantized serving models use the int8-codes container (3-bit codes
in an int8 carrier + f32 block scales) with r = 64 adapters. Each
builder returns ``(step_fn, inputs)`` where JAX returns a ``Lowered``:
:func:`repro_torch.launch.cost.count` runs ``step_fn(*inputs)`` under
the inputs' fake mode.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.kernels.constraints import MXINT_BLOCK
from repro_torch.models import Ctx, decode_step, init_lm
from repro_torch.models.attention import INT4
from repro_torch.models.linear import FpLinear, QLinear
from repro_torch.models.transformer import LM, init_cache, prefill
from repro_torch.optim import AdamW, cosine_schedule
from repro_torch.train import StepConfig, init_train_state, make_train_step

# JAX's EXCLUDE_NAMES: full precision by PTQ policy
EXCLUDE_NAMES = {"embed", "lm_head", "vision_proj", "frontend_proj"}


@dataclasses.dataclass(frozen=True)
class DryrunOptions:
    """The JAX dry run's knobs that change the port's step. (JAX's
    ``donate``, ``q_chunk`` and ``kv_chunk`` are not here: the port's
    attention is K4, with its own tiles, and its steps update the cache
    and the state in place.)"""
    remat: str = "none"            # none | full
    microbatch: int = 0
    kv_dtype: str = "int8"         # decode cache: int8 | bf16 | int4
    rank: int = 64                 # adapter rank for serve paths
    compute_dtype: Any = torch.bfloat16


def abstract_mode() -> FakeTensorMode:
    """A fresh fake mode: the tensors of one cell are built under one."""
    return FakeTensorMode()


def abstract_params(cfg: ModelConfig, dtype=torch.bfloat16,
                    mode: Optional[FakeTensorMode] = None) -> LM:
    """The model of ``cfg`` with fake buffers, the floating ones in
    ``dtype`` (JAX's ``eval_shape`` of ``init_lm(..., dtype)``)."""
    with mode or abstract_mode():
        model = init_lm(cfg, 0, device="cpu")
        for mod in model.modules():
            for key, t in mod._buffers.items():
                if t is not None and t.is_floating_point():
                    mod._buffers[key] = t.to(dtype)
    return model


def _abstract_qlinear(p: FpLinear, rank: int, block_size: int,
                      container: str) -> QLinear:
    """:class:`QLinear` of ``p``'s shapes (``quantized_abstract``): MXINT
    row padding, ``r = min(rank, min(m, n) // 2)`` where ``min(m, n) <
    2·rank``, the int8 or packed4 container; the bias kept."""
    w = p.w
    lead, (m, n) = tuple(w.shape[:-2]), tuple(w.shape[-2:])
    mpad = -(-m // block_size) * block_size
    r = min(rank, min(m, n) // 2) if min(m, n) < 2 * rank else rank
    f32 = dict(dtype=torch.float32, device=w.device)
    store = ({"packed": torch.empty(lead + (mpad // 2, n), dtype=torch.uint8,
                                    device=w.device)}
             if container == "packed4" else
             {"codes": torch.empty(lead + (mpad, n), dtype=torch.int8,
                                   device=w.device)})
    return QLinear(torch.empty(lead + (mpad // block_size, n), **f32),
                   torch.empty(lead + (m, r), **f32),
                   torch.empty(lead + (r, n), **f32),
                   gscale=torch.empty(lead + (r,), **f32), b=p.b, **store)


def quantized_abstract(model: LM, rank: int, block_size: int = MXINT_BLOCK,
                       container: str = "int8",
                       mode: Optional[FakeTensorMode] = None) -> LM:
    """Every projection ``FpLinear`` of ``model`` outside
    ``EXCLUDE_NAMES`` replaced by its abstract :class:`QLinear`, in
    place (what ``quantize_model_params`` makes, without a weight)."""
    with mode or abstract_mode():
        for path, p in list(model.named_modules()):
            if not isinstance(p, FpLinear) or p.w.ndim < 2 \
                    or EXCLUDE_NAMES & set(path.split(".")):
                continue
            owner, _, leaf = path.rpartition(".")
            setattr(model.get_submodule(owner) if owner else model, leaf,
                    _abstract_qlinear(p, rank, block_size, container))
    return model


def abstract_quant_params(cfg: ModelConfig, rank: int = 64,
                          mode: Optional[FakeTensorMode] = None) -> LM:
    mode = mode or abstract_mode()
    return quantized_abstract(abstract_params(cfg, mode=mode), rank=rank,
                              mode=mode)


def batch_structs(cfg: ModelConfig, shape: ShapeConfig, dtype=torch.bfloat16,
                  mode: Optional[FakeTensorMode] = None
                  ) -> Dict[str, torch.Tensor]:
    """Train/prefill batch stand-ins."""
    b, s = shape.global_batch, shape.seq_len
    with mode or abstract_mode():
        out = {"tokens": torch.empty((b, s), dtype=torch.int32)}
        if shape.kind == "train":
            out["labels"] = torch.empty((b, s), dtype=torch.int64)
        if cfg.is_encoder_decoder:
            out["frames"] = torch.empty((b, cfg.enc_seq, cfg.d_frontend),
                                        dtype=dtype)
        if cfg.n_vision_tokens:
            out["vision"] = torch.empty(
                (b, cfg.n_vision_tokens, cfg.d_frontend or cfg.d_model),
                dtype=dtype)
    return out


def abstract_cache(cfg: ModelConfig, shape: ShapeConfig,
                   opts: DryrunOptions,
                   mode: Optional[FakeTensorMode] = None):
    """``init_cache`` of the cell: ``seq_len`` slots (a prefill's vision
    rows in front), int8 / bf16 / packed int4 KV."""
    dt = {"int8": torch.int8, "int4": INT4}.get(opts.kv_dtype,
                                                torch.bfloat16)
    slots = shape.seq_len
    if shape.kind == "prefill" and cfg.n_vision_tokens:
        slots += cfg.n_vision_tokens  # vision tokens prepend to the prompt
    with mode or abstract_mode():
        return init_cache(cfg, shape.global_batch, slots, dt, "cpu")


def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                opts: DryrunOptions = DryrunOptions(),
                mode: Optional[FakeTensorMode] = None) -> Dict[str, Any]:
    """All abstract inputs for this cell's step (public dry-run surface)."""
    mode = mode or abstract_mode()
    if shape.kind == "train":
        return {"batch": batch_structs(cfg, shape, opts.compute_dtype, mode)}
    if shape.kind == "prefill":
        return {
            "batch": batch_structs(cfg, shape, opts.compute_dtype, mode),
            "cache": abstract_cache(cfg, shape, opts, mode),
        }
    # decode: one new token against a seq_len-deep cache
    with mode:
        token = torch.empty((shape.global_batch, 1), dtype=torch.int32)
    return {"token": token, "cache": abstract_cache(cfg, shape, opts, mode)}


# ==========================================================================
# Step builders (abstract in, (step_fn, inputs) out)
# ==========================================================================
def build_train_lowering(cfg: ModelConfig, shape: ShapeConfig, mesh=None,
                         opts: DryrunOptions = DryrunOptions()
                         ) -> Tuple[Callable, Tuple]:
    """``make_train_step`` with AdamW(cosine 3e-4, 100 warm-up, 10k
    steps, weight decay 0.1) over the abstract bf16 model, its Adam state
    and a batch."""
    opt = AdamW(learning_rate=cosine_schedule(3e-4, 100, 10_000),
                weight_decay=0.1)
    sc = StepConfig(remat=opts.remat, microbatch=opts.microbatch,
                    compute_dtype=opts.compute_dtype, mesh=mesh)
    mode = abstract_mode()
    params = abstract_params(cfg, opts.compute_dtype, mode)
    with mode:
        state = init_train_state(params, opt)
    return (make_train_step(cfg, opt, sc),
            (state, batch_structs(cfg, shape, opts.compute_dtype, mode)))


def build_prefill_lowering(cfg: ModelConfig, shape: ShapeConfig, mesh=None,
                           opts: DryrunOptions = DryrunOptions()
                           ) -> Tuple[Callable, Tuple]:
    """``prefill`` over the abstract quantized model, a batch and the
    cache."""
    ctx = Ctx(compute_dtype=opts.compute_dtype)

    def prefill_step(params, batch, cache):
        return prefill(ctx, params, batch["tokens"], cache,
                       frames=batch.get("frames"), vision=batch.get("vision"))

    mode = abstract_mode()
    inputs = input_specs(cfg, shape, opts, mode)
    return prefill_step, (abstract_quant_params(cfg, opts.rank, mode),
                          inputs["batch"], inputs["cache"])


def build_decode_lowering(cfg: ModelConfig, shape: ShapeConfig, mesh=None,
                          opts: DryrunOptions = DryrunOptions()
                          ) -> Tuple[Callable, Tuple]:
    """``decode_step`` over the abstract quantized model, one token a row
    and a ``seq_len``-deep cache."""
    ctx = Ctx(compute_dtype=opts.compute_dtype)

    def serve_step(params, token, cache):
        return decode_step(ctx, params, token, cache)

    mode = abstract_mode()
    inputs = input_specs(cfg, shape, opts, mode)
    return serve_step, (abstract_quant_params(cfg, opts.rank, mode),
                        inputs["token"], inputs["cache"])


BUILDERS: Dict[str, Callable] = {
    "train": build_train_lowering,
    "prefill": build_prefill_lowering,
    "decode": build_decode_lowering,
}


def build_lowering(cfg: ModelConfig, shape: ShapeConfig, mesh=None,
                   opts: DryrunOptions = DryrunOptions()
                   ) -> Tuple[Callable, Tuple]:
    return BUILDERS[shape.kind](cfg, shape, mesh, opts)
