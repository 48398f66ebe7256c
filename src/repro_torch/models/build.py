"""Build the quantized model one block at a time.

``init_lm`` → ``capture_calibration`` → ``quantize_model_params`` holds
the whole f32 model, and then every layer's Σxxᵀ, before the pass starts
to shrink it: qwen1.5-32b's 64 layers are 131 GiB in f32 and its
quantized container about 41.5 GiB. :func:`build_quantized_lm` runs the
same pipeline in another memory order. It draws the tail (embedding,
head, ``frontend_proj``, ``vision_proj``, norms) and turns the
calibration batches into the first block's inputs; then, for each block
in the pass's order (encoder blocks ``E<e>`` first, then decoder blocks
``L<i>``), it

1. takes the block's fp weights from a source (:class:`DrawnBlocks`:
   the numbers ``init_lm`` draws; :class:`ModelBlocks`: an fp model built
   elsewhere, e.g. converted from JAX's parameters);
2. runs every batch's hidden state through the fp block under its tap
   prefix, recording the statistics ``capture_calibration`` records for
   that layer over the whole fp model, and keeps the block's outputs as
   the next block's inputs (an encoder's outputs, after ``enc_norm``,
   become each batch's cross memory);
3. builds the scalings of the block's distinct moment sets;
4. quantizes the block through :class:`~repro_torch.models.quantize.
   ModelPass`, whose running matrix index seeds every sketch as the
   whole-model pass does, and releases the block's statistics and
   scalings.

So at most one block is in full precision at a time, and the result
equals the whole-model composition bit for bit: the same ops on the same
inputs in the same order. The JAX package has no counterpart: its CLI
runs the three whole-model steps.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.api import CalibStats, LayerReport, PTQConfig
from repro_torch.data.synthetic import DataConfig, host_batch
from repro_torch.device import resolve_device
from repro_torch.models.layers import embed, norm
from repro_torch.models.linear import Ctx
from repro_torch.models.quantize import ModelPass
from repro_torch.models.transformer import (LM, Block, Tail, assemble_lm,
                                            block_seq, check_supported,
                                            encoder_block_seq, encoder_input,
                                            init_block, init_encoder_block,
                                            init_tail, vision_prefix)


class DrawnBlocks:
    """The blocks and tail :func:`~repro_torch.models.transformer.init_lm`
    draws from ``seed``, handed out one block at a time. ``init_lm``'s one
    generator draws the decoder blocks, the encoder's, then the tail; a
    first walk draws each block and drops it at once, keeping only the
    generator's state at its start, so :meth:`block` can draw it again
    when the build asks for it."""

    def __init__(self, cfg: ModelConfig, seed: int = 0, *, device="cuda"):
        check_supported(cfg)
        self.cfg, self.dev = cfg, resolve_device(device)
        self.gen = torch.Generator(device=self.dev).manual_seed(seed)
        self._starts: Dict[str, torch.Tensor] = {}
        for i in range(cfg.n_layers):
            self._starts[f"L{i}."] = self.gen.get_state()
            init_block(self.gen, cfg, i, self.dev)
        for e in range(cfg.enc_layers if cfg.is_encoder_decoder else 0):
            self._starts[f"E{e}."] = self.gen.get_state()
            init_encoder_block(self.gen, cfg, self.dev)
        self.tail: Tail = init_tail(self.gen, cfg, self.dev)

    def block(self, i: int) -> Block:
        self.gen.set_state(self._starts[f"L{i}."])
        return init_block(self.gen, self.cfg, i, self.dev)

    def encoder_block(self, e: int) -> Block:
        self.gen.set_state(self._starts[f"E{e}."])
        return init_encoder_block(self.gen, self.cfg, self.dev)


class ModelBlocks:
    """The blocks and tail of an fp :class:`LM` built elsewhere (e.g. by
    ``convert.convert_params`` from JAX's parameters); the build
    quantizes its blocks in place."""

    def __init__(self, model: LM):
        self.cfg, self.tail, self._model = model.cfg, model, model

    def block(self, i: int) -> Block:
        return self._model.blocks[i]

    def encoder_block(self, e: int) -> Block:
        return self._model.encoder[e]


@dataclasses.dataclass
class BuildStep:
    """What a ``progress`` hook of :func:`build_quantized_lm` sees after
    each stage: ``stage`` is ``"tail"`` (tail drawn, batches embedded;
    ``layer`` ``""``), then for each layer ``"draw"``, ``"calibrate"``,
    ``"scale"`` and ``"quantize"``; ``layer`` is ``"E<e>."`` or
    ``"L<i>."``; ``blocks`` every block built so far (encoder first, the
    current one last); ``stats`` the statistics held, by tap name."""

    stage: str
    layer: str
    blocks: List[Block]
    stats: Dict[str, CalibStats]


def build_quantized_lm(source, ptq: PTQConfig, data_cfg: DataConfig,
                       n_batches: int, container: str = "int8", *,
                       progress: Optional[Callable[[BuildStep], None]] = None,
                       recorder=None, device="cuda"
                       ) -> Tuple[LM, List[LayerReport]]:
    """The quantized model of ``source`` (:class:`DrawnBlocks` or
    :class:`ModelBlocks`, on ``device``) and one report per matrix:
    calibrated on ``n_batches`` batches of ``data_cfg`` as
    ``capture_calibration`` runs them through ``lm_loss`` (Σxxᵀ
    included), quantized as ``quantize_model_params(model, ptq,
    container, stats=...)`` quantizes, a block at a time (see the module
    docstring). ``recorder`` as the whole-model pass takes it;
    ``progress`` receives a :class:`BuildStep` after each stage."""
    dev = resolve_device(device)
    cfg = source.cfg
    tail = source.tail
    if tail.embed.device.type != dev.type:
        raise ValueError(f"the source lives on {tail.embed.device}, not on "
                         f"{dev}")
    stats: Dict[str, CalibStats] = {}
    walk = ModelPass(ptq, container, stats=stats, recorder=recorder)
    built: List[Block] = []

    def step(stage: str, layer: str) -> None:
        if progress is not None:
            progress(BuildStep(stage, layer, built, stats))

    def ctx(layer: str) -> Ctx:
        # lm_loss's context for one batch, under the layer's tap prefix
        c = Ctx(tap=stats, aux_log=[])
        c.prefix = layer
        return c

    batches = [host_batch(data_cfg, s, device=dev) for s in range(n_batches)]
    with torch.no_grad():
        xs = [embed(tail.embed, b["tokens"], torch.float32) for b in batches]
        hs: List[Optional[torch.Tensor]] = [None] * n_batches
        if cfg.is_encoder_decoder:
            hs = [encoder_input(ctx(""), tail, b["frames"].to(dev))
                  for b in batches]
        step("tail", "")

        def calibrate_block(layer: str, blk: Block, run) -> None:
            built.append(blk)
            step("draw", layer)
            for b in range(n_batches):
                run(ctx(layer), b)
            step("calibrate", layer)
            for st in {id(v): v for k, v in stats.items()
                       if k.startswith(layer)}.values():
                st.scaling(ptq.scaling)
            step("scale", layer)

        for e in range(cfg.enc_layers if cfg.is_encoder_decoder else 0):
            blk = source.encoder_block(e)

            def run(c: Ctx, b: int) -> None:
                hs[b] = encoder_block_seq(c, blk, hs[b], cfg)

            calibrate_block(f"E{e}.", blk, run)
            walk.encoder_block(e, blk)
            step("quantize", f"E{e}.")
        if cfg.is_encoder_decoder:
            hs = [norm(tail.enc_norm, h, cfg.norm) for h in hs]
        if cfg.n_vision_tokens:
            xs = [vision_prefix(ctx(""), tail, x, b["vision"]) if "vision" in b
                  else x for x, b in zip(xs, batches)]
        for i in range(cfg.n_layers):
            blk = source.block(i)

            def run(c: Ctx, b: int) -> None:
                xs[b] = block_seq(c, blk, xs[b], cfg, hs[b], None, None)[0]

            calibrate_block(f"L{i}.", blk, run)
            walk.decoder_block(i, blk)
            step("quantize", f"L{i}.")
    encoder = built[:cfg.enc_layers] if cfg.is_encoder_decoder else None
    blocks = built[len(encoder or []):]
    return assemble_lm(cfg, blocks, encoder, tail), walk.reports
