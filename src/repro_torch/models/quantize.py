"""Model-level PTQ: replace every projection ``FpLinear`` of the blocks
with its Q + LR ``QLinear`` (port of ``repro/models/quantize.py``
``quantize_model_params`` for the int8 and packed4 containers), by the
method and scaling of a :class:`~repro_torch.core.api.PTQConfig`.

Policy, as in the JAX package: every projection of each block is
quantized — the attention projections (GQA's four, or MLA's six:
``w_q`` or ``w_dq``/``w_uq``, ``w_dkv``, ``w_kpe``, ``w_uk``, ``w_uv``,
``wo``), an RG-LRU mixer's five (``w_gate``, ``w_branch``, ``w_out``,
``w_a``, ``w_x``, biases kept; its ``conv_w``, ``conv_b`` and ``lam``
stay full precision, as JAX's walk leaves them), an mLSTM mixer's seven
(``up``, ``up_gate``, ``wq``, ``wk``, ``wv``, ``w_if``, ``down``) and an
sLSTM mixer's four (``w_gates``, ``w_out``, ``ffn_up``, ``ffn_down``;
``r_gates`` stays full precision: a raw tensor, as JAX's walk leaves
it), the SwiGLU three or,
in an MoE block, the router, the
shared experts' three and every (expert, projection) matrix of the
routed stacks, each with its own k* and its own generator, stacked back
into the expert container; an encoder-decoder's encoder blocks (their
four attention projections and the GELU MLP's ``up``/``down``) first,
then each decoder block's self attention, its ``cross`` attention's four
and its ``up``/``down``; the embedding, the LM head, ``frontend_proj``,
``vision_proj`` (JAX's ``EXCLUDE_NAMES``; served by a plain matmul, as
JAX computes it outside any kernel) and the norms stay full precision.
Matrices are quantized one at a time on the model's device, and each
projection's fp weights (a whole expert stack at once) are released as
soon as it is replaced, so the model's footprint only shrinks during the
pass. :class:`ModelPass` carries the pass from block to block, so
``models.build`` can quantize each block as soon as it is drawn and
calibrated, with no whole f32 model before it.

Calibration statistics (``data.calibration``) are looked up by each
matrix's own layer: ``L<i>.attn.wq`` … ``L<i>..down``, ``L<i>.attn.w_dkv``
…, ``L<i>.rglru.w_gate`` …, ``L<i>.mlstm.wq`` …, ``L<i>.slstm.w_gates``
…, ``L<i>.moe.router``, ``L<i>.moe.shared.up`` …, ``L<i>.xattn.wq`` …
and, in the encoder, ``E<e>.attn.wq`` … ``E<e>..down``. The JAX pass
looks them up with an empty layer hint, so every scanned layer there
takes the first recorded layer's statistics (ROADMAP §3; its MLA, RG-LRU
and xLSTM names, absent from its role table, fall to the first
``L<i>.attn.<name>`` / ``L<i>.rglru.<name>`` / ``L<i>.mlstm.<name>`` /
``L<i>.slstm.<name>`` by its suffix match; a VLM's calibration records
``vision_proj``'s input under the bare name ``""``, which no matrix
reads, as in JAX; an encoder-decoder's
calibration records the encoder first, so every whisper projection there,
the decoder's self and cross attention and its MLP included, takes
``E0.``'s); here each layer takes its own. An xLSTM block has no FFN to
quantize. Routed experts record no tap (their input is the dispatch
buffer), so they take the identity scaling, as in JAX.

The QPEFT half (:func:`split_qpeft`, :func:`merge_qpeft`,
:func:`qpeft_grad_scales`, :func:`set_qpeft_scaling`) splits a quantized
model into its trainable adapters and the frozen rest, for
``train.steps.make_qpeft_step``.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.core.api import (CalibStats, LayerReport, PTQConfig,
                                  quantize_layer)
from repro_torch.core.qpeft import fixed_gamma_scale
from repro_torch.device import resolve_device
from repro_torch.models.attention import MLA, MLA_PROJECTIONS
from repro_torch.models.linear import QLinear
from repro_torch.models.moe import MoE
from repro_torch.models.rglru import RGLRU, RGLRU_PROJECTIONS
from repro_torch.models.transformer import LM
from repro_torch.models.xlstm import (MLSTM, MLSTM_PROJECTIONS, SLSTM,
                                      SLSTM_PROJECTIONS)
from repro_torch.quant.mxint import MXIntQuantizer, pack_codes_4bit

ATTENTION = ("wq", "wk", "wv", "wo")
SWIGLU = ("up", "gate", "down")
GELU = ("up", "down")


def _quantize_matrix(name: str, w: torch.Tensor, cfg: PTQConfig,
                     gen: torch.Generator, container: str,
                     stats: Optional[CalibStats] = None, recorder=None
                     ) -> Tuple[dict, LayerReport]:
    """Decompose one (m, n) matrix into the Q + LR container's buffers
    (``"int8"`` codes or ``"packed4"`` nibbles)."""
    dec, rep = quantize_layer(name, w, cfg, gen, stats, recorder=recorder)
    # the container is MXINT at the config's bits and block size whatever
    # its kind, as JAX's pass packs it (a uniform Q is requantized)
    q = cfg.quantizer
    packed = MXIntQuantizer(bits=q.bits, block_size=q.block_size).quantize(
        dec.q)
    store = {"codes": packed.codes}
    if container == "packed4":
        if q.bits > 4:
            raise ValueError("packed4 container requires bits <= 4")
        store = {"packed": pack_codes_4bit(packed.codes)}
    elif container != "int8":
        raise ValueError(f"unknown container {container!r} (int8 | packed4)")
    out = dict(scale=torch.exp2(packed.exponents.float()), l=dec.l.float(),
               r=dec.r.float(),
               gscale=fixed_gamma_scale(dec.rank, dec.k, 0.1, w.device),
               **store)
    if recorder is not None:
        recorder.attach_container(name, out, container)
    return out, rep


class ModelPass:
    """The state of one model-level pass across its blocks: the running
    matrix index that seeds each matrix's generator, the reports, and the
    calibration statistics by tap name, each layer's deleted once its
    matrices are replaced. :func:`quantize_model_params` walks a whole
    model through it; ``models.build`` hands it one block at a time, in
    the same order (encoder blocks first), so both draw the same
    sketches."""

    def __init__(self, cfg: PTQConfig, container: str = "int8",
                 progress: Optional[Callable[[LayerReport], None]] = None,
                 stats: Optional[Dict[str, CalibStats]] = None,
                 recorder=None):
        self.cfg, self.container, self.progress = cfg, container, progress
        self.stats, self.recorder = stats, recorder
        self.reports: List[LayerReport] = []
        self.index = 0

    def _one(self, name: str, w: torch.Tensor, key: Optional[str]) -> dict:
        self.index += 1
        gen = torch.Generator(device=w.device).manual_seed(
            self.cfg.seed * 1_000_003 + self.index)
        st = None
        if self.stats is not None and key is not None:
            if key not in self.stats:
                raise KeyError(f"no calibration statistics for {key} "
                               f"(quantize_model_params deletes each "
                               f"layer's entries; pass a copy to reuse them)")
            st = self.stats[key]
        bufs, rep = _quantize_matrix(name, w, self.cfg, gen, self.container,
                                     st, recorder=self.recorder)
        self.reports.append(rep)
        if self.progress is not None:
            self.progress(rep)
        return bufs

    def _projections(self, owner, prefix: str, names, tap: str) -> None:
        for n in names:
            p = getattr(owner, n)
            setattr(owner, n, QLinear(b=p.b, **self._one(f"{prefix}.{n}",
                                                         p.w, f"{tap}{n}")))

    def _stacks(self, owner, prefix: str) -> None:
        # one matrix per expert, stacked back along the expert axis; the
        # fp stack goes once the module is replaced
        for n in SWIGLU:
            p = getattr(owner, n)
            per = [self._one(f"{prefix}.{n}[{e}]", p.w[e], None)
                   for e in range(p.w.shape[0])]
            stacked = {key: torch.stack([q[key] for q in per])
                       for key in per[0]}
            setattr(owner, n, QLinear(b=p.b, **stacked))

    def _release(self, layer: str) -> None:
        if self.stats is not None:
            for key in [k for k in self.stats if k.startswith(layer)]:
                del self.stats[key]

    def encoder_block(self, e: int, blk) -> None:
        """Quantize encoder block ``e`` in place under ``E<e>.``'s
        statistics, then release them."""
        layer = f"E{e}."
        self._projections(blk.mixer, f"encoder.{e}.mixer", ATTENTION,
                          layer + "attn.")
        self._projections(blk.mlp, f"encoder.{e}.mlp", GELU, layer + ".")
        self._release(layer)

    def decoder_block(self, i: int, blk) -> None:
        """Quantize decoder block ``i`` in place under ``L<i>.``'s
        statistics, then release them."""
        layer = f"L{i}."
        if isinstance(blk.mixer, RGLRU):
            self._projections(blk.mixer, f"blocks.{i}.mixer",
                              RGLRU_PROJECTIONS, layer + "rglru.")
        elif isinstance(blk.mixer, (MLSTM, SLSTM)):
            self._projections(blk.mixer, f"blocks.{i}.mixer",
                              MLSTM_PROJECTIONS if blk.kind == "mlstm"
                              else SLSTM_PROJECTIONS, f"{layer}{blk.kind}.")
        else:
            mixer = ([n for n in MLA_PROJECTIONS
                      if getattr(blk.mixer, n) is not None]
                     if isinstance(blk.mixer, MLA) else ATTENTION)
            self._projections(blk.mixer, f"blocks.{i}.mixer", mixer,
                              layer + "attn.")
        if blk.cross is not None:
            self._projections(blk.cross, f"blocks.{i}.cross", ATTENTION,
                              layer + "xattn.")
        if isinstance(blk.mlp, MoE):
            pre = f"blocks.{i}.mlp"
            self._projections(blk.mlp, pre, ("router",), layer + "moe.")
            if blk.mlp.shared is not None:
                self._projections(blk.mlp.shared, f"{pre}.shared", SWIGLU,
                                  layer + "moe.shared.")
            self._stacks(blk.mlp.experts, f"{pre}.experts")
        elif blk.mlp is not None:
            self._projections(blk.mlp, f"blocks.{i}.mlp",
                              SWIGLU if blk.mlp.gate is not None else GELU,
                              layer + ".")
        self._release(layer)


def quantize_model_params(model: LM, cfg: PTQConfig, container: str = "int8",
                          progress: Optional[Callable[[LayerReport], None]] = None,
                          *, stats: Optional[Dict[str, CalibStats]] = None,
                          recorder=None, device="cuda"
                          ) -> Tuple[LM, List[LayerReport]]:
    """Quantize ``model`` in place on ``device`` (where it must already
    live) and return it with one report per matrix. Each matrix draws its
    sketches from its own generator, seeded by ``cfg.seed`` and the
    matrix's index. With ``stats`` every matrix but the routed experts'
    is quantized under ``cfg.scaling`` of its layer's statistics, and
    each layer's entries are deleted from ``stats`` once its matrices are
    replaced (a full-width model's Σxxᵀ run to GBs): pass a copy to keep
    them. ``recorder`` (duck-typed, see :mod:`repro_torch.obs.quant`)
    captures a quality record and the container's bytes per matrix.
    ``models.build`` runs the same pass a block at a time while it draws
    and calibrates the model, so the whole f32 model never exists."""
    dev = resolve_device(device)
    if model.device.type != dev.type:
        raise ValueError(f"model lives on {model.device}, not on {dev}")
    walk = ModelPass(cfg, container, progress, stats, recorder)
    for e, blk in enumerate(model.encoder or []):
        walk.encoder_block(e, blk)
    for i, blk in enumerate(model.blocks):
        walk.decoder_block(i, blk)
    return model, walk.reports


# ==========================================================================
# QPEFT split / merge (repro/models/quantize.py:217-313)
# ==========================================================================
def qlinears(model: LM) -> List[Tuple[str, QLinear]]:
    """Every Q + LR projection of ``model`` (an expert stack is one), by
    its module path, in module order."""
    return [(path, m) for path, m in model.named_modules()
            if isinstance(m, QLinear)]


def split_qpeft(model: LM) -> Tuple[Dict[str, Dict[str, torch.Tensor]], LM]:
    """(trainable, frozen): the adapters ``{path: {"l", "r"}}`` train; the
    model is the frozen part. The trainable tensors are the model's own
    ``l``/``r`` buffers (no copy), so an update to them is the model's;
    everything else in the model (codes, packed, scale, gscale, biases,
    norms, embedding, LM head) stays as it is."""
    return {path: {"l": m.l, "r": m.r} for path, m in qlinears(model)}, model


def merge_qpeft(trainable: Dict[str, Dict[str, torch.Tensor]],
                frozen: LM) -> LM:
    """Inverse of :func:`split_qpeft`: bind each ``{"l", "r"}`` of
    ``trainable`` into the projection at its path, and return the model
    (the module layout the engine and the converter see is unchanged)."""
    for path, t in trainable.items():
        m = frozen.get_submodule(path)
        if not isinstance(m, QLinear):
            raise TypeError(f"{path} is a {type(m).__name__}, not a QLinear")
        m.l, m.r = t["l"], t["r"]
    return frozen


def qpeft_grad_scales(trainable: Dict[str, Dict[str, torch.Tensor]],
                      frozen: LM) -> Dict[str, Dict[str, torch.Tensor]]:
    """Per-rank gradient-scale tree aligned with the trainable tree."""
    return {path: {"gscale": frozen.get_submodule(path).gscale}
            for path in trainable}


def set_qpeft_scaling(model: LM, mode: str = "gamma", gamma: float = 0.1,
                      alpha: float = 5.0) -> LM:
    """Rebuild every ``gscale`` vector of a quantized model (γ, SGP or
    ``none``), in place; returns the model. Vectorised over a leading
    expert axis: the preserved-rank mask is recovered from the existing
    ``gscale`` (< 1 ⇔ preserved), so each stacked matrix keeps its own
    k*. SGP reads σ_i as the norms of R's rows (R = ΣVᵀ)."""
    for _, m in qlinears(model):
        preserved = m.gscale < 1.0
        if mode == "gamma":
            g = torch.where(preserved, gamma, 1.0)
        elif mode == "sgp":
            sigma = torch.linalg.norm(m.r, dim=-1)
            s_pres = torch.where(preserved, sigma, 0.0)
            sigma1 = torch.clamp(torch.amax(s_pres, dim=-1, keepdim=True),
                                 min=1e-12)
            lam = torch.clamp((alpha + 1.0) * sigma
                              / (alpha * sigma + sigma1), 0.0, 1.0)
            g = torch.where(preserved, 1.0 - lam, 1.0)
        elif mode == "none":
            g = torch.ones_like(m.gscale)
        else:
            raise ValueError(mode)
        m.gscale = g.float()
    return model
