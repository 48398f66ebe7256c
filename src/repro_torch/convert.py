"""Convert a JAX ``repro`` parameter tree into the port's modules.

The tree is given as nested dicts and lists of numpy arrays (for
example ``jax.tree_util.tree_map(np.asarray, params)``), so this module
needs no JAX. It handles:

  * ``embed``, ``final_norm`` and an optional ``lm_head`` (absent: tied
    to the embedding);
  * the ``prefix`` and ``suffix`` block lists and the scan-stacked
    ``groups`` dict, whose leaves carry a leading group axis
    (``repro/models/transformer.py:270-281``) — unstacked into one block
    per layer, in depth order;
  * the three linear schemas: fp ``{"w"[, "b"]}``, quant ``{"codes",
    "scale", "l", "r"[, "gscale", "b"]}`` and packed4 ``{"packed", ...}``,
    keeping MXINT padding rows (``codes`` may have more rows than ``l``);
  * a block's mixer: GQA ``{"wq", "wk", "wv", "wo"}`` (full or local
    attention), MLA ``{"w_dkv", "w_kpe", "w_uk", "w_uv", "wo",
    "ckv_norm"}`` with ``w_q`` or the q-LoRA ``w_dq``/``q_norm``/``w_uq``
    (``repro/models/attention.py::init_mla``), or RG-LRU ``{"w_gate",
    "w_branch", "w_out", "w_a", "w_x", "conv_w", "conv_b", "lam"}``
    (``repro/models/rglru.py::init_rglru``), mLSTM ``{"up", "up_gate",
    "wq", "wk", "wv", "w_if", "down"}`` or sLSTM ``{"w_gates",
    "r_gates", "w_out", "ffn_up", "ffn_down"}`` (``repro/models/
    xlstm.py``; ``r_gates`` a raw f32 tensor, kept as it is), each
    projection in any of the three schemas. A block's kind comes from the
    config's layout (``models.transformer.kind_at`` of its depth), not
    from its keys; an xLSTM block has no ``norm2`` and no FFN;
  * norms: ``{"g"}`` (RMSNorm) or ``{"g", "b"}`` (LayerNorm);
  * a block's FFN: ``mlp`` (SwiGLU, or ``up``/``down`` alone for a GELU
    config; the dense ``prefix`` lead-in layers of an MoE config carry it
    too) or ``moe`` — ``router``, ``experts`` (the three schemas with a
    leading expert axis: in ``groups`` a leaf is ``(G, E, ...)``, G is
    unstacked and E kept) and optional ``shared``;
  * an encoder-decoder's ``encoder`` subtree (``blocks`` stacked over
    ``enc_layers`` attention blocks, ``final_norm``), each decoder block's
    ``norm_x`` and ``cross`` attention, and ``frontend_proj`` where the
    tree has one (``repro/models/transformer.py:95-97, 290-302``);
  * a VLM's ``vision_proj`` (full precision, ``repro/models/
    transformer.py:303-306``).

:func:`convert_train_state` and :func:`convert_qpeft_state` carry a JAX
training state across (params, or the QPEFT trainable/frozen split, and
Adam's step and moments), so a run started in JAX continues in the port
on the same trajectory. The moments take the parameters' walk: each is
converted as a parameter tree of its own and read back by name.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.attention import MLA, Attention
from repro_torch.models.layers import MLP, LayerNorm, RMSNorm
from repro_torch.models.linear import FpLinear, QLinear
from repro_torch.models.moe import MoE
from repro_torch.models.quantize import split_qpeft
from repro_torch.models.rglru import RGLRU, RGLRU_PROJECTIONS
from repro_torch.models.transformer import LM, Block, kind_at
from repro_torch.models.xlstm import (MLSTM, MLSTM_PROJECTIONS, SLSTM,
                                      SLSTM_PROJECTIONS)
from repro_torch.optim.adamw import AdamState
from repro_torch.train.steps import QPEFTState, TrainState, trainable_params

_DTYPES = {np.dtype(np.float32), np.dtype(np.int8), np.dtype(np.uint8)}


def _tensor(a, device) -> torch.Tensor:
    arr = np.ascontiguousarray(a)
    if arr.dtype not in _DTYPES:
        raise TypeError(f"unsupported parameter dtype {arr.dtype}")
    return torch.from_numpy(arr.copy()).to(device)


def _linear(d: Dict[str, Any], device):
    b = _tensor(d["b"], device) if "b" in d else None
    if "w" in d:
        return FpLinear(_tensor(d["w"], device), b)
    store = {"codes": _tensor(d["codes"], device)} if "codes" in d \
        else {"packed": _tensor(d["packed"], device)}
    gscale = _tensor(d["gscale"], device) if "gscale" in d else None
    return QLinear(_tensor(d["scale"], device), _tensor(d["l"], device),
                   _tensor(d["r"], device), gscale=gscale, b=b, **store)


def _mlp(d: Dict[str, Any], device) -> MLP:
    return MLP(*(_linear(d[n], device) if n in d else None
                 for n in ("up", "gate", "down")))


def _ffn(d: Dict[str, Any], device):
    if "moe" not in d:
        return _mlp(d["mlp"], device)
    m = d["moe"]
    return MoE(_linear(m["router"], device), _mlp(m["experts"], device),
               _mlp(m["shared"], device) if "shared" in m else None)


def _mla(mx: Dict[str, Any], device) -> MLA:
    q = {n: _linear(mx[n], device) for n in ("w_q", "w_dq", "w_uq")
         if n in mx}
    if "q_norm" in mx:
        q["q_norm"] = RMSNorm(_tensor(mx["q_norm"]["g"], device))
    return MLA(*(_linear(mx[n], device)
                 for n in ("w_dkv", "w_kpe", "w_uk", "w_uv", "wo")),
               RMSNorm(_tensor(mx["ckv_norm"]["g"], device)), **q)


def _rglru(mx: Dict[str, Any], device) -> RGLRU:
    return RGLRU(*(_linear(mx[n], device) for n in RGLRU_PROJECTIONS),
                 *(_tensor(mx[n], device) for n in ("conv_w", "conv_b", "lam")))


def _norm(d: Dict[str, Any], device):
    g = _tensor(d["g"], device)
    return LayerNorm(g, _tensor(d["b"], device)) if "b" in d else RMSNorm(g)


def _block(d: Dict[str, Any], kind: str, device) -> Block:
    mx = d["mixer"]
    if kind == "mlstm":
        return Block(_norm(d["norm1"], device),
                     MLSTM(*(_linear(mx[n], device)
                             for n in MLSTM_PROJECTIONS)), None, None, kind)
    if kind == "slstm":
        w_gates, w_out, ffn_up, ffn_down = (_linear(mx[n], device)
                                            for n in SLSTM_PROJECTIONS)
        return Block(_norm(d["norm1"], device),
                     SLSTM(w_gates, _tensor(mx["r_gates"], device), w_out,
                           ffn_up, ffn_down), None, None, kind)
    if kind == "rglru":
        mixer = _rglru(mx, device)
    elif "w_dkv" in mx:
        mixer = _mla(mx, device)
    else:
        mixer = _attention(mx, device)
    cross = {}
    if "cross" in d:
        cross = dict(norm_x=_norm(d["norm_x"], device),
                     cross=_attention(d["cross"], device))
    return Block(_norm(d["norm1"], device), mixer, _norm(d["norm2"], device),
                 _ffn(d, device), kind, **cross)


def _attention(mx: Dict[str, Any], device) -> Attention:
    return Attention(*(_linear(mx[n], device)
                       for n in ("wq", "wk", "wv", "wo")))


def _unstack(tree: Any, i: int) -> Any:
    if isinstance(tree, dict):
        return {k: _unstack(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def _first_leaf(tree: Any):
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return np.asarray(tree)


def convert_params(tree: Dict[str, Any], cfg: ModelConfig, *,
                   device="cuda") -> LM:
    """Build the port's :class:`~repro_torch.models.transformer.LM` from a
    JAX parameter tree (numpy leaves), on ``device``."""
    dev = resolve_device(device)
    layers: List[Dict[str, Any]] = list(tree.get("prefix", []))
    groups = tree.get("groups") or {}
    period = len(cfg.block_pattern)
    if groups:
        n_groups = _first_leaf(groups["p0"]).shape[0]
        for g in range(n_groups):
            for pos in range(period):
                layers.append(_unstack(groups[f"p{pos}"], g))
    layers += list(tree.get("suffix", []))
    if len(layers) != cfg.n_layers:
        raise ValueError(f"tree holds {len(layers)} blocks, config "
                         f"{cfg.name} has {cfg.n_layers} layers")
    blocks = [_block(d, kind_at(cfg, i), dev) for i, d in enumerate(layers)]
    head = _linear(tree["lm_head"], dev) if "lm_head" in tree else None
    encoder = enc_norm = proj = None
    if "encoder" in tree:
        enc = tree["encoder"]
        encoder = [_block(_unstack(enc["blocks"], e), "attn", dev)
                   for e in range(_first_leaf(enc["blocks"]).shape[0])]
        enc_norm = _norm(enc["final_norm"], dev)
    if "frontend_proj" in tree:
        proj = _linear(tree["frontend_proj"], dev)
    vision = (_linear(tree["vision_proj"], dev) if "vision_proj" in tree
              else None)
    return LM(cfg, _tensor(tree["embed"]["w"], dev), blocks,
              _norm(tree["final_norm"], dev), head, encoder, enc_norm, proj,
              vision)


def _step_count(a, device) -> torch.Tensor:
    return torch.tensor(int(a), dtype=torch.int32, device=device)


def convert_train_state(state, cfg: ModelConfig, *,
                        device="cuda") -> TrainState:
    """The port's :class:`~repro_torch.train.TrainState` of JAX's (numpy
    leaves; ``params``, ``opt.step``/``mu``/``nu`` and ``step`` are read
    by attribute)."""
    dev = resolve_device(device)
    mu, nu = (trainable_params(convert_params(t, cfg, device=dev))
              for t in (state.opt.mu, state.opt.nu))
    return TrainState(convert_params(state.params, cfg, device=dev),
                      AdamState(_step_count(state.opt.step, dev), mu, nu),
                      _step_count(state.step, dev))


def _merge_adapters(trainable: Any, frozen: Any) -> Any:
    """JAX's ``merge_qpeft`` over numpy trees: each quantized linear of
    ``frozen`` takes the ``{"l", "r"}`` at its place in ``trainable``."""
    if isinstance(frozen, dict) and ("codes" in frozen or "packed" in frozen):
        return {**frozen, **(trainable if isinstance(trainable, dict)
                             else {})}
    if isinstance(frozen, dict):
        return {k: _merge_adapters(trainable.get(k) if isinstance(
            trainable, dict) else None, v) for k, v in frozen.items()}
    if isinstance(frozen, (list, tuple)):
        ts = trainable if isinstance(trainable, (list, tuple)) \
            else [None] * len(frozen)
        return type(frozen)(_merge_adapters(t, f) for t, f in zip(ts, frozen))
    return frozen


def convert_qpeft_state(state, cfg: ModelConfig, *,
                        device="cuda") -> QPEFTState:
    """The port's :class:`~repro_torch.train.QPEFTState` of JAX's (numpy
    leaves; ``trainable``, ``frozen``, ``opt.step``/``mu``/``nu`` and
    ``step`` read by attribute): the model converted from the merged
    tree and split again; each moment merged into the frozen tree in the
    adapters' place, converted, and its adapters read back."""
    dev = resolve_device(device)
    trainable, frozen = split_qpeft(convert_params(
        _merge_adapters(state.trainable, state.frozen), cfg, device=dev))
    mu, nu = (split_qpeft(convert_params(_merge_adapters(t, state.frozen),
                                         cfg, device=dev))[0]
              for t in (state.opt.mu, state.opt.nu))
    return QPEFTState(trainable, frozen,
                      AdamState(_step_count(state.opt.step, dev), mu, nu),
                      _step_count(state.step, dev))
