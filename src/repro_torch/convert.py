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
    tree has one (``repro/models/transformer.py:95-97, 290-302``).
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
from repro_torch.models.rglru import RGLRU, RGLRU_PROJECTIONS
from repro_torch.models.transformer import LM, Block, kind_at
from repro_torch.models.xlstm import (MLSTM, MLSTM_PROJECTIONS, SLSTM,
                                      SLSTM_PROJECTIONS)

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
    return LM(cfg, _tensor(tree["embed"]["w"], dev), blocks,
              _norm(tree["final_norm"], dev), head, encoder, enc_norm, proj)
