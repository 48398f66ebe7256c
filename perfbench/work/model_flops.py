"""Model FLOPs of a decoder (dense or MoE, GQA attention) by the frozen
formulas: the numerator of an MFU.

Useful work only: the tokens of the requests and the keys each token
attends, never a padded row or an idle decode lane. Each quantized
projection counts its Q + LR product (``qlr_work``'s FLOPs a row), an MoE
layer its router, shared experts and ``top_k`` routed experts a token;
the LM head is a plain f32 matmul.
"""
from __future__ import annotations

from typing import Dict

from perfbench.work import formulas


def _qlr_row(k: int, n: int, rank: int) -> float:
    return formulas.qlr_work(1, k, n, rank).flops


def token_flops(model: Dict, rank: int) -> float:
    """FLOPs of one token through every projection and the head, without
    attention's score and value products (``attention_flops``)."""
    d, hd = model["d_model"], model["head_dim"]
    qd, kvd = model["n_heads"] * hd, model["n_kv_heads"] * hd
    attn = (_qlr_row(d, qd, rank) + 2 * _qlr_row(d, kvd, rank)
            + _qlr_row(qd, d, rank))
    total = 0.0
    for i in range(model["n_layers"]):
        total += attn
        if model.get("moe") and i >= model.get("first_dense", 0):
            de = model["d_expert"]
            ds = model["n_shared"] * de
            total += _qlr_row(d, model["n_routed"], rank)
            if ds:
                total += 2 * _qlr_row(d, ds, rank) + _qlr_row(ds, d, rank)
            total += model["top_k"] * (2 * _qlr_row(d, de, rank)
                                       + _qlr_row(de, d, rank))
        else:
            ff = model["d_ff"]
            total += 2 * _qlr_row(d, ff, rank) + _qlr_row(ff, d, rank)
    return total + 2.0 * d * model["vocab"]


def attention_flops(model: Dict, keys: float) -> float:
    """Score and value products of ``keys`` (query, key) pairs summed over
    the tokens, in every layer: 2·2·hd FLOPs a pair and query head."""
    return 4.0 * model["n_heads"] * model["head_dim"] * keys * model["n_layers"]


def prompt_flops(model: Dict, rank: int, length: int) -> float:
    """A prompt of ``length`` tokens prefilled causally, the LM head on its
    last position only."""
    head = 2.0 * model["d_model"] * model["vocab"]
    keys = formulas.attention_pairs(length, length)
    return (length * (token_flops(model, rank) - head) + head
            + attention_flops(model, keys))
