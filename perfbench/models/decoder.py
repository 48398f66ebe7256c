"""A GQA decoder, dense or MoE, served as Q + LR: raw tensors from the seed
and the port's ``LM`` on them.

The raw tensors are what the port serves, drawn directly in that form:
3-bit MXINT codes in the int8 container, f32 power-of-two block scales,
the rank-r f32 ``L``/``R``, f32 norm gains, the f32 embedding and LM
head. Codes do not change serving speed, so no offline pass runs here.
The same tensors are handed to the port (``build``) and, after the
window, to the plain reference (``perfbench/reference/decoder.py``),
which reads them and nothing the port derived from them.

Drawing takes a few large calls on the card: one ``randint`` per GiB of
codes, one for every block exponent, one ``randn`` for every ``L``/``R``
entry and one for the norms; each matrix is a contiguous view of those
buffers.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple

import torch

CHUNK = 1 << 30          # elements a draw call at most


@dataclasses.dataclass
class Matrix:
    """One Q + LR projection (or an expert stack, with a leading axis)."""
    codes: torch.Tensor       # int8 (…, m, n)
    scale: torch.Tensor       # f32 (…, m/32, n), powers of two
    l: torch.Tensor           # f32 (…, m, r)
    r: torch.Tensor           # f32 (…, r, n)


def layout(model: Dict) -> List[Tuple[str, int, int, int, float]]:
    """(name, experts, m, n, weight std) of every quantized matrix, in
    order; experts is 0 for a plain projection."""
    d, hd, nl = model["d_model"], model["head_dim"], model["n_layers"]
    qd, kvd = model["n_heads"] * hd, model["n_kv_heads"] * hd
    out = []
    for i in range(nl):
        p = f"L{i}."
        out += [(p + "wq", 0, d, qd, d ** -0.5), (p + "wk", 0, d, kvd, d ** -0.5),
                (p + "wv", 0, d, kvd, d ** -0.5), (p + "wo", 0, qd, d, qd ** -0.5)]
        if model.get("moe") and i >= model.get("first_dense", 0):
            e, de = model["n_routed"], model["d_expert"]
            out.append((p + "router", 0, d, e, d ** -0.5))
            ds = model["n_shared"] * de
            if ds:
                out += [(p + "shared.up", 0, d, ds, d ** -0.5),
                        (p + "shared.gate", 0, d, ds, d ** -0.5),
                        (p + "shared.down", 0, ds, d, ds ** -0.5)]
            out += [(p + "experts.up", e, d, de, d ** -0.5),
                    (p + "experts.gate", e, d, de, d ** -0.5),
                    (p + "experts.down", e, de, d, de ** -0.5)]
        else:
            ff = model["d_ff"]
            out += [(p + "up", 0, d, ff, d ** -0.5), (p + "gate", 0, d, ff, d ** -0.5),
                    (p + "down", 0, ff, d, ff ** -0.5)]
    return out


def _randint(gen, n: int, lo: int, hi: int, device) -> torch.Tensor:
    out = torch.empty((n,), dtype=torch.int8, device=device)
    for s in range(0, n, CHUNK):
        out[s:s + CHUNK].random_(lo, hi, generator=gen)
    return out


def draw(config: Dict, seed: int, device) -> Dict:
    """Every raw tensor of the model from ``seed``: ``{"mats": {name:
    Matrix}, "norms": {name: (d,)}, "embed": (V, d), "head": (d, V)}``.
    Each matrix's effective weight has about the std of the JAX package's
    init for its input width; ``L·R`` adds about 0.3 of it."""
    model, q = config["model"], config["quant"]
    bits, block, rank = q["bits"], q["block"], q["rank"]
    qmin, qmax = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
    code_std = math.sqrt(((qmax - qmin + 1) ** 2 - 1) / 12.0)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    mats = layout(model)
    sizes = [(max(e, 1), m, n) for _, e, m, n, _ in mats]
    n_codes = sum(a * m * n for a, m, n in sizes)
    n_scale = sum(a * (m // block) * n for a, m, n in sizes)
    n_lr = sum(a * (m + n) * rank for a, m, n in sizes)
    codes = _randint(gen, n_codes, qmin, qmax + 1, device)
    expo = _randint(gen, n_scale, -1, 2, device)
    lr = torch.randn((n_lr,), generator=gen, device=device)
    d, v = model["d_model"], model["vocab"]
    n_norms = 2 * model["n_layers"] + 1
    norms = 1.0 + 0.05 * torch.randn((n_norms, d), generator=gen, device=device)
    embed = torch.randn((v, d), generator=gen, device=device)
    head = torch.randn((d, v), generator=gen, device=device).mul_(d ** -0.5)
    out: Dict[str, Matrix] = {}
    oc = os_ = olr = 0
    for (name, e, m, n, std), (a, _, _) in zip(mats, sizes):
        base = round(math.log2(std / code_std))
        lead = (e,) if e else ()
        c = codes[oc:oc + a * m * n].view(*lead, m, n)
        sc = torch.exp2(expo[os_:os_ + a * (m // block) * n].float() + base) \
            .view(*lead, m // block, n)
        l_ = lr[olr:olr + a * m * rank].view(*lead, m, rank).mul_(rank ** -0.5)
        olr += a * m * rank
        r_ = lr[olr:olr + a * rank * n].view(*lead, rank, n).mul_(0.3 * std)
        olr += a * rank * n
        oc += a * m * n
        os_ += a * (m // block) * n
        out[name] = Matrix(c, sc, l_, r_)
    names = [f"L{i}.{k}" for i in range(model["n_layers"])
             for k in ("norm1", "norm2")] + ["final_norm"]
    return {"mats": out, "norms": dict(zip(names, norms)), "embed": embed,
            "head": head}


def model_config(config: Dict):
    """The port's ``ModelConfig`` of the file's ``model`` section."""
    from repro_torch.configs.base import ModelConfig
    return ModelConfig(**config["model"])


def build(raw: Dict, config: Dict):
    """The port's ``LM`` over the raw tensors (views, no copies): every
    projection a ``QLinear``, an MoE layer's router, shared experts and
    routed stacks too; the embedding and the head full precision."""
    from repro_torch.models.attention import Attention
    from repro_torch.models.layers import MLP, RMSNorm
    from repro_torch.models.linear import FpLinear, QLinear
    from repro_torch.models.moe import MoE
    from repro_torch.models.transformer import LM, Block

    cfg = model_config(config)
    mats, norms = raw["mats"], raw["norms"]

    def q(name: str) -> QLinear:
        mt = mats[name]
        return QLinear(mt.scale, mt.l, mt.r, codes=mt.codes)

    blocks = []
    for i in range(cfg.n_layers):
        p = f"L{i}."
        mixer = Attention(q(p + "wq"), q(p + "wk"), q(p + "wv"), q(p + "wo"))
        if cfg.uses_moe_at(i):
            shared = (MLP(q(p + "shared.up"), q(p + "shared.gate"),
                          q(p + "shared.down")) if cfg.n_shared else None)
            ffn = MoE(q(p + "router"),
                      MLP(q(p + "experts.up"), q(p + "experts.gate"),
                          q(p + "experts.down")), shared)
        else:
            ffn = MLP(q(p + "up"), q(p + "gate"), q(p + "down"))
        blocks.append(Block(RMSNorm(norms[p + "norm1"]), mixer,
                            RMSNorm(norms[p + "norm2"]), ffn, "attn"))
    return LM(cfg, raw["embed"], blocks, RMSNorm(norms["final_norm"]),
              FpLinear(raw["head"]))
