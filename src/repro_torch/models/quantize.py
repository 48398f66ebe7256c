"""Model-level PTQ: replace every projection ``FpLinear`` of the blocks
with its SRR ``QLinear`` (port of ``repro/models/quantize.py``
``quantize_model_params`` for the int8 and packed4 containers).

Policy, as in the JAX package: the seven projections of each block are
quantized; the embedding, the LM head and the norms stay full precision.
Matrices are quantized one at a time on the model's device, and each
block's fp weights are released as soon as it is replaced.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import torch

from repro_torch.core.api import LayerReport, PTQConfig, quantize_layer
from repro_torch.device import resolve_device
from repro_torch.models.linear import FpLinear, QLinear
from repro_torch.models.transformer import LM
from repro_torch.quant.mxint import pack_codes_4bit

PROJECTIONS = (("mixer", ("wq", "wk", "wv", "wo")),
               ("mlp", ("up", "gate", "down")))


def fixed_gamma_scale(rank: int, k: int, gamma: float,
                      device) -> torch.Tensor:
    """QPEFT gradient scale g_i = γ for preserved ranks (i < k), else 1
    (Eq. 7) — carried as ``gscale`` like the JAX container."""
    idx = torch.arange(rank, device=device)
    return torch.where(idx < k, gamma, 1.0).float()


def quantize_linear(name: str, p: FpLinear, cfg: PTQConfig,
                    gen: torch.Generator,
                    container: str) -> Tuple[QLinear, LayerReport]:
    """SRR-decompose one projection and pack it into the Q + LR
    container (``"int8"`` codes or ``"packed4"`` nibbles)."""
    dec, rep = quantize_layer(name, p.w, cfg, gen)
    packed = cfg.quantizer().quantize(dec.q)
    store = {"codes": packed.codes}
    if container == "packed4":
        if cfg.bits > 4:
            raise ValueError("packed4 container requires bits <= 4")
        store = {"packed": pack_codes_4bit(packed.codes)}
    elif container != "int8":
        raise ValueError(f"unknown container {container!r} (int8 | packed4)")
    q = QLinear(torch.exp2(packed.exponents.float()), dec.l.float(),
                dec.r.float(), gscale=fixed_gamma_scale(dec.rank, dec.k, 0.1,
                                                        p.w.device),
                b=p.b, **store)
    return q, rep


def quantize_model_params(model: LM, cfg: PTQConfig, container: str = "int8",
                          progress: Optional[Callable[[LayerReport], None]] = None,
                          *, device="cuda") -> Tuple[LM, List[LayerReport]]:
    """Quantize ``model`` in place on ``device`` (where it must already
    live) and return it with one report per matrix. Each matrix draws its
    sketches from its own generator, seeded by ``cfg.seed`` and the
    matrix's index."""
    dev = resolve_device(device)
    if model.device.type != dev.type:
        raise ValueError(f"model lives on {model.device}, not on {dev}")
    reports: List[LayerReport] = []
    index = 0
    for i, blk in enumerate(model.blocks):
        for part, names in PROJECTIONS:
            owner = getattr(blk, part)
            for n in names:
                index += 1
                gen = torch.Generator(device=model.device).manual_seed(
                    cfg.seed * 1_000_003 + index)
                q, rep = quantize_linear(f"blocks.{i}.{part}.{n}",
                                         getattr(owner, n), cfg, gen,
                                         container)
                setattr(owner, n, q)
                reports.append(rep)
                if progress is not None:
                    progress(rep)
    return model, reports
