"""Per-matrix PTQ entry point (port of ``repro/core/api.py`` for the
``srr`` and ``none`` methods without calibration statistics — the JAX
package's ``stats=None`` case, where the scaling falls back to identity).
"""
from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple

import torch

from repro_torch.core.qer import Decomposition
from repro_torch.core.srr import srr_decompose
from repro_torch.quant.mxint import MXIntQuantizer


@dataclasses.dataclass(frozen=True)
class PTQConfig:
    """Knobs of the offline pass (MXINT backbone, identity scaling)."""

    method: str = "srr"             # srr | none
    rank: int = 64
    bits: int = 3
    block_size: int = 32
    exact_svd: bool = False         # randomized SVD by default (paper A.4)
    seed: int = 0
    forced_k: int | None = None     # override k* (ablations)

    def rank_for(self, shape: tuple[int, int]) -> int:
        """Effective budget for narrow matrices."""
        return max(1, min(self.rank, min(shape) // 2))

    def quantizer(self) -> MXIntQuantizer:
        return MXIntQuantizer(bits=self.bits, block_size=self.block_size)


class LayerReport(NamedTuple):
    name: str
    shape: tuple[int, int]
    rank: int
    k_star: int
    weight_err: float               # ‖W − Q − LR‖_F (= the scaled error, S = I)
    seconds: float


def quantize_layer(name: str, w: torch.Tensor, cfg: PTQConfig,
                   gen: torch.Generator) -> tuple[Decomposition, LayerReport]:
    """Apply the configured method to one weight matrix."""
    t0 = time.perf_counter()
    rank = cfg.rank_for(tuple(w.shape))
    w = w.float()
    if cfg.method == "srr":
        dec = srr_decompose(w, cfg.quantizer(), rank, gen, k=cfg.forced_k,
                            exact=cfg.exact_svd)
    elif cfg.method == "none":
        dec = Decomposition(q=w, l=torch.zeros((w.shape[0], rank),
                                               device=w.device),
                            r=torch.zeros((rank, w.shape[1]), device=w.device),
                            k=0)
    else:
        raise ValueError(f"unknown PTQ method {cfg.method!r} (the port has "
                         f"srr and none)")
    err = float(torch.linalg.norm(w - dec.reconstruct()))
    return dec, LayerReport(name=name, shape=tuple(w.shape), rank=rank,
                            k_star=dec.k, weight_err=err,
                            seconds=time.perf_counter() - t0)
