"""Per-matrix PTQ entry point and calibration moments (port of
``repro/core/api.py``).

Calibration statistics are *streaming moments* (constant memory per
projection): count, Σ|x|, Σx² and optionally Σxxᵀ — enough to build
every scaling kind without keeping activations. ``PTQConfig.quantizer``
picks the backbone quantizer by its :class:`~repro_torch.quant.
QuantizerConfig` (MXINT by default, uniform or GPTQ), built by
``make_quantizer`` as in the JAX package. Without statistics the scaling
is the identity, as with JAX's ``stats=None``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, NamedTuple, Optional

import torch
from torch.profiler import record_function

from repro_torch.core.qer import (Decomposition, qer_decompose,
                                  scaled_error, w_only, weight_error)
from repro_torch.core.scaling import (IDENTITY, Scaling,
                                      autocorr_scaling_from_moments)
from repro_torch.core.srr import srr_decompose
from repro_torch.quant import QuantizerConfig, make_quantizer

METHODS = ("srr", "srr-joint", "qer", "w-only", "none")


@dataclasses.dataclass(eq=False)
class CalibStats:
    """Streaming input statistics of one projection, in float32, updated
    in place. ``count`` is a host int (rows seen), so counting never
    waits on the device. The scalings built from the moments are kept
    until the next update: projections that read one input share one
    object (``Ctx.record``), and so one eigendecomposition."""

    count: int
    sum_abs: torch.Tensor                     # (m,)
    sum_sq: torch.Tensor                      # (m,)
    autocorr: Optional[torch.Tensor] = None   # (m, m) Σ xxᵀ
    _scalings: Dict[str, Scaling] = dataclasses.field(default_factory=dict,
                                                      repr=False)

    @staticmethod
    def init(m: int, need_autocorr: bool = True,
             device="cpu") -> "CalibStats":
        z = lambda *s: torch.zeros(s, dtype=torch.float32,  # noqa: E731
                                   device=device)
        return CalibStats(0, z(m), z(m), z(m, m) if need_autocorr else None)

    def update(self, x: torch.Tensor) -> "CalibStats":
        """Accumulate a batch of activations x (..., m)."""
        x = x.reshape(-1, x.shape[-1]).float()
        self.count += x.shape[0]
        self.sum_abs += x.abs().sum(dim=0)
        self.sum_sq += (x * x).sum(dim=0)
        if self.autocorr is not None:
            self.autocorr.addmm_(x.T, x)
        self._scalings.clear()
        return self

    def scaling(self, kind: str) -> Scaling:
        if kind == "identity":
            return IDENTITY
        if kind not in self._scalings:
            self._scalings[kind] = self._build(kind, max(self.count, 1))
        return self._scalings[kind]

    def _build(self, kind: str, n: int) -> Scaling:
        if kind == "lqer":
            return Scaling(diag=(self.sum_abs / n).clamp_min(1e-6))
        if kind == "qera-approx":
            return Scaling(diag=(self.sum_sq / n).sqrt().clamp_min(1e-6))
        if kind == "qera-exact":
            if self.autocorr is None:
                raise ValueError("qera-exact needs autocorrelation moments")
            return autocorr_scaling_from_moments(self.autocorr / n,
                                                 rows=self.count)
        raise ValueError(f"unknown scaling kind {kind!r}")


@dataclasses.dataclass(frozen=True)
class PTQConfig:
    """One knob object for the whole offline pass."""

    method: str = "srr"             # srr | srr-joint | qer | w-only | none
    scaling: str = "qera-exact"     # see repro_torch.core.scaling
    quantizer: QuantizerConfig = QuantizerConfig(kind="mxint", bits=3,
                                                 block_size=32)
    rank: int = 64
    exact_svd: bool = False         # randomized SVD by default (paper A.4)
    seed: int = 0
    forced_k: int | None = None     # override k* (ablations)

    def rank_for(self, shape: tuple[int, int]) -> int:
        """Effective budget for narrow matrices (e.g. MoE experts)."""
        return max(1, min(self.rank, min(shape) // 2))


class LayerReport(NamedTuple):
    name: str
    shape: tuple[int, int]
    rank: int
    k_star: int
    scaled_err: float               # ‖S(W − Q − LR)‖_F
    weight_err: float               # ‖W − Q − LR‖_F
    seconds: float


def quantize_layer(name: str, w: torch.Tensor, cfg: PTQConfig,
                   gen: Optional[torch.Generator],
                   stats: Optional[CalibStats] = None, recorder=None,
                   quantizer=None) -> tuple[Decomposition, LayerReport]:
    """Apply the configured method to one weight matrix, under the
    scaling ``cfg.scaling`` of ``stats`` (the identity without them),
    with ``quantizer`` or, when None, ``make_quantizer(cfg.quantizer)``
    (a GPTQ config then raises: it needs a Hessian, bound by the caller
    as ``make_quantizer(config, hessian)``).

    ``recorder`` is an optional duck-typed observer (see
    :mod:`repro_torch.obs.quant`) whose ``record_layer`` receives the
    inputs and results of the pass; this module never imports it."""
    t0 = time.perf_counter()
    with record_function("srr.scaling"):
        scaling = stats.scaling(cfg.scaling) if stats is not None \
            else IDENTITY
    if quantizer is None:
        quantizer = make_quantizer(cfg.quantizer)
    rank = cfg.rank_for(tuple(w.shape))
    w = w.float()
    if cfg.method == "w-only":
        dec = w_only(w, quantizer, rank)
    elif cfg.method == "qer":
        dec = qer_decompose(w, quantizer, rank, gen,
                            exact=cfg.exact_svd, scaling=scaling)
    elif cfg.method in ("srr", "srr-joint"):
        dec = srr_decompose(
            w, quantizer, rank, gen, k=cfg.forced_k,
            exact=cfg.exact_svd, scaling=scaling,
            variant="joint" if cfg.method == "srr-joint" else "split"
        ).decomposition
    elif cfg.method == "none":
        dec = Decomposition(q=w, l=torch.zeros((w.shape[0], rank),
                                               device=w.device),
                            r=torch.zeros((rank, w.shape[1]), device=w.device),
                            k=0)
    else:
        raise ValueError(f"unknown PTQ method {cfg.method!r}; options: "
                         f"{METHODS}")
    report = LayerReport(
        name=name, shape=tuple(w.shape), rank=rank, k_star=dec.k,
        scaled_err=float(scaled_error(w, dec, scaling)),
        weight_err=float(weight_error(w, dec)),
        seconds=time.perf_counter() - t0)
    if recorder is not None:
        recorder.record_layer(name, w, dec, scaling, cfg, quantizer, report)
    return dec, report


def quantize_tree(weights: Dict[str, torch.Tensor],
                  stats: Dict[str, CalibStats], cfg: PTQConfig,
                  progress: Optional[Callable[[LayerReport], None]] = None
                  ) -> tuple[Dict[str, Decomposition], list[LayerReport]]:
    """Quantize every named weight, in sorted order; the i-th draws from
    its own generator, seeded by ``cfg.seed`` and i."""
    decs: Dict[str, Decomposition] = {}
    reports: list[LayerReport] = []
    for i, name in enumerate(sorted(weights)):
        w = weights[name]
        gen = torch.Generator(device=w.device).manual_seed(
            cfg.seed * 1_000_003 + i)
        decs[name], rep = quantize_layer(name, w, cfg, gen, stats.get(name))
        reports.append(rep)
        if progress is not None:
            progress(rep)
    return decs, reports


def report_summary(reports: list[LayerReport]) -> Dict[str, Any]:
    if not reports:
        return {}
    n = len(reports)
    return {
        "layers": n,
        "mean_scaled_err": sum(r.scaled_err for r in reports) / n,
        "mean_weight_err": sum(r.weight_err for r in reports) / n,
        "mean_k_star": sum(r.k_star for r in reports) / n,
        "total_seconds": sum(r.seconds for r in reports),
    }
