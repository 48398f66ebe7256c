"""Calibration capture: run the model, harvest per-projection input
moments for the scaling matrices (port of ``repro/data/calibration.py``;
paper §2, App. A.2).

With ``Ctx.tap`` set, every full-precision projection records streaming
:class:`~repro_torch.core.api.CalibStats` (count, Σ|x|, Σx², Σxxᵀ) under
its tap name, ``L<i>.attn.wq`` … ``L<i>..down`` (the JAX package's
names). The moments suffice for every scaling kind without keeping
activations.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from repro_torch.core.api import CalibStats
from repro_torch.data.synthetic import DataConfig, host_batch
from repro_torch.device import resolve_device
from repro_torch.models.linear import Ctx


def capture_calibration(model, data_cfg: DataConfig,
                        forward_fn: Callable, n_batches: int = 4,
                        need_autocorr: bool = True, *,
                        device="cuda") -> Dict[str, CalibStats]:
    """Run ``n_batches`` calibration batches through
    ``forward_fn(ctx, model, batch)`` (typically
    :func:`~repro_torch.models.transformer.lm_loss`) on ``device``, where
    the model must already live; returns the stats by tap name.
    Projections fed one input tensor share one stats object."""
    dev = resolve_device(device)
    if model.device.type != dev.type:
        raise ValueError(f"model lives on {model.device}, not on {dev}")
    tap: Dict[str, CalibStats] = {}
    ctx = Ctx(tap=tap, autocorr=need_autocorr)
    with torch.no_grad():
        for step in range(n_batches):
            forward_fn(ctx, model, host_batch(data_cfg, step, device=dev))
    return tap


def calibration_summary(stats: Dict[str, CalibStats]) -> Dict[str, dict]:
    return {name: {"count": float(s.count),
                   "mean_abs": float((s.sum_abs / s.count).mean()),
                   "rms": float((s.sum_sq / s.count).sqrt().mean()),
                   "has_autocorr": s.autocorr is not None}
            for name, s in stats.items()}
