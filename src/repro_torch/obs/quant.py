"""Quantize-time introspection: per-layer SRR quality records (port of
``repro/obs/quant.py``).

The paper's k-selection balances *preserved* subspace energy against
*quantization-exposed* energy of the activation-scaled weight ``SW``; a
:class:`QuantRecorder` records that balance matrix by matrix while a
pass runs. It is threaded — duck-typed, optional — through
:func:`repro_torch.core.api.quantize_layer` (``record_layer``) and
:func:`repro_torch.models.quantize.quantize_model_params`
(``attach_container``). Each :class:`LayerQuantRecord` holds:

* the singular-spectrum head of ``SW`` (``torch.linalg.svdvals`` on the
  weight's own device), the preserved rank ``k`` and the captured energy
  fraction ``Σσ²[:k] / Σσ²`` (its complement is the exposed energy);
* the raw and scaled residual norms ``‖W − Q − LR‖_F`` and
  ``‖S(W − Q − LR)‖_F``, absolute and relative;
* the bit and rank budgets and the serving container's bytes, split into
  quantized and low-rank storage.

The report's ``config`` names the pass's quantizer
(``PTQConfig.quantizer``: kind, bits, block size), as JAX's does.
``build_report()`` returns the JSON dict that
``tools/quant_report_schema.json`` pins; ``write(path)`` also drops a
sibling ``*.trace.json`` Chrome trace with one span per matrix.
:data:`NULL_QUANT_RECORDER` swallows every call.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List

import torch

from repro_torch.serve.telemetry import Tracer

# Chrome-trace process lane for quantizer passes (the serving Tracer
# reserves 1 for request lanes and 2 for the engine timeline)
PID_QUANT = 3

# how many leading singular values of SW each record keeps
SPECTRUM_HEAD = 8

REPORT_VERSION = 1


@dataclasses.dataclass
class LayerQuantRecord:
    """Everything the report knows about one quantized matrix."""

    name: str
    shape: List[int]                  # the weight's shape as stored
    method: str                       # srr | srr-joint | qer | w-only | none
    scaling: str                      # identity | lqer | qera-approx | ...
    rank: int                         # low-rank budget r
    k: int                            # preserved rank k* (<= rank)
    bits: float                       # effective bits/weight incl. side info
    singular_head: List[float]        # leading sigma_i of SW, descending
    preserved_energy_fraction: float  # sum sigma^2[:k] / sum sigma^2
    quant_exposed_energy_fraction: float  # 1 - preserved fraction
    scaled_err: float                 # ||S(W - Q - LR)||_F
    scaled_rel_err: float             # scaled_err / ||SW||_F
    weight_err: float                 # ||W - Q - LR||_F
    weight_rel_err: float             # weight_err / ||W||_F
    seconds: float                    # wall time of the quantizer pass
    quant_bytes: int = 0              # packed Q container (codes + scales)
    lowrank_bytes: int = 0            # L, R (+ gscale)
    total_bytes: int = 0
    container: str = ""               # serving container kind, if packed


def _nbytes(t) -> int:
    return 0 if t is None else t.numel() * t.element_size()


class QuantRecorder:
    """Accumulates :class:`LayerQuantRecord` objects during a pass; it
    derives every spectral quantity itself from ``(w, dec, scaling)``."""

    def __init__(self, spectrum_head: int = SPECTRUM_HEAD):
        self.spectrum_head = spectrum_head
        self.records: Dict[str, LayerQuantRecord] = {}
        self._config: Dict[str, Any] = {}
        self.tracer = Tracer()
        self.tracer.events.append({
            "ph": "M", "pid": PID_QUANT, "tid": 0, "ts": 0,
            "name": "process_name", "args": {"name": "quantize"}})

    def record_layer(self, name: str, w: torch.Tensor, dec, scaling, cfg,
                     quantizer, layer_report) -> None:
        """Capture one quantized matrix (called by ``quantize_layer``)."""
        if not self._config:
            self._config = {"method": cfg.method, "scaling": cfg.scaling,
                            "quantizer": cfg.quantizer.kind,
                            "bits": int(cfg.quantizer.bits),
                            "block_size": int(cfg.quantizer.block_size),
                            "rank": int(cfg.rank),
                            "exact_svd": bool(cfg.exact_svd)}
        wf = w.float()
        sigma = torch.linalg.svdvals(scaling.apply(wf)).double()
        energy = sigma ** 2
        k = int(dec.k)
        # one device → host copy: total and preserved energy, ‖W‖_F and
        # the spectrum head
        total, kept, w_norm, *head = torch.cat([
            torch.stack([energy.sum(), energy[:k].sum(),
                         torch.linalg.norm(wf).double()]),
            sigma[:self.spectrum_head]]).tolist()
        total = total or 1.0
        preserved = kept / total
        sw_norm = total ** 0.5
        w_norm = w_norm or 1.0
        self.records[name] = LayerQuantRecord(
            name=name, shape=[int(s) for s in w.shape], method=cfg.method,
            scaling=cfg.scaling, rank=int(layer_report.rank), k=k,
            bits=float(quantizer.effective_bits),
            singular_head=head,
            preserved_energy_fraction=preserved,
            quant_exposed_energy_fraction=1.0 - preserved,
            scaled_err=float(layer_report.scaled_err),
            scaled_rel_err=float(layer_report.scaled_err) / (sw_norm or 1.0),
            weight_err=float(layer_report.weight_err),
            weight_rel_err=float(layer_report.weight_err) / w_norm,
            seconds=float(layer_report.seconds))
        dur = float(layer_report.seconds) * 1e6
        self.tracer.complete(
            name, self.tracer.now_us() - dur, dur, PID_QUANT, 0,
            args={"k": k, "rank": int(layer_report.rank),
                  "scaled_err": float(layer_report.scaled_err)})

    def attach_container(self, name: str, packed: Dict[str, Any],
                         container: str) -> None:
        """Add the serving container's byte accounting to a record:
        ``packed`` is the matrix's buffers (``codes``/``packed`` +
        ``scale``; ``l``, ``r``, ``gscale``)."""
        rec = self.records.get(name)
        if rec is None:
            return
        rec.quant_bytes = sum(_nbytes(packed.get(key))
                              for key in ("codes", "packed", "scale"))
        rec.lowrank_bytes = sum(_nbytes(packed.get(key))
                                for key in ("l", "r", "gscale"))
        rec.total_bytes = rec.quant_bytes + rec.lowrank_bytes
        rec.container = container

    def build_report(self) -> Dict[str, Any]:
        recs = list(self.records.values())
        summary: Dict[str, Any] = {
            "layers": len(recs),
            "total_bytes": sum(r.total_bytes for r in recs),
            "quant_bytes": sum(r.quant_bytes for r in recs),
            "lowrank_bytes": sum(r.lowrank_bytes for r in recs),
            "total_seconds": sum(r.seconds for r in recs),
        }
        if recs:
            n = len(recs)
            summary.update(
                mean_scaled_rel_err=sum(r.scaled_rel_err for r in recs) / n,
                max_scaled_rel_err=max(r.scaled_rel_err for r in recs),
                mean_preserved_energy_fraction=sum(
                    r.preserved_energy_fraction for r in recs) / n,
                mean_k=sum(r.k for r in recs) / n,
                mean_bits=sum(r.bits for r in recs) / n)
        return {"version": REPORT_VERSION, "config": dict(self._config),
                "summary": summary,
                "layers": {r.name: dataclasses.asdict(r) for r in recs}}

    def write(self, path: str) -> str:
        """Write the JSON report; drop a sibling ``*.trace.json``."""
        with open(path, "w") as f:
            json.dump(self.build_report(), f, indent=1, sort_keys=True)
            f.write("\n")
        trace = (path[:-len(".json")] if path.endswith(".json")
                 else path) + ".trace.json"
        self.tracer.write_chrome(trace)
        return path


class NullQuantRecorder:
    """No-op stand-in so call sites never branch on configuration."""

    def record_layer(self, *a, **k) -> None:
        pass

    def attach_container(self, *a, **k) -> None:
        pass

    def build_report(self) -> Dict[str, Any]:
        return {"version": REPORT_VERSION, "config": {}, "summary":
                {"layers": 0, "total_bytes": 0, "quant_bytes": 0,
                 "lowrank_bytes": 0, "total_seconds": 0.0}, "layers": {}}


NULL_QUANT_RECORDER = NullQuantRecorder()
