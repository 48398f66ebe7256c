"""Roofline analysis of a counted step (port of ``repro/launch/roofline.py``).

Per (arch × shape × mesh) cell, three terms in seconds:

    compute    = FLOPs            / peak_FLOP/s          (per chip)
    memory     = bytes accessed   / HBM_bw               (per chip)
    collective = collective bytes / link_bw              (per chip)

The numerators come from :func:`repro_torch.launch.cost.count`, which
runs the step once on one device: :func:`analyze` divides its totals by
the chip count (an *ideal* partition, since the port has no SPMD
partitioner to say how the work splits), and takes its collective bytes
as they are (all-reduce counted 2×: ring = reduce-scatter + all-gather).

Hardware model: the H100 SXM data sheet (dense peaks). ``PEAK_FLOPS``
is the bf16 tensor-core peak; ``PEAK_FLOPS_BY_DTYPE`` also holds the f32
figure outside the tensor cores, which the kernel bounds of
``chip_smoke.py`` use for f32 work. ``LINK_BW`` is one NVLink 4
direction, where the JAX package has ``ICI_BW``.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Optional

# --- H100 SXM hardware model ------------------------------------------------
PEAK_FLOPS = 989e12          # bf16 FLOP/s per chip (tensor cores, dense)
PEAK_FLOPS_BY_DTYPE = {"float32": 67e12, "bfloat16": PEAK_FLOPS}
HBM_BW = 3.35e12             # bytes/s per chip
LINK_BW = 450e9              # bytes/s per chip, one NVLink 4 direction
HBM_PER_CHIP = 80e9          # bytes


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    kind: str
    chips: int
    flops: float               # per-chip FLOPs
    hbm_bytes: float           # per-chip bytes accessed
    coll_bytes: float          # per-chip effective collective bytes
    coll_detail: Dict[str, Any]
    model_flops: float         # 6·N·D (train) or 2·N_active·tokens (decode)
    peak_mem_bytes: Optional[float] = None

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flops_frac(self) -> float:
        """MODEL_FLOPS / (chips × FLOPs) — remat/redundancy waste."""
        denom = self.chips * self.flops
        return self.model_flops / denom if denom else 0.0

    @property
    def roofline_frac(self) -> float:
        """Useful-FLOPs time over the bound step time (≈ achievable MFU)."""
        bound = max(self.t_compute, self.t_memory, self.t_collective)
        if bound <= 0:
            return 0.0
        t_useful = self.model_flops / (self.chips * PEAK_FLOPS)
        return t_useful / bound

    def to_dict(self) -> Dict[str, Any]:
        return {
            **{f.name: getattr(self, f.name)
               for f in dataclasses.fields(self) if f.name != "coll_detail"},
            "coll_detail": self.coll_detail,
            "t_compute": self.t_compute,
            "t_memory": self.t_memory,
            "t_collective": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flops_frac": self.useful_flops_frac,
            "roofline_frac": self.roofline_frac,
        }


def model_flops_for(cfg, shape) -> float:
    """Useful-work FLOPs for one step of this cell."""
    n_active = cfg.n_active_params()
    tokens = shape.global_batch * shape.seq_len
    if shape.kind == "train":
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        return 2.0 * n_active * tokens
    # decode: one token per sequence + attention reads over the cache
    return 2.0 * n_active * shape.global_batch


def analyze(cost: Dict[str, Any], cfg, shape, mesh_name: str, chips: int,
            arch: str, peak_mem_bytes: Optional[float] = None) -> Roofline:
    """The cell's :class:`Roofline` from ``cost`` (a
    :func:`repro_torch.launch.cost.count` dict of the whole step on one
    device): flops and bytes divided evenly over ``chips``, collective
    bytes as counted."""
    coll = {"bytes_by_kind": cost["coll_by_kind"],
            "effective_bytes": cost["collective_bytes"],
            "partition": "ideal"}
    return Roofline(
        arch=arch, shape=shape.name, mesh=mesh_name, kind=shape.kind,
        chips=chips, flops=float(cost["flops"]) / chips,
        hbm_bytes=float(cost["bytes"]) / chips,
        coll_bytes=float(cost["collective_bytes"]), coll_detail=coll,
        model_flops=model_flops_for(cfg, shape), peak_mem_bytes=peak_mem_bytes)


def save(r: Roofline, path: str) -> None:
    with open(path, "w") as f:
        json.dump(r.to_dict(), f, indent=1)
