"""One run of one cell, from set-up to the result line.

``execute`` resolves the cell, lets its traffic generator set up and
measure the window, reads the end-to-end metrics (``--trace 0``) or the
per-layer ones (``--trace 1``), reads the card's memory peak, frees the
program's state, has the reference judge what the window produced, and
assembles the line. It decides nothing about the card: ``run.py`` looks
for one first, and the tests drive ``execute`` on the CPU at a tiny size.
"""
from __future__ import annotations

import re
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from perfbench import checks, registry

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
_PCTL = re.compile(r"^(?P<what>.+)_p(?P<q>\d+(?:\.\d+)?)_(?P<unit>[a-z]+)$")


def forbidden_modules(names=None) -> List[str]:
    """Of ``names`` (default: the loaded modules), the top-level names
    that are JAX's, jaxlib's, flax's or the JAX package's, compared whole:
    ``repro_torch`` is not ``repro``."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names
                   if m.split(".")[0] in FORBIDDEN})


def end_to_end(name: str, outcome) -> float:
    """A named end-to-end metric: read as the generator gives it, or, for
    ``<x>_p<q>_<unit>``, the q-th percentile of its ``<x>_<unit>``
    samples."""
    if name in outcome.end_to_end:
        return float(outcome.end_to_end[name])
    m = _PCTL.match(name)
    samples = outcome.samples.get(f"{m['what']}_{m['unit']}") if m else None
    if not samples:
        raise KeyError(f"the run gives no end-to-end metric {name!r}")
    return float(np.percentile(samples, float(m["q"])))


def power_limit() -> Optional[str]:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        and out.stdout.strip() else None


def execute(bench_json: Dict[str, Any], cell_name: str, seed: int,
            seconds: float, trace: bool, device, t_start: float,
            base: Path = registry.HERE, log=None) -> Dict[str, Any]:
    """Run the cell and return the result line's object; its traffic and
    limits files are under ``base``; ``log`` takes a line on the window."""
    bench = registry.resolve(cell_name, seed, seconds, trace, device,
                             bench_json, base)
    w = registry.cell(bench_json, cell_name)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    outcome = registry.generator(bench.traffic).run(bench)
    if trace:
        outcome.session.read_trace()
    if log is not None:
        log(outcome.session.describe())
    unit = {m["name"]: m["unit"] for m in
            bench_json["end_to_end"] + bench_json["per_layer"]}
    metrics: Dict[str, Dict[str, Any]] = {}
    if not trace:
        for m in registry.metrics_of(bench_json, cell_name, "end_to_end"):
            v = (outcome.setup_end - t_start if m["name"] == "setup_s"
                 else end_to_end(m["name"], outcome))
            metrics[m["name"]] = {"value": v, "unit": unit[m["name"]]}
    else:
        for m in registry.metrics_of(bench_json, cell_name, "per_layer"):
            v = registry.metric_reader(m["name"]).read(outcome.session)
            if v is not None:
                metrics[m["name"]] = {"value": float(v),
                                      "unit": unit[m["name"]]}
    dev: Dict[str, Any] = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
        "count": w["chips"],
        "memory_peak_bytes": (torch.cuda.max_memory_allocated(device)
                              if cuda else 0)}
    ts = getattr(outcome.session, "trace_summary", None)
    if trace and ts is not None:
        dev["busy_s"], dev["window_s"] = ts.busy_s, ts.window_s
    if cuda:
        dev["power"] = power_limit()
    breakdown = outcome.session.breakdown() if trace else None
    outcome.session.release()
    t_check = time.perf_counter()
    readings, info = outcome.session.check(outcome.done)
    correct, compared = checks.verdict(readings, bench.limits)
    if log is not None:
        log("read beside the check: " + ", ".join(
            f"{k} {v!r}" for k, v in {**readings, **info}.items()
            if k not in compared))
    line: Dict[str, Any] = {
        "correct": correct, "attempted": outcome.attempted,
        "failed": outcome.failed, "metrics": metrics, "device": dev}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["check_s"] = time.perf_counter() - t_check
    line["checks"] = compared
    return line
