"""Find everything a cell needs by the names ``BENCHMARK.json`` gives.

A cell names a configuration and a traffic mix. The configuration is
``configs/<config>.json`` (its ``family`` is the module pair
``models/<family>.py`` and ``reference/<family>.py``); the traffic is
``traffic/<traffic>.json`` (its ``kind`` is ``generators/<kind>.py``);
each per-layer metric is ``metrics/<name>.py`` or, shared by its
variants, ``metrics/<name before the dot>.py``; the limits of the
correctness check are ``limits/<cell>.json``. Adding any of them is
adding files and entries, never editing one.
"""
from __future__ import annotations

import dataclasses
import importlib
import json
from pathlib import Path
from typing import Any, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_benchmark(root: Path = ROOT) -> Dict[str, Any]:
    with open(root / "BENCHMARK.json") as fh:
        return json.load(fh)


def cell(bench_json: Dict[str, Any], name: str) -> Dict[str, Any]:
    for w in bench_json["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; cells: "
                   f"{[w['name'] for w in bench_json['workloads']]}")


def config_file(bench_json: Dict[str, Any], name: str) -> Dict[str, Any]:
    for c in bench_json["configs"]:
        if c["name"] == name:
            with open(ROOT / c["file"]) as fh:
                return json.load(fh)
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic_file(name: str, base: Path = HERE) -> Dict[str, Any]:
    with open(base / "traffic" / f"{name}.json") as fh:
        return json.load(fh)


def limits_file(cell_name: str, base: Path = HERE) -> Optional[Dict[str, Any]]:
    path = base / "limits" / f"{cell_name}.json"
    if not path.exists():
        return None
    with open(path) as fh:
        return json.load(fh)


def family(config: Dict[str, Any]):
    return importlib.import_module(f"perfbench.models.{config['family']}")


def reference(config: Dict[str, Any]):
    return importlib.import_module(f"perfbench.reference.{config['family']}")


def generator(traffic: Dict[str, Any]):
    return importlib.import_module(f"perfbench.generators.{traffic['kind']}")


def metric_reader(name: str):
    """The reader of per-layer metric ``name``: ``metrics/<name>.py`` (a
    dot or dash in the name is an underscore in the file's), else the
    reader of the name before its first dot."""
    for stem in (name, name.split(".")[0]):
        mod = stem.replace(".", "_").replace("-", "_")
        if (HERE / "metrics" / f"{mod}.py").exists():
            return importlib.import_module(f"perfbench.metrics.{mod}")
    raise KeyError(f"no reader metrics/<name>.py for per-layer metric "
                   f"{name!r}")


def metrics_of(bench_json: Dict[str, Any], cell_name: str, key: str
               ) -> List[Dict[str, Any]]:
    """The ``end_to_end`` or ``per_layer`` metrics a cell reports: those
    that list it under ``workloads``, and those with no such list."""
    return [m for m in bench_json[key]
            if cell_name in m.get("workloads", [cell_name])]


@dataclasses.dataclass
class Bench:
    """One run's inputs: the cell, its configuration and traffic files,
    the seed, the window's seconds, whether to trace, the device, and the
    limits of its correctness check (None: no limits file)."""
    cell: str
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    seed: int
    seconds: float
    trace: bool
    device: Any
    limits: Optional[Dict[str, Any]]


def resolve(cell_name: str, seed: int, seconds: float, trace: bool, device,
            bench_json: Dict[str, Any], base: Path = HERE) -> Bench:
    """The cell's files: its traffic and limits under ``base`` (this
    folder; a test's own folder holds throwaway ones)."""
    w = cell(bench_json, cell_name)
    return Bench(cell_name, config_file(bench_json, w["config"]),
                 traffic_file(w["traffic"], base), seed, seconds, trace,
                 device, limits_file(cell_name, base))
