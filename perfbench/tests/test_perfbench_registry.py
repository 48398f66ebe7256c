"""Every name in BENCHMARK.json resolves to its files, the file keeps to
the benchmark's contract, and a new traffic mix is data alone."""
from __future__ import annotations

import importlib
import json
import re
import time

import pytest
import torch

from perfbench import bench, registry
from perfbench.tests import tiny

BJ = registry.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_keys_and_names():
    assert set(BJ) == {"command", "paths", "run_seconds", "configs",
                       "workloads", "end_to_end", "per_layer"}
    assert BJ["paths"] == ["perfbench"]
    assert 1 <= BJ["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BJ[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads"):
        assert len({x["name"] for x in BJ[k]}) == len(BJ[k])
    metrics = BJ["end_to_end"] + BJ["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert all(UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
               for m in metrics)
    assert all(0.01 <= m["bound"] <= 0.25 for m in BJ["end_to_end"])
    assert any(m["name"] == "setup_s" for m in BJ["end_to_end"])
    e2e = {m["name"] for m in BJ["end_to_end"]}
    assert all(m["moves"] in e2e for m in BJ["per_layer"])


@pytest.mark.parametrize("cfg", [c["name"] for c in BJ["configs"]])
def test_config_resolves(cfg):
    c = registry.config_file(BJ, cfg)
    assert c["name"] == cfg
    fam = registry.family(c)
    assert fam.model_config(c).name == cfg
    assert hasattr(registry.reference(c), "score")
    assert c["reduced"] == [x for x in BJ["configs"]
                            if x["name"] == cfg][0]["reduced"]


@pytest.mark.parametrize("cell", [w["name"] for w in BJ["workloads"]])
def test_cell_resolves(cell):
    b = registry.resolve(cell, 1, 1.0, False, torch.device("cpu"), BJ)
    assert hasattr(registry.generator(b.traffic), "run")
    assert b.limits, f"limits/{cell}.json"
    e2e = registry.metrics_of(BJ, cell, "end_to_end")
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    assert registry.metrics_of(BJ, cell, "per_layer")
    for m in registry.metrics_of(BJ, cell, "per_layer"):
        assert m["moves"] in {x["name"] for x in e2e}


@pytest.mark.parametrize("metric", [m["name"] for m in BJ["per_layer"]])
def test_reader_resolves(metric):
    assert callable(registry.metric_reader(metric).read)


@pytest.mark.parametrize("metric,module", [
    ("idle_share.train", "idle_share"), ("mfu.serve", "mfu"),
    ("roofline_K1.decode", "roofline_K1")])
def test_a_new_variant_shares_its_reader(metric, module):
    """A later cell's variant of a metric needs no new reader."""
    assert registry.metric_reader(metric).__name__ == \
        f"perfbench.metrics.{module}"
    with pytest.raises(KeyError):
        registry.metric_reader("no_such_metric.batch")


def _sources():
    """The harness's modules, not a run's outputs under ``out/``."""
    return [p for p in sorted(registry.HERE.rglob("*.py"))
            if "out" not in p.relative_to(registry.HERE).parts]


def test_every_module_imports():
    for path in _sources():
        rel = path.relative_to(registry.ROOT).with_suffix("")
        importlib.import_module(".".join(rel.parts))


def test_a_new_mix_is_data_alone(tmp_path):
    """A throwaway traffic mix and the cell that uses it, registered as
    files and entries only, run end to end on the CPU."""
    bj = tiny.setup(tmp_path)
    tr = json.loads((tmp_path / "traffic" / "tiny-phi3-chat-batch.json")
                    .read_text())
    tr.update(prompt=dict(median=8, sigma=0.3, min=4, max=16),
              output=dict(min=2, max=6))
    (tmp_path / "traffic" / "throwaway.json").write_text(json.dumps(tr))
    (tmp_path / "limits" / "throwaway-cell.json").write_text(
        (tmp_path / "limits" / "phi3-chat-batch.json").read_text())
    bj["workloads"].append(dict(name="throwaway-cell",
                                config="tiny-phi3-chat-batch",
                                traffic="throwaway", chips=1, why="test"))
    for m in bj["end_to_end"]:
        if "phi3-chat-batch" in m.get("workloads", []):
            m["workloads"].append("throwaway-cell")
    line = bench.execute(bj, "throwaway-cell", 3, tiny.SECONDS, False,
                         torch.device("cpu"), time.perf_counter(), tmp_path)
    assert line["correct"] and line["attempted"] > 0
    assert {"out_tok_s", "itl_p95_ms", "setup_s"} <= set(line["metrics"])
