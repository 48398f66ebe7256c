"""One run of each serving cell, cut to a tiny size, on the CPU: the result
line has the keys and the shape the benchmark's contract asks for, and
its checks pass against the reference."""
from __future__ import annotations

import json
import time

import pytest
import torch

from perfbench import bench, registry
from perfbench.tests import tiny


@pytest.mark.parametrize("cell", list(tiny.CELLS))
def test_result_line(tmp_path, cell):
    bj = tiny.setup(tmp_path)
    line = bench.execute(bj, cell, 2**31 + 11, tiny.SECONDS, False,
                         torch.device("cpu"), time.perf_counter(), tmp_path)
    json.dumps(line)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    want = {m["name"] for m in registry.metrics_of(bj, cell, "end_to_end")}
    assert set(line["metrics"]) == want
    for m in line["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert set(line["checks"]) == set(json.loads(
        (tmp_path / "limits" / f"{cell}.json").read_text()))


def test_percentile_metric_names():
    class Out:
        end_to_end = {"out_tok_s": 3.0}
        samples = {"itl_ms": list(range(101))}
    assert bench.end_to_end("out_tok_s", Out) == 3.0
    assert bench.end_to_end("itl_p95_ms", Out) == pytest.approx(95.0)
    assert bench.end_to_end("itl_p90_ms", Out) == pytest.approx(90.0)
    with pytest.raises(KeyError):
        bench.end_to_end("ttft_p90_ms", Out)
