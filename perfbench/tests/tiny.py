"""Tiny cells for the CPU tests: the real configuration and traffic files
cut to a few rows and lanes, written under a test's temporary folder.
The open-loop mix (``open_poisson``: a paged engine, chunked prefill,
Poisson arrivals) has no cell in ``BENCHMARK.json`` yet; its tiny
traffic is written here whole."""
from __future__ import annotations

import copy
import json
from pathlib import Path
from typing import Dict

from perfbench import registry

DENSE = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
             d_ff=128, vocab=256)
MOE = dict(DENSE, n_routed=8, top_k=2, d_expert=32, n_shared=1)
# short outputs, so that a window of a few steps finishes requests even
# on a CPU that the rest of the test suite keeps busy
BATCH = dict(engine=dict(decode_batch=4, max_len=160, prefill_len=96),
             prompt=dict(median=24, sigma=0.6, min=4, max=64),
             output=dict(median=3, sigma=0.3, min=2, max=4), backlog=4)
OPEN = dict(kind="open_poisson",
            engine=dict(decode_batch=4, max_len=160, prefill_len=32,
                        paged=True, page_size=16, prefix_cache=True,
                        max_step_tokens=68, scheduler="continuous"),
            rate=8.0, prompt=dict(median=48, sigma=0.4, min=32, max=96),
            output=dict(min=2, max=6), strata=16, grace_seconds=120,
            trace_seconds=6, logprobs=5, check=dict(requests=8))
SECONDS = 3.0
PASS = dict(calib_rows=96)
CELLS = {"phi3-chat-batch": ("phi3-mini-3.8b", "chat-batch", DENSE, BATCH),
         "dsmoe-chat-batch": ("deepseek-moe-16b", "chat-batch", MOE, BATCH),
         "phi3-longprompt-open": ("phi3-mini-3.8b", None, DENSE, OPEN),
         "phi3-srr-pass": ("phi3-mini-3.8b", "srr-pass", DENSE, PASS)}
SERVING = [c for c in CELLS if c != "phi3-srr-pass"]


def _cut(d: Dict, cut: Dict) -> Dict:
    out = copy.deepcopy(d)
    for k, v in cut.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k].update(v)
        else:
            out[k] = v
    return out


LIMITS = {"logprob_err_p99": {"max": 1e-2},
          "first_logprob_err_max": {"max": 1e-2}}


def setup(base: Path) -> Dict:
    """Write tiny copies of every serving cell's files under ``base`` and
    return a ``BENCHMARK.json`` object naming them."""
    bj = registry.load_benchmark()
    (base / "traffic").mkdir(parents=True, exist_ok=True)
    (base / "limits").mkdir(exist_ok=True)
    configs, cells = [], []
    for cell, (cfg_name, traffic, mcut, tcut) in CELLS.items():
        cfg = registry.config_file(bj, cfg_name)
        cfg["model"].update(mcut)
        path = base / f"{cell}.json"
        path.write_text(json.dumps(cfg))
        configs.append(dict(name=f"tiny-{cell}", source="test",
                            file=str(path), reduced=[], why="test"))
        tr = _cut(registry.traffic_file(traffic) if traffic else {}, tcut)
        (base / "traffic" / f"tiny-{cell}.json").write_text(json.dumps(tr))
        (base / "limits" / f"{cell}.json").write_text(json.dumps(
            LIMITS if cell in SERVING else
            {"code_mismatch_pct": {"max": 0.5}, "lr_rel_err": {"max": 1e-3}}))
        cells.append(dict(name=cell, config=f"tiny-{cell}",
                          traffic=f"tiny-{cell}", chips=1, why="test"))
    bj["configs"], bj["workloads"] = configs, cells
    return bj
