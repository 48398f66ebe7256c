"""Port parity for the serving telemetry (``repro_torch.serve.telemetry``
and the engine's registry snapshot) against the JAX package.

* the helpers and the registry: the same values, registrations and
  observations give equal percentiles, bucket bounds, histogram counts,
  ``snapshot()`` and ``prometheus()`` text (exact: the two are the same
  host arithmetic);
* the engines: both serve the same requests (reduced phi3, the JAX
  params converted) under the unpaged, paged + prefix, paged int4 and
  speculative configs, telemetry off and on: equal snapshot key sets and
  every counter, gauge and histogram ``count`` equal — timing values
  (``compile_seconds_*``, ``first_call_seconds_*``, histogram sums and
  quantiles) exempt;
* both paged telemetry snapshots validate against
  ``tools/metrics_schema.json`` (the port's old ``stats()`` did not);
* ``write_trace``: Chrome JSON, a queued → retired lane per uid, the
  JAX engine's span names.
"""
import json
import os
import re
import sys

import jax
import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.models import init_lm as jinit_lm
from repro.serve import Engine as JEngine
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro.serve import telemetry as jtel
from repro_torch.configs import get_config
from repro_torch.convert import convert_params
from repro_torch.kernels import _build
from repro_torch.serve import Engine, Request, ServeConfig
from repro_torch.serve import telemetry as ttel

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from tools.validate_metrics import validate  # noqa: E402

COMMON = dict(max_len=64, decode_batch=2, max_new_tokens=5, prefill_len=32)
CONFIGS = {"unpaged": {}, "paged_prefix": dict(paged=True, page_size=8),
           "paged_int4": dict(paged=True, page_size=8, kv_dtype="int4"),
           "speculative": dict(speculative=True, spec_k=3)}
TIMING = re.compile(r"^(compile_seconds|first_call_seconds)_")


@pytest.fixture(scope="module")
def models():
    jcfg = jget_config("phi3-mini-3.8b").reduced()
    params = jinit_lm(jax.random.PRNGKey(0), jcfg)
    model = convert_params(jax.tree_util.tree_map(np.asarray, params),
                           get_config("phi3-mini-3.8b").reduced(),
                           device="cpu")
    return jcfg, params, model


def _prompts(n=4):
    """A shared 16-token prefix (two pages of 8) and tails of 3–6."""
    rng = np.random.default_rng(3)
    head = rng.integers(0, 256, 16)
    return [np.concatenate([head, rng.integers(0, 256, 3 + i % 4)])
            .astype(np.int32) for i in range(n)]


def _run(models, kw):
    jcfg, params, model = models
    jeng = JEngine(params, jcfg, JServeConfig(**COMMON, **kw))
    jres = jeng.generate([JRequest(uid=i, prompt=p)
                          for i, p in enumerate(_prompts())])
    eng = Engine(model, model.cfg, ServeConfig(**COMMON, **kw), device="cpu")
    res = eng.generate([Request(uid=i, prompt=p)
                        for i, p in enumerate(_prompts())])
    assert [r.tokens.tolist() for r in res] == \
        [r.tokens.tolist() for r in jres]
    return jeng, eng


def _same_counts(want, got):
    assert set(got) == set(want)
    for key, w in want.items():
        if isinstance(w, dict):
            assert got[key]["count"] == w["count"], key
        elif not TIMING.match(key):
            assert got[key] == w, key


# ---------------------------------------------------------------------------
# helpers and the registry, exact
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", [1, 2, 10, 17])
def test_percentile_and_latency_summary_match_jax(n):
    vals = np.random.default_rng(n).exponential(size=n).tolist()
    for q in (0.0, 0.5, 0.95, 0.99, 1.0):
        assert ttel.percentile(vals, q) == jtel.percentile(vals, q)
    assert ttel.latency_summary(vals, 1e3) == jtel.latency_summary(vals, 1e3)
    assert ttel.latency_summary([]) == jtel.latency_summary([])
    with pytest.raises(ValueError):
        ttel.percentile([], 0.5)
    with pytest.raises(ValueError):
        ttel.percentile(vals, 1.5)


def test_buckets_and_histogram_match_jax():
    assert ttel.log_buckets() == jtel.log_buckets()
    assert ttel.log_buckets(1e-12, 100.0, 2) == jtel.log_buckets(1e-12, 100.0,
                                                                 2)
    samples = np.random.default_rng(0).lognormal(-6, 2, size=500)
    th, jh = ttel.Histogram("h"), jtel.Histogram("h")
    for v in samples:
        th.observe(float(v))
        jh.observe(float(v))
    assert th.counts == jh.counts and th.snapshot() == jh.snapshot()
    assert ttel.Histogram("e").snapshot() == jtel.Histogram("e").snapshot()


def test_registry_snapshot_and_prometheus_match_jax():
    regs = (ttel.MetricsRegistry(), jtel.MetricsRegistry())
    for reg in regs:
        reg.counter("reqs", "requests").inc(3)
        reg.counter("set_counter").set(7.5)
        reg.gauge("occ", "occupancy").set(0.5)
        h = reg.histogram("lat", "latency")
        for v in (0.001, 0.01, 0.01, 4.2, 250.0):
            h.observe(v)
        reg.histogram("kl", buckets=ttel.log_buckets(1e-12, 100.0, 2))
    assert regs[0].snapshot() == regs[1].snapshot()
    assert regs[0].prometheus() == regs[1].prometheus()
    for reg in regs:
        reg.reset_histograms()
    assert regs[0].snapshot() == regs[1].snapshot()
    with pytest.raises(TypeError):
        regs[0].gauge("reqs")
    with pytest.raises(TypeError):
        regs[0].counter("occ")
    with pytest.raises(TypeError):
        regs[0].histogram("reqs")


def test_null_telemetry_interface_is_complete():
    live = [n for n in dir(ttel.Telemetry) if not n.startswith("_")
            and callable(getattr(ttel.Telemetry, n))]
    assert live == [n for n in dir(jtel.Telemetry) if not n.startswith("_")
                    and callable(getattr(jtel.Telemetry, n))]
    for name in live:
        assert hasattr(ttel.NULL_TELEMETRY, name), name
    assert ttel.NULL_TELEMETRY.enabled is False
    with ttel.NULL_TELEMETRY.phase("decode"), \
            ttel.NULL_TELEMETRY.entry("decode", (1, 2)):
        pass


def test_entry_counts_kernel_build_seconds(monkeypatch):
    """``compile_seconds_<entry>`` is the nvcc wall time of the kernel
    builds that ran inside that entry's calls; 0 once built."""
    tel = ttel.Telemetry()
    monkeypatch.setattr(_build.BUILD_SECONDS, "total", 10.0)
    with tel.entry("decode", (8, 1)):
        _build.BUILD_SECONDS.total += 2.5         # a build during the call
    with tel.entry("decode", (8, 1)):
        pass
    tel.publish()
    snap = tel.registry.snapshot()
    assert snap["compile_seconds_decode"] == 2.5
    assert snap["dispatches_decode"] == 2
    assert snap["compiled_shapes_decode"] == 1


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("telemetry", [False, True], ids=["tel_off",
                                                          "tel_on"])
@pytest.mark.parametrize("mode", sorted(CONFIGS))
def test_engine_snapshot_matches_jax(models, mode, telemetry):
    jeng, eng = _run(models, dict(CONFIGS[mode], telemetry=telemetry))
    want, got = jeng.stats(), eng.stats()
    _same_counts(want, got)
    assert eng.metrics() == got
    if mode == "paged_prefix":
        assert got["prefix_hit_tokens"] > 0
    if mode == "speculative":
        assert got["spec_rounds"] > 0
        assert got["spec_accept_per_round"]["count"] > 0
    if telemetry:
        assert got["step_decode_seconds"]["count"] > 0
        assert "# TYPE step_seconds histogram" in eng.prometheus()
    else:
        assert "step_seconds" not in got
    if telemetry and mode.startswith("paged"):
        # the checked-in schema pins a paged telemetry snapshot
        with open(os.path.join(REPO, "tools", "metrics_schema.json")) as fh:
            schema = json.load(fh)
        assert validate(want, schema, schema) == []
        assert validate(got, schema, schema) == []


def test_reset_stats_and_warmup(models):
    _, _, model = models
    eng = Engine(model, model.cfg, ServeConfig(**COMMON, telemetry=True,
                                               speculative=True, spec_k=3),
                 device="cpu")
    eng.warmup()
    st = eng.stats()
    assert st["admitted"] == st["retired"] == st["decode_steps"] == 0
    assert st["spec_accept_per_round"]["count"] == 0
    assert st["step_seconds"]["count"] == 0
    # the dispatch accounting describes the session: warmup's calls stay
    assert st["dispatches_prefill"] == 1 and st["dispatches_draft"] >= 1
    eng.generate([Request(uid=i, prompt=p) for i, p in enumerate(_prompts())])
    assert eng.stats()["retired"] == 4
    eng.reset_stats()
    assert eng.stats()["retired"] == 0


def test_trace_matches_jax(models, tmp_path):
    jeng, eng = _run(models, dict(CONFIGS["paged_prefix"], telemetry=True))
    docs = {}
    for tag, e in (("jax", jeng), ("port", eng)):
        e.write_trace(str(tmp_path / f"{tag}.json"),
                      jsonl_path=str(tmp_path / f"{tag}.jsonl"))
        docs[tag] = json.loads((tmp_path / f"{tag}.json").read_text())
    events = docs["port"]["traceEvents"]
    assert docs["port"]["displayTimeUnit"] == "ms"
    assert {e["name"] for e in events} == \
        {e["name"] for e in docs["jax"]["traceEvents"]}
    for ev in events:
        assert set(ev) >= {"ph", "name", "pid", "tid", "ts"} and ev["ts"] >= 0
    for uid in range(4):
        lane = [e for e in events
                if e["pid"] == 1 and e["tid"] == uid and e["ph"] != "M"]
        names = [e["name"] for e in lane]
        assert names[0] == "queued" and names[-1] == "retired", names
        assert {"prefill", "first_token", "decode"} <= set(names)
    lines = (tmp_path / "port.jsonl").read_text().strip().splitlines()
    assert [json.loads(ln) for ln in lines] == events
    with pytest.raises(RuntimeError, match="telemetry"):
        Engine(eng.model, eng.cfg, ServeConfig(**COMMON), device="cpu") \
            .write_trace(str(tmp_path / "x.json"))


def test_profile_dir_writes_a_torch_profiler_trace(models, tmp_path):
    _, _, model = models
    eng = Engine(model, model.cfg, ServeConfig(
        **COMMON, profile_dir=str(tmp_path), profile_steps=2), device="cpu")
    eng.generate([Request(uid=0, prompt=_prompts(1)[0])])
    doc = json.loads((tmp_path / ttel.PROFILE_TRACE).read_text())
    assert any(e.get("name") == "serve/decode"
               for e in doc["traceEvents"])
