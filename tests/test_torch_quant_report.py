"""The port's quantize-time introspection (``repro_torch.obs.quant``)
against the JAX package's ``repro.obs.quant``.

Both SRR passes (reduced phi3, the same fp weights, identity scaling —
JAX's model pass reads layer 0's statistics for every scanned layer, so
calibrated scalings would differ by design — rank 8, exact SVDs, k forced
to 3: k* selection draws its probes from each framework's own generator)
run with a recorder. Per matrix: ``k``, shape, rank, bits, container and byte
counts exact; the singular-spectrum head, ``preserved_energy_fraction``,
``scaled_err`` and ``weight_err`` within ``REL_TOL`` relative (float32
SVDs and norms of the two frameworks). The port's report validates
against ``tools/quant_report_schema.json`` and ``python -m
tools.quant_report`` renders it; the containers are bit-identical with
and without a recorder; the serve CLI writes it with ``--quant-report``.
"""
import json
import os
import re
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core.api import PTQConfig as JPTQConfig
from repro.models import init_lm as jinit_lm
from repro.models.quantize import quantize_model_params as jquantize
from repro.obs import QuantRecorder as JQuantRecorder
from repro.quant.base import QuantizerConfig
from repro_torch.configs import get_config
from repro_torch.convert import convert_params
from repro_torch.core.api import PTQConfig
from repro_torch.launch import serve as serve_cli
from repro_torch.models.linear import QLinear
from repro_torch.models.quantize import quantize_model_params
from repro_torch.obs import NULL_QUANT_RECORDER, QuantRecorder

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from tools.quant_report import main as render_main  # noqa: E402
from tools.validate_metrics import validate  # noqa: E402

SCHEMA_PATH = os.path.join(REPO, "tools", "quant_report_schema.json")
REL_TOL = 1e-4
EXACT = ("shape", "method", "scaling", "rank", "k", "bits", "quant_bytes",
         "lowrank_bytes", "total_bytes", "container")
CLOSE = ("preserved_energy_fraction", "quant_exposed_energy_fraction",
         "scaled_err", "weight_err", "scaled_rel_err", "weight_rel_err")


def _schema():
    with open(SCHEMA_PATH) as f:
        return json.load(f)


def _port_name(jax_name: str) -> str:
    """``groups/p0/mixer/wq[1]`` → ``blocks.1.mixer.wq``."""
    mod, leaf, layer = re.fullmatch(r"groups/p0/(\w+)/(\w+)\[(\d+)\]",
                                    jax_name).groups()
    return f"blocks.{layer}.{mod}.{leaf}"


@pytest.fixture(scope="module")
def passes():
    jcfg = jget_config("phi3-mini-3.8b").reduced()
    params = jinit_lm(jax.random.PRNGKey(0), jcfg)
    jrec = JQuantRecorder()
    jquantize(params, None, JPTQConfig(
        method="srr", scaling="identity", rank=8, exact_svd=True, forced_k=3,
        quantizer=QuantizerConfig(kind="mxint", bits=3, block_size=32)),
        container="int8", recorder=jrec)
    tree = jax.tree_util.tree_map(np.asarray, params)
    cfg = get_config("phi3-mini-3.8b").reduced()
    ptq = PTQConfig(method="srr", scaling="identity", rank=8, exact_svd=True,
                    forced_k=3)
    rec = QuantRecorder()
    models = [quantize_model_params(convert_params(tree, cfg, device="cpu"),
                                    ptq, recorder=r, device="cpu")
              for r in (rec, None)]
    return jrec, rec, models


def test_records_match_jax_per_matrix(passes):
    jrec, rec, _ = passes
    assert {_port_name(n) for n in jrec.records} == set(rec.records)
    for jname, want in jrec.records.items():
        got = rec.records[_port_name(jname)]
        for key in EXACT:
            assert getattr(got, key) == getattr(want, key), (jname, key)
        for key in CLOSE:
            w, g = getattr(want, key), getattr(got, key)
            assert abs(g - w) <= REL_TOL * max(abs(w), 1e-6), (jname, key)
        np.testing.assert_allclose(got.singular_head, want.singular_head,
                                   rtol=REL_TOL)
    jcfg, cfg = jrec.build_report()["config"], rec.build_report()["config"]
    assert cfg == jcfg


def test_report_validates_and_renders(passes, tmp_path, capsys):
    _, rec, _ = passes
    report = rec.build_report()
    assert validate(report, _schema(), _schema()) == []
    s = report["summary"]
    assert s["layers"] == len(rec.records) == 14
    assert s["total_bytes"] == s["quant_bytes"] + s["lowrank_bytes"]
    path = str(tmp_path / "report.json")
    rec.write(path)
    with open(path) as f:
        assert validate(json.load(f), _schema(), _schema()) == []
    with open(tmp_path / "report.trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert len([e for e in events if e.get("ph") == "X"
                and e.get("pid") == 3]) == 14
    assert render_main([path, "--worst", "2"]) == 0
    out = capsys.readouterr().out
    assert "worst 2 layers" in out
    for name in rec.records:
        assert name in out


def test_containers_bit_identical_with_and_without_recorder(passes):
    _, _, ((recorded, reps_a), (bare, reps_b)) = passes
    mods = [(a, b) for a, b in zip(recorded.modules(), bare.modules())
            if isinstance(a, QLinear)]
    assert len(mods) == 14
    for a, b in mods:
        for (na, ta), (nb, tb) in zip(a.named_buffers(), b.named_buffers()):
            assert na == nb and torch.equal(ta, tb), na
    assert [(r.name, r.k_star, r.scaled_err) for r in reps_a] == \
        [(r.name, r.k_star, r.scaled_err) for r in reps_b]


def test_null_recorder_is_inert_and_schema_clean():
    NULL_QUANT_RECORDER.record_layer("x", None, None, None, None, None, None)
    NULL_QUANT_RECORDER.attach_container("x", {}, "int8")
    report = NULL_QUANT_RECORDER.build_report()
    assert validate(report, _schema(), _schema()) == []
    assert report["layers"] == {} and report["summary"]["layers"] == 0


@pytest.mark.parametrize("method,layers", [("srr", 14), ("none", 0)])
def test_serve_cli_writes_the_report(tmp_path, capsys, method, layers):
    path = str(tmp_path / "q.json")
    assert serve_cli.main(["--device", "cpu", "--method", method,
                           "--requests", "1", "--new-tokens", "2",
                           "--quant-report", path]) == 0
    assert f"quant report -> {path}" in capsys.readouterr().out
    with open(path) as f:
        report = json.load(f)
    assert validate(report, _schema(), _schema()) == []
    assert report["summary"]["layers"] == layers
    if layers:
        assert report["config"]["scaling"] == "qera-exact"
        assert report["config"]["quantizer"] == "mxint"
