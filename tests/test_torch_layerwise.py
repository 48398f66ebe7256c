"""The quantized model built a block at a time (``models/build.py``)
against the whole-model composition, and its statistics against JAX's.

``build_quantized_lm`` draws, calibrates and quantizes one block before
it draws the next; ``init_lm`` → ``capture_calibration`` →
``quantize_model_params`` holds the whole fp model first. Both run the
same ops on the same inputs in the same order, so every buffer must be
equal bit for bit (``torch.equal``), for every family and for the
``qer`` / ``w-only`` methods and the ``packed4`` container. The moments
each block records are the JAX package's ``capture_calibration`` ones
within ``MOMENT_TOL`` of their largest entry, as in
``tests/test_torch_calibration.py``.
"""
import json

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.data import data_config_for as jdata_config_for
from repro.data import host_batch as jhost_batch
from repro.models import Ctx as JCtx
from repro.models import init_lm as jinit_lm
from repro.models import lm_loss as jlm_loss
from repro_torch.configs import get_config
from repro_torch.convert import convert_params
from repro_torch.core.api import PTQConfig
from repro_torch.data import capture_calibration, data_config_for
from repro_torch.launch.serve import build_quantized_model, parser
from repro_torch.models import init_lm, lm_loss
from repro_torch.models.build import (DrawnBlocks, ModelBlocks,
                                      build_quantized_lm)
from repro_torch.models.linear import FpLinear
from repro_torch.models.quantize import quantize_model_params
from repro_torch.obs import QuantRecorder
from repro_torch.quant import QuantizerConfig

FAMILIES = ["phi3-mini-3.8b", "qwen1.5-32b", "deepseek-moe-16b",
            "deepseek-v2-lite-16b", "recurrentgemma-9b", "xlstm-125m",
            "whisper-large-v3", "internvl2-2b"]
# (arch, method, container): every family under SRR into int8, and phi3
# under the baselines and into packed4
CASES = ([(arch, "srr", "int8") for arch in FAMILIES]
         + [("phi3-mini-3.8b", "qer", "int8"),
            ("phi3-mini-3.8b", "w-only", "int8"),
            ("phi3-mini-3.8b", "srr", "packed4")])
MOMENT_TOL = 2e-6
STAGES = ("draw", "calibrate", "scale", "quantize")


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    """Many small ops: two intra-op threads, as in
    ``tests/test_torch_train.py``; restored after the module."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _ptq(method="srr", seed=0):
    return PTQConfig(method=method, scaling="qera-exact",
                     quantizer=QuantizerConfig(kind="mxint", bits=3,
                                               block_size=32),
                     rank=16, seed=seed)


def _holds_fp(blk) -> bool:
    return any(isinstance(m, FpLinear) for m in blk.modules())


def _assert_same_model(got, want):
    a, b = want.state_dict(), got.state_dict()
    assert list(a) == list(b)
    for key in a:
        assert a[key].dtype == b[key].dtype, key
        assert torch.equal(a[key], b[key]), key


@pytest.mark.parametrize("arch,method,container", CASES,
                         ids=[f"{a}-{m}-{c}" for a, m, c in CASES])
def test_streamed_equals_whole(arch, method, container):
    """Bit for bit, buffer for buffer, report for report (name, k*),
    with at most one block in full precision at any stage: the hook sees
    ``tail``, then draw → calibrate → scale → quantize for each layer,
    encoder first, the current block last and the only fp one; each
    layer's statistics are gone once it is quantized."""
    cfg = get_config(arch).reduced()
    dcfg = data_config_for(cfg, 16, 2, seed=3)
    ptq = _ptq(method, seed=1)
    whole = init_lm(cfg, 5, device="cpu")
    stats = capture_calibration(whole, dcfg, lm_loss, n_batches=2,
                                device="cpu")
    whole, want = quantize_model_params(whole, ptq, container, stats=stats,
                                        device="cpu")
    seen = []

    def hook(step):
        fp = [blk for blk in step.blocks if _holds_fp(blk)]
        seen.append((step.stage, step.layer, len(fp)))
        assert len(fp) <= 1
        if fp:
            assert fp[0] is step.blocks[-1]
        if step.stage in ("calibrate", "scale"):
            assert any(k.startswith(step.layer) for k in step.stats)
        if step.stage == "quantize":
            assert not any(k.startswith(step.layer) for k in step.stats)

    got, reports = build_quantized_lm(DrawnBlocks(cfg, 5, device="cpu"), ptq,
                                      dcfg, 2, container, progress=hook,
                                      device="cpu")
    _assert_same_model(got, whole)
    assert [(r.name, r.k_star) for r in reports] \
        == [(r.name, r.k_star) for r in want]
    layers = ([f"E{e}." for e in range(cfg.enc_layers)]
              + [f"L{i}." for i in range(cfg.n_layers)])
    assert seen[0] == ("tail", "", 0)
    assert seen[1:] == [(stage, layer, int(stage != "quantize"))
                        for layer in layers for stage in STAGES]


def test_drawn_blocks_are_init_lms():
    """``DrawnBlocks`` hands out ``init_lm``'s blocks and tail, in any
    order (the build asks for the encoder before the decoder)."""
    cfg = get_config("whisper-large-v3").reduced()
    want = init_lm(cfg, 2, device="cpu")
    source = DrawnBlocks(cfg, 2, device="cpu")
    pairs = [(want.encoder[e], source.encoder_block(e))
             for e in reversed(range(cfg.enc_layers))]
    pairs += [(want.blocks[i], source.block(i)) for i in (1, 0)]
    for a, b in pairs:
        for (k, x), (_, y) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
            assert torch.equal(x, y), k
    assert torch.equal(source.tail.embed, want.embed)
    assert torch.equal(source.tail.lm_head.w, want.lm_head.w)


def test_source_on_another_device_is_refused():
    cfg = get_config("phi3-mini-3.8b").reduced()
    with pytest.raises(ValueError, match="lives on"):
        build_quantized_lm(DrawnBlocks(cfg, 0, device="cpu"), _ptq(),
                           data_config_for(cfg, 8, 2), 1, device="meta")


@pytest.fixture(scope="module", params=["phi3-mini-3.8b", "whisper-large-v3"])
def jax_moments(request):
    """(JAX's moments of JAX's reduced fp model over 2 batches of 4 × 16
    tokens, the moments the build records for each block of that model
    converted, by tap name). JAX's side is what its
    ``capture_calibration`` runs for each batch — its ``Ctx`` tap through
    ``lm_loss`` over ``host_batch(step)`` — traced once under ``jit``
    instead of op by op, the two batches' moments summed in f32 as its
    streaming update sums them; each as (count, Σ|x|, Σx², Σxxᵀ)."""
    jcfg = jget_config(request.param).reduced()
    cfg = get_config(request.param).reduced()
    params = jinit_lm(jax.random.PRNGKey(0), jcfg)

    def taps(p, batch):
        tap = {}
        jlm_loss(JCtx(tap=tap), p, batch, jcfg)
        return {k: (v.count, v.sum_abs, v.sum_sq, v.autocorr)
                for k, v in tap.items()}

    traced = jax.jit(taps)
    dcfg = jdata_config_for(jcfg, 16, 4, 0)
    per = [traced(params, jhost_batch(dcfg, step)) for step in range(2)]
    want = {k: [np.asarray(a, np.float32) + np.asarray(b, np.float32)
                for a, b in zip(per[0][k], per[1][k])] for k in per[0]}
    model = convert_params(jax.tree_util.tree_map(np.asarray, params), cfg,
                           device="cpu")
    got = {}

    def hook(step):
        if step.stage == "calibrate":
            got.update({k: v for k, v in step.stats.items()
                        if k.startswith(step.layer)})

    build_quantized_lm(ModelBlocks(model), _ptq(),
                       data_config_for(cfg, 16, 4, 0), 2, progress=hook,
                       device="cpu")
    return cfg, want, got


def test_moments_match_jax(jax_moments):
    """Every JAX tap name of a layer (``E<e>.`` / ``L<i>.``), JAX's
    counts, and Σ|x|, Σx², Σxxᵀ within ``MOMENT_TOL`` of their largest
    entry."""
    cfg, want, got = jax_moments
    layered = sorted(k for k in want if k[:1] in "EL")
    assert sorted(got) == layered
    for name in layered:
        (count, *moments), g = want[name], got[name]
        assert g.count == int(count) > 0, name
        for a, b in zip((g.sum_abs, g.sum_sq, g.autocorr), moments):
            np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                       atol=MOMENT_TOL * np.abs(b).max(),
                                       err_msg=name)


def test_moments_shared_as_capture_shares_them(jax_moments):
    """Projections that read one input share one statistics object in
    the build, as in ``capture_calibration``."""
    cfg, _, got = jax_moments
    for i in range(cfg.n_layers):
        pre = f"L{i}."
        assert got[pre + "attn.wq"] is got[pre + "attn.wk"] \
            is got[pre + "attn.wv"]
        if cfg.is_encoder_decoder:
            assert got[pre + "xattn.wk"] is got[pre + "xattn.wv"]
        if pre + ".gate" in got:
            assert got[pre + ".up"] is got[pre + ".gate"]


def _trace_names(path):
    with open(path) as f:
        events = json.load(f)
    events = events["traceEvents"] if isinstance(events, dict) else events
    return [e["name"] for e in events if e.get("ph") == "X"]


def _layers(path):
    with open(path) as f:
        layers = json.load(f)["layers"]
    for rec in layers.values():
        rec.pop("seconds")
    return layers


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "whisper-large-v3"])
def test_cli_build_equals_whole(arch, tmp_path):
    """``build_quantized_model`` on the CLI's arguments (``--device
    cpu``, the reduced config) against ``init_lm`` → ``capture_
    calibration`` (2 batches of 4 × 32 tokens) → ``quantize_model_params``
    with the CLI's PTQ config: the same model, and a ``--quant-report``
    of the same matrices, in the same order, with the same records."""
    path = str(tmp_path / "cli.json")
    args = parser().parse_args(["--device", "cpu", "--arch", arch,
                                "--quant-report", path])
    model, cfg = build_quantized_model(args, tag="test")
    assert cfg == get_config(arch).reduced()
    recorder = QuantRecorder()
    whole = init_lm(cfg, 0, device="cpu")
    stats = capture_calibration(whole, data_config_for(cfg, 32, 4, 0),
                                lm_loss, n_batches=2, device="cpu")
    whole, _ = quantize_model_params(whole, _ptq(), stats=stats,
                                     recorder=recorder, device="cpu")
    want = str(tmp_path / "whole.json")
    recorder.write(want)
    _assert_same_model(model, whole)
    assert _trace_names(path[:-5] + ".trace.json") \
        == _trace_names(want[:-5] + ".trace.json")
    assert _layers(path) == _layers(want)


def test_cli_method_none_draws_init_lm():
    """``--method none`` serves ``init_lm``'s fp model, as before."""
    args = parser().parse_args(["--device", "cpu", "--method", "none"])
    model, cfg = build_quantized_model(args, tag="test")
    _assert_same_model(model, init_lm(cfg, 0, device="cpu"))
