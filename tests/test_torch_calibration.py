"""Port parity: the synthetic data stream, the calibration tap and the
LM loss (``data/``, ``Ctx.record``, ``models.transformer.lm_loss``).

Both packages run the same weights (JAX's ``init_lm`` through the
converter) on the same numpy-generated batches, on the CPU. Tolerances:
the tokens are integers and bit-exact; the moments are f32 sums over the
batch rows of activations that agree to f32 noise — Σ|x|, Σx² and Σxxᵀ
within 2e-6 of their largest entry (observed ≤ 5.7e-7); the loss, a mean
of logsumexps over (B·S) tokens, rtol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core.api import PTQConfig as JPTQConfig
from repro.data import calibration_summary as jcalibration_summary
from repro.data import capture_calibration as jcapture
from repro.data import data_config_for as jdata_config_for
from repro.data import host_batch as jhost_batch
from repro.data import sample_tokens as jsample_tokens
from repro.models import Ctx as JCtx
from repro.models import init_lm as jinit_lm
from repro.models import lm_loss as jlm_loss
from repro.models.quantize import quantize_model_params as jquantize
from repro.quant.base import QuantizerConfig
from repro_torch.configs import get_config
from repro_torch.convert import convert_params
from repro_torch.data import (DataConfig, batches, calibration_summary,
                              capture_calibration, data_config_for,
                              host_batch, sample_tokens)
from repro_torch.models import Ctx, forward, lm_loss
from repro_torch.models.layers import chunked_softmax_xent

ARCHS = ["phi3-mini-3.8b", "deepseek-moe-16b"]
MOMENT_TOL = 2e-6


def _jax_loss(params, batch, cfg):
    return float(jlm_loss(JCtx(), params, {k: jnp.asarray(v) for k, v in
                                          batch.items()}, cfg))


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(JAX config, JAX params, the port's config, the converted model)."""
    jcfg = jget_config(request.param).reduced()
    cfg = get_config(request.param).reduced()
    params = jinit_lm(jax.random.PRNGKey(0), jcfg)
    model = convert_params(jax.tree_util.tree_map(np.asarray, params), cfg,
                           device="cpu")
    return jcfg, params, cfg, model


@pytest.mark.parametrize("seed,step,index", [(0, 0, 0), (3, 7, 5),
                                             (11, 2, 1023)])
def test_sample_tokens_bit_exact(seed, step, index):
    for vocab, seq in ((256, 32), (32064, 17)):
        want = jsample_tokens(jdata_config_for(
            jget_config("phi3-mini-3.8b"), seq, 4, seed), step, index)
        got = sample_tokens(DataConfig(vocab, seq, 4, seed), step, index)
        if vocab == 256:
            want = jsample_tokens(jdata_config_for(
                jget_config("phi3-mini-3.8b").reduced(), seq, 4, seed),
                step, index)
        assert got.dtype == np.int64 and np.array_equal(got, want)


@pytest.mark.parametrize("host_index,host_count", [(0, 1), (1, 2), (3, 4)])
def test_host_batch_bit_exact(host_index, host_count):
    jcfg = jget_config("phi3-mini-3.8b").reduced()
    dcfg = data_config_for(get_config("phi3-mini-3.8b").reduced(), 32, 8, 4)
    for step in (0, 5):
        want = jhost_batch(jdata_config_for(jcfg, 32, 8, 4), step, host_index,
                           host_count)
        got = host_batch(dcfg, step, host_index, host_count, device="cpu")
        assert sorted(got) == sorted(want) == ["labels", "tokens"]
        for key in want:
            assert got[key].dtype == torch.int32
            assert got[key].shape == (8 // host_count, 32)
            assert np.array_equal(got[key].numpy(), np.asarray(want[key]))
    stream = batches(dcfg, 5, host_index, host_count, device="cpu")
    assert np.array_equal(next(stream)["tokens"].numpy(), got["tokens"].numpy())
    with pytest.raises(ValueError, match="divide"):
        host_batch(dcfg, 0, 0, 3, device="cpu")


def _close(a, b, name):
    b = np.asarray(b)
    np.testing.assert_allclose(a.numpy(), b, rtol=0,
                               atol=MOMENT_TOL * np.abs(b).max(), err_msg=name)


@pytest.mark.parametrize("need_autocorr", [True, False])
def test_tap_matches_jax(pair, need_autocorr):
    """Same key set (JAX's names letter for letter, no routed expert and
    no LM head), equal counts, moments within MOMENT_TOL; projections
    that read one input share one stats object.

    Without Σxxᵀ, JAX's capture swaps in a recorder that drops the layer
    prefix, so its keys pool every layer's rows (``attn.wq`` holds L0's
    and L1's); the port keeps the per-layer keys, whose moments summed
    over the layers give JAX's pooled ones."""
    jcfg, params, cfg, model = pair
    want = jcapture(params, jcfg, jdata_config_for(jcfg, 32, 4, 0),
                    lambda c, p, b, cc: jlm_loss(c, p, b, cc), n_batches=2,
                    need_autocorr=need_autocorr)
    got = capture_calibration(model, data_config_for(cfg, 32, 4, 0), lm_loss,
                              n_batches=2, need_autocorr=need_autocorr,
                              device="cpu")
    rows = 2 * 4 * 32
    if need_autocorr:
        assert sorted(got) == sorted(want)
        for name, w in want.items():
            g = got[name]
            assert g.count == float(w.count) == rows
            for a, b in ((g.sum_abs, w.sum_abs), (g.sum_sq, w.sum_sq),
                         (g.autocorr, w.autocorr)):
                _close(a, b, name)
    else:
        pooled = {}
        for name, g in got.items():
            assert g.autocorr is None and g.count == rows
            pooled.setdefault(name.split(".", 1)[1], []).append(g)
        assert sorted(pooled) == sorted(want)
        for role, w in want.items():
            assert w.autocorr is None
            assert float(w.count) == rows * len(pooled[role])
            _close(sum(g.sum_abs for g in pooled[role]), w.sum_abs, role)
            _close(sum(g.sum_sq for g in pooled[role]), w.sum_sq, role)
    for layer in range(cfg.n_layers):
        pre = f"L{layer}."
        assert got[pre + "attn.wq"] is got[pre + "attn.wk"] \
            is got[pre + "attn.wv"]
        assert got[pre + "attn.wo"] is not got[pre + "attn.wq"]
        if pre + ".up" in got:
            assert got[pre + ".up"] is got[pre + ".gate"]
        else:   # the router and the shared experts read the same tokens
            assert got[pre + "moe.router"] is got[pre + "moe.shared.up"] \
                is got[pre + "moe.shared.gate"]
    if cfg.moe:
        assert not any("experts" in k for k in got)
    summary = calibration_summary(got)
    assert sorted(summary) == sorted(got)
    if need_autocorr:
        jsummary = jcalibration_summary(want)
        for name in want:
            assert summary[name]["has_autocorr"]
            for key in ("count", "mean_abs", "rms"):
                np.testing.assert_allclose(summary[name][key],
                                           jsummary[name][key], rtol=1e-5)


def test_engine_context_records_nothing(pair):
    """The serving context has no tap: a forward under it leaves every
    record untouched."""
    _, _, cfg, model = pair
    ctx = Ctx()
    assert ctx.tap is None and ctx.aux_log is None
    lm_loss(ctx, model, host_batch(data_config_for(cfg, 16, 2, 1), 0,
                                   device="cpu"))
    assert ctx.tap is None and ctx.prefix == "" and ctx._last is None


@pytest.mark.parametrize("quantized", [False, True], ids=["fp", "srr"])
def test_lm_loss_matches_jax(pair, quantized):
    """Mean cross-entropy plus 0.01 × the MoE load-balance term, on the
    fp model and on a JAX-quantized container converted to the port."""
    jcfg, params, cfg, model = pair
    if quantized:
        ptq = JPTQConfig(method="srr", rank=8, exact_svd=True, forced_k=3,
                         quantizer=QuantizerConfig(kind="mxint", bits=3,
                                                   block_size=32))
        params, _ = jquantize(params, None, ptq)
        model = convert_params(jax.tree_util.tree_map(np.asarray, params),
                               cfg, device="cpu")
    dcfg = data_config_for(cfg, 32, 4, 9)
    for step in range(2):
        batch = host_batch(dcfg, step, device="cpu")
        want = _jax_loss(params, {k: v.numpy() for k, v in batch.items()},
                         jcfg)
        got = lm_loss(Ctx(), model, batch)
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(float(got), want, rtol=1e-5)
    if cfg.moe:
        # the load-balance term is in both: 0.01 × aux (≈ top_k = 2 when
        # balanced) is ~4e3 × the tolerance
        hidden, _ = forward(Ctx(), model, batch["tokens"])
        xent = chunked_softmax_xent(hidden, model.lm_head, batch["labels"],
                                    Ctx())
        assert float(got) - float(xent) > 0.005


def test_capture_refuses_a_model_on_another_device(pair):
    _, _, cfg, model = pair
    with pytest.raises(ValueError, match="lives on"):
        capture_calibration(model, data_config_for(cfg, 8, 2), lm_loss,
                            n_batches=1, device="meta")
