"""The port's accuracy-drift monitor (``ServeConfig(drift_monitor=True)``)
against the JAX engine's.

* the sampling cadence: at rates 1.0 and 0.25 the port's engine makes the
  JAX engine's ``drift_checks`` (and agreement, non-finite and histogram
  counts) on the same requests (reduced phi3, the JAX params converted);
* read-only: the port's decode writes the cache in place, so the probe's
  reference pass saves and restores what it writes. On a quantized model,
  unpaged and paged, bf16 / int8 / int4 KV, the monitored engine's tokens
  and every cache tensor after every step are bit-identical to a bare
  engine's; the served logits stay within a KL of 1e-2 of the reference;
* a NaN-poisoned model trips ``drift_nonfinite`` as the JAX engine's
  does (equal counts); tokens outside the vocabulary count in
  ``guard_token_oob``;
* the rate, scheduler and ``drift_ref_fused`` validation raise the JAX
  engine's errors.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import init_lm as jinit_lm
from repro.serve import Engine as JEngine
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro_torch.configs import get_config
from repro_torch.convert import convert_params
from repro_torch.core.api import PTQConfig
from repro_torch.models import init_lm
from repro_torch.models.quantize import quantize_model_params
from repro_torch.serve import Engine, Request, ServeConfig

COMMON = dict(max_len=64, decode_batch=2, max_new_tokens=6, prefill_len=16)
COUNTS = ("drift_checks", "drift_top1_agree", "drift_nonfinite",
          "guard_token_oob", "drift_top1_agreement_rate")


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    """Many small ops: two intra-op threads, as in
    ``tests/test_torch_train.py``; restored after the module."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def models():
    jcfg = jget_config("phi3-mini-3.8b").reduced()
    params = jinit_lm(jax.random.PRNGKey(0), jcfg)
    model = convert_params(jax.tree_util.tree_map(np.asarray, params),
                           get_config("phi3-mini-3.8b").reduced(),
                           device="cpu")
    return jcfg, params, model


@pytest.fixture(scope="module")
def quantized():
    """The port's own SRR pass (identity scaling, rank 8): the serving
    and reference lowerings then differ."""
    cfg = get_config("phi3-mini-3.8b").reduced()
    model, _ = quantize_model_params(init_lm(cfg, 0, device="cpu"),
                                     PTQConfig(rank=8, scaling="identity"),
                                     device="cpu")
    return model


def _reqs(cls, n, seed=0):
    rng = np.random.default_rng(seed)
    return [cls(uid=i, prompt=rng.integers(0, 256, size=5 + 4 * (i % 3))
                .astype(np.int32)) for i in range(n)]


def _pair(models, **kw):
    jcfg, params, model = models
    jeng = JEngine(params, jcfg, JServeConfig(**COMMON, **kw))
    jeng.generate(_reqs(JRequest, 3))
    eng = Engine(model, model.cfg, ServeConfig(**COMMON, **kw), device="cpu")
    eng.generate(_reqs(Request, 3))
    return jeng.stats(), eng.stats()


@pytest.mark.parametrize("rate", [1.0, 0.25])
def test_drift_checks_match_jax(models, rate):
    want, got = _pair(models, drift_monitor=True, drift_sample_rate=rate)
    assert got["drift_checks"] > 0
    assert [got[k] for k in COUNTS] == [want[k] for k in COUNTS]
    for h in ("drift_kl", "drift_logit_delta"):
        assert got[h]["count"] == want[h]["count"] == got["drift_checks"]


def test_monitor_off_publishes_zeroed_series(models):
    want, got = _pair(models)
    assert [got[k] for k in COUNTS] == [want[k] for k in COUNTS] \
        == [0, 0, 0, 0, 1.0]
    assert got["drift_kl"]["count"] == 0


@pytest.mark.parametrize("kw", [
    dict(kv_dtype="bf16"), dict(kv_dtype="int4"),
    dict(kv_dtype="int8", paged=True, page_size=8),
    dict(kv_dtype="int4", paged=True, page_size=8, prefill_len=8)],
    ids=["unpaged_bf16", "unpaged_int4", "paged_int8", "paged_int4_chunked"])
def test_monitor_leaves_tokens_and_cache_bit_identical(quantized, kw):
    engines = [Engine(quantized, quantized.cfg,
                      ServeConfig(**dict(COMMON, drift_monitor=mon,
                                         drift_sample_rate=1.0, **kw)),
                      device="cpu") for mon in (False, True)]
    for eng in engines:
        for r in _reqs(Request, 4):
            eng.submit(r)
    done = [[], []]
    while engines[0].sched.has_work:
        for i, eng in enumerate(engines):
            done[i].extend(eng.step())
        for a, b in zip(engines[0].slots.cache, engines[1].slots.cache):
            assert a.keys() == b.keys()
            for key in a:
                assert torch.equal(a[key], b[key]), key
    assert not engines[1].sched.has_work
    assert [r.tokens.tolist() for r in done[0]] == \
        [r.tokens.tolist() for r in done[1]]
    st = engines[1].stats()
    assert st["drift_checks"] > 0 and st["drift_nonfinite"] == 0
    assert st["guard_token_oob"] == 0
    assert 0.0 <= st["drift_top1_agreement_rate"] <= 1.0
    assert st["drift_kl"]["count"] == st["drift_checks"]
    # both lowerings read the same containers: the divergence is
    # lowering round-off, not model error
    assert st["drift_kl"]["max"] < 1e-2


def test_nan_injection_trips_guard(models):
    jcfg, params, model = models
    bad = jax.tree_util.tree_map(
        lambda x: (jnp.full_like(x, jnp.nan)
                   if jnp.issubdtype(x.dtype, jnp.floating) else x), params)
    kw = dict(COMMON, drift_monitor=True, drift_sample_rate=1.0,
              max_new_tokens=3)
    jeng = JEngine(bad, jcfg, JServeConfig(**kw))
    jeng.generate(_reqs(JRequest, 2))
    poisoned = convert_params(jax.tree_util.tree_map(np.asarray, bad),
                              model.cfg, device="cpu")
    eng = Engine(poisoned, model.cfg, ServeConfig(**kw), device="cpu")
    eng.generate(_reqs(Request, 2))
    want, got = jeng.stats(), eng.stats()
    assert got["drift_checks"] > 0 and got["drift_nonfinite"] > 0
    assert [got[k] for k in COUNTS] == [want[k] for k in COUNTS]


def test_host_guard_counts_out_of_vocab_tokens(models):
    jcfg, params, model = models
    toks = np.asarray([model.cfg.vocab, 5, -1, 2], np.int32)
    jeng = JEngine(params, jcfg, JServeConfig(**COMMON))
    eng = Engine(model, model.cfg, ServeConfig(**COMMON), device="cpu")
    jeng._host_guard(toks, [0, 1, 2])
    eng._host_guard(toks.tolist(), [0, 1, 2])
    assert eng.stats()["guard_token_oob"] == jeng.stats()["guard_token_oob"] \
        == 2


@pytest.mark.parametrize("kw", [
    dict(drift_monitor=True, drift_sample_rate=0.0),
    dict(drift_monitor=True, drift_sample_rate=-0.5),
    dict(drift_monitor=True, drift_sample_rate=1.5),
    dict(drift_monitor=True, scheduler="bucketed"),
    dict(drift_ref_fused="kernelz")],
    ids=["rate0", "rate_neg", "rate_gt1", "bucketed", "ref_fused"])
def test_validation_matches_jax(models, kw):
    jcfg, params, model = models
    with pytest.raises(ValueError) as want:
        JEngine(params, jcfg, JServeConfig(**kw))
    with pytest.raises(ValueError) as got:
        Engine(model, model.cfg, ServeConfig(**kw), device="cpu")
    assert str(got.value) == str(want.value)
