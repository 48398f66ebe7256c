"""Port parity: recurrentgemma-9b's hybrid stack (RG-LRU blocks and the
sliding-window ring) against the JAX package on the CPU.

The reduced config keeps the family's structure: 6 layers of (rglru,
rglru, local) × 2, d 64, 4 heads over one KV head of 16, window 16,
d_rnn 64; a copy cut to 4 layers (one period, then an [rglru]
remainder) covers the converter's group/suffix order. Weights come from
seeded JAX inits (fp, or through JAX's SRR pass) converted to the port;
inputs from numpy seeds. JAX's Pallas kernels run in interpret mode
(``fused="on"``), as its own tests run them, against the port's plain
versions.

Tolerances: the RG-LRU block's y, h and conv state 1e-5 (f32; the scan
sums in another order than JAX's ``associative_scan``, ulp-level);
the local ring's K/V 1e-6 of their largest magnitude (one f32
projection, its 64-term sums in another order than XLA's, and RoPE;
int8/int4 dequantized) with ``slot_pos`` and ``pos`` equal; logits 1e-4; greedy
tokens identical; calibration moments 1e-5 of their largest entry (the
inputs past the first scan carry its reassociation through the layers:
observed up to 2.6e-6, at ``L3.rglru.w_out``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core.api import PTQConfig as JPTQConfig
from repro.data import capture_calibration as jcapture
from repro.data import data_config_for as jdata_config_for
from repro.models import Ctx as JCtx
from repro.models import decode_step as jdecode_step
from repro.models import init_cache as jinit_cache
from repro.models import init_lm as jinit_lm
from repro.models import lm_loss as jlm_loss
from repro.models import prefill as jprefill
from repro.models.attention import attention_seq as jattention_seq
from repro.models.attention import attention_step as jattention_step
from repro.models.attention import init_attn_cache as jinit_attn_cache
from repro.models.quantize import _stats_for as jstats_for
from repro.models.quantize import quantize_model_params as jquantize
from repro.models.rglru import init_rglru_cache as jinit_rglru_cache
from repro.models.rglru import rglru_seq as jrglru_seq
from repro.models.rglru import rglru_step as jrglru_step
from repro.quant.base import QuantizerConfig
from repro.serve import Engine as JEngine
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import convert_params
from repro_torch.core.api import PTQConfig
from repro_torch.data import capture_calibration, data_config_for
from repro_torch.models import (Ctx, decode_step, init_cache, init_lm,
                                lm_loss, prefill, prefill_chunk)
from repro_torch.models import quantize as port_quantize
from repro_torch.models.attention import (INT4, attention_seq,
                                          attention_step, init_attn_cache,
                                          restore_step_writes,
                                          save_step_writes)
from repro_torch.models.linear import FpLinear, QLinear
from repro_torch.models.quantize import quantize_model_params
from repro_torch.models.rglru import (RGLRU, RGLRU_PROJECTIONS,
                                      init_rglru_cache, linear_scan,
                                      rglru_seq, rglru_step)
from repro_torch.models.transformer import check_supported, kind_at
from repro_torch.quant.mxint import unpack_codes_4bit
from repro_torch.serve import Engine, Request, ServeConfig
from repro_torch.serve.sanitizer import SanitizerError

ARCH = "recurrentgemma-9b"
LOGIT_TOL = 1e-4
STATE_TOL = 1e-5
MOMENT_TOL = 1e-5
KV_TOL = 1e-6
KV_KINDS = {"f32": (jnp.float32, torch.float32),
            "bf16": (jnp.bfloat16, torch.bfloat16),
            "int8": (jnp.int8, torch.int8), "int4": ("int4", INT4)}


def _configs(n_layers=None):
    jcfg, cfg = jget_config(ARCH).reduced(), get_config(ARCH).reduced()
    if n_layers:
        jcfg = dataclasses.replace(jcfg, n_layers=n_layers)
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    return jcfg, cfg


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float32)
                            if np.asarray(a).dtype == jnp.bfloat16
                            else np.asarray(a).copy())


def _tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _np(t):
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _jnp(a):
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype == jnp.bfloat16 else a


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    """Many small ops: two intra-op threads, as in
    ``tests/test_torch_train.py``; restored after the module."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def fp_model():
    """(JAX config, JAX fp params, the converted model) of the reduced
    config."""
    jcfg, cfg = _configs()
    params = jinit_lm(jax.random.PRNGKey(3), jcfg)
    return jcfg, params, convert_params(_tree(params), cfg, device="cpu")


def _layer(params, i, period=3):
    """Layer ``i``'s JAX block tree (layer i of the reduced config lies in
    group i // 3 at pattern position i % 3)."""
    grp = params["groups"][f"p{i % period}"]
    return jax.tree_util.tree_map(lambda a: a[i // period], grp)


# ---------------------------------------------------------------------------
# the RG-LRU block
# ---------------------------------------------------------------------------
def test_linear_scan_is_the_recurrence():
    """The doubling scan against the plain loop ``y_t = a_t·y_{t−1} +
    b_t`` at lengths that are not powers of two."""
    gen = torch.Generator().manual_seed(0)
    for s in (1, 5, 13, 16):
        a = torch.rand((2, s, 3), generator=gen)
        b = torch.randn((2, s, 3), generator=gen)
        y, want = torch.zeros((2, 3)), []
        for t in range(s):
            y = a[:, t] * y + b[:, t]
            want.append(y)
        torch.testing.assert_close(linear_scan(a, b), torch.stack(want, 1),
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize("ragged", [False, True])
def test_rglru_block_matches_jax(fp_model, ragged):
    """``rglru_seq`` over 13 steps (rows of 13 and 6 with ``lengths``: the
    pad steps hold the state, the conv history is each row's own), then
    four ``rglru_step``s: y, h, conv and pos against JAX's."""
    jcfg, params, model = fp_model
    cfg = model.cfg
    jp = _layer(params, 0)["mixer"]
    mixer = model.blocks[0].mixer
    assert isinstance(mixer, RGLRU)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 13, cfg.d_model)).astype(np.float32)
    lens = np.asarray([13, 6], np.int32) if ragged else None
    jy, jc = jrglru_seq(JCtx(fused="off"), jp, jnp.asarray(x), jcfg,
                        cache=jinit_rglru_cache(jcfg, 2),
                        lengths=None if lens is None else jnp.asarray(lens))
    cache = init_rglru_cache(cfg, 2, torch.float32, "cpu")
    template = {k: v.clone() for k, v in cache.items()}
    y, c = rglru_seq(Ctx(), mixer, _t(x), cfg, cache=cache,
                     lengths=None if lens is None else _t(lens))
    assert all(torch.equal(cache[k], template[k]) for k in cache)  # fresh
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0,
                               atol=STATE_TOL)
    for _ in range(4):
        for key in ("h", "conv"):
            np.testing.assert_allclose(c[key].numpy(), np.asarray(jc[key]),
                                       rtol=0, atol=STATE_TOL)
        np.testing.assert_array_equal(c["pos"].numpy(), np.asarray(jc["pos"]))
        xt = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        jy, jc = jrglru_step(JCtx(fused="off"), jp, jnp.asarray(xt), jc,
                             jcfg)
        y, c = rglru_step(Ctx(), mixer, _t(xt), c, cfg)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0,
                                   atol=STATE_TOL)


# ---------------------------------------------------------------------------
# the local ring
# ---------------------------------------------------------------------------
def _kv_f32(c):
    """A cache's K/V as f32 numpy, int8/int4 codes times their scales."""
    out = []
    for key in ("k", "v"):
        a = c[key]
        if "k_scale" in c:
            codes = a
            if codes.dtype == np.uint8:
                codes = unpack_codes_4bit(torch.from_numpy(codes.copy())
                                          ).numpy()
            a = codes.astype(np.float32) * c[key + "_scale"][..., None]
        out.append(np.asarray(a, np.float32))
    return out


@pytest.mark.parametrize("kv", list(KV_KINDS))
def test_local_ring_matches_jax(fp_model, kv):
    """A local layer's ring (16 slots of a 48-slot cache) after prompts of
    27 and 19 tokens (the ring wraps in the prefill) and through 24
    decode steps past the window: ``slot_pos`` and ``pos`` bit-exact, K/V
    within 1e-6 of their scale, outputs within 1e-5."""
    jcfg, params, model = fp_model
    cfg = model.cfg
    jdt, dt = KV_KINDS[kv]
    jp = _layer(params, 2)["mixer"]
    mixer = model.blocks[2].mixer
    assert model.blocks[2].kind == "local"
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, 27, cfg.d_model)).astype(np.float32)
    lens = np.asarray([27, 19], np.int32)
    jctx = JCtx(fused="off")
    jy, jc = jattention_seq(jctx, jp, jnp.asarray(x), jcfg, local=True,
                            cache=jinit_attn_cache(jcfg, 2, 48, True, jdt),
                            lengths=jnp.asarray(lens))
    cache = init_attn_cache(cfg, 2, 48, dt, "cpu", local=True)
    assert cache["slot_pos"].shape == (2, 16)
    y, c = attention_seq(Ctx(fused="off"), mixer, _t(x), cfg, cache=cache,
                         lengths=_t(lens), local=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0,
                               atol=STATE_TOL)
    for step in range(25):
        np.testing.assert_array_equal(c["slot_pos"].numpy(),
                                      np.asarray(jc["slot_pos"]))
        np.testing.assert_array_equal(c["pos"].numpy(), np.asarray(jc["pos"]))
        mine = _kv_f32({k: _np(v) for k, v in c.items()})
        theirs = _kv_f32({k: _jnp(v) for k, v in jc.items()})
        for a, b in zip(mine, theirs):
            np.testing.assert_allclose(a, b, rtol=0,
                                       atol=KV_TOL * float(np.abs(b).max()),
                                       err_msg=f"step {step}")
        if step == 24:
            break
        xt = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        jy, jc = jattention_step(jctx, jp, jnp.asarray(xt), jc, jcfg,
                                 local=True)
        y, c = attention_step(Ctx(fused="off"), mixer, _t(xt), c, cfg,
                              local=True)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0,
                                   atol=STATE_TOL)
    assert c["pos"].tolist() == [51, 43]


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------
LENGTHS, SLOTS = [20, 13, 18], 24


def _run_both(jcfg, params, model, fused, steps, seed=3):
    """Prefill right-padded prompts of ``LENGTHS`` (longer than the
    window) into a ``SLOTS``-slot f32 cache, then ``steps`` greedy decode
    steps on both sides; asserts the logits every step."""
    b = len(LENGTHS)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, jcfg.vocab, (b, max(LENGTHS))).astype(np.int32)
    lens = np.asarray(LENGTHS, np.int32)
    jctx = JCtx(fused=fused)
    jctx.use_pallas = fused == "on"
    jpre = jax.jit(lambda p, t, c, n: jprefill(jctx, p, {"tokens": t}, jcfg,
                                               c, lengths=n))
    jdec = jax.jit(lambda p, t, c: jdecode_step(jctx, p, t, c, jcfg))
    jl, jc = jpre(params, jnp.asarray(toks),
                  jinit_cache(jcfg, b, SLOTS, dtype=jnp.float32),
                  jnp.asarray(lens))
    ctx = Ctx(fused="off" if fused == "off" else "auto")
    tl, tc = prefill(ctx, model, _t(toks).long(),
                     init_cache(model.cfg, b, SLOTS, torch.float32, "cpu"),
                     lengths=_t(lens))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=LOGIT_TOL)
    for _ in range(steps):
        tok = np.argmax(np.asarray(jl)[:, -1], -1)[:, None].astype(np.int32)
        jl, jc = jdec(params, jnp.asarray(tok), jc)
        tl, tc = decode_step(ctx, model, _t(tok).long(), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=LOGIT_TOL)
    return tc


@pytest.mark.parametrize("fused", ["off", "on"])
def test_hybrid_logits_match_jax(fp_model, fused):
    """Six layers (rglru, rglru, local) × 2, prompts of 20, 13 and 15
    tokens past the 16-slot ring, five decode steps; ``on``: JAX's Pallas
    flash and decode kernels (interpret mode, with the window) against
    the port's K4/K3 plain versions."""
    jcfg, params, model = fp_model
    assert [b.kind for b in model.blocks] == ["rglru", "rglru", "local"] * 2
    tc = _run_both(jcfg, params, model, fused, 5)
    assert tc[2]["slot_pos"].shape == (3, 16)
    assert tc[0]["pos"].tolist() == [25, 18, 23]


def test_remainder_layer_order_matches_jax():
    """Four layers: one (rglru, rglru, local) period in JAX's ``groups``,
    then an [rglru] ``suffix``, converted in depth order."""
    jcfg, cfg = _configs(4)
    params = jinit_lm(jax.random.PRNGKey(6), jcfg)
    assert len(params["suffix"]) == 1
    model = convert_params(_tree(params), cfg, device="cpu")
    assert [b.kind for b in model.blocks] == ["rglru", "rglru", "local",
                                              "rglru"]
    assert np.array_equal(model.blocks[3].mixer.lam.numpy(),
                          np.asarray(params["suffix"][0]["mixer"]["lam"]))
    _run_both(jcfg, params, model, "off", 1, seed=6)


# ---------------------------------------------------------------------------
# the PTQ pass, calibration, and JAX's first-layer lookup
# ---------------------------------------------------------------------------
def _jptq():
    return JPTQConfig(method="srr", rank=8, exact_svd=True, forced_k=3,
                      quantizer=QuantizerConfig(kind="mxint", bits=3,
                                                block_size=32))


@pytest.fixture(scope="module")
def quantized(fp_model):
    """(JAX config, JAX SRR-quantized params (int8), the converted
    model)."""
    jcfg, params, _ = fp_model
    qparams, _ = jquantize(params, None, _jptq())
    return jcfg, qparams, convert_params(_tree(qparams), _configs()[1],
                                         device="cpu")


def test_converter_takes_quantized_rglru(quantized):
    """The five RG-LRU projections arrive as Q + LR containers with
    their biases; conv_w, conv_b and lam stay f32, as JAX's pass leaves
    them."""
    _, qparams, model = quantized
    jp = _tree(_layer(qparams, 3)["mixer"])
    mixer = model.blocks[3].mixer
    for n in RGLRU_PROJECTIONS:
        p = getattr(mixer, n)
        assert isinstance(p, QLinear)
        for key, want in jp[n].items():
            assert np.array_equal(getattr(p, key).numpy(), want), (n, key)
    assert mixer.w_a.b is not None and mixer.w_gate.b is None
    for n in ("conv_w", "conv_b", "lam"):
        assert np.array_equal(getattr(mixer, n).numpy(), jp[n])


@pytest.fixture(scope="module")
def calibrated(fp_model):
    jcfg, params, model = fp_model
    jstats = jcapture(params, jcfg, jdata_config_for(jcfg, 32, 4, 0),
                      lambda c, p, b, cc: jlm_loss(c, p, b, cc), n_batches=1)
    stats = capture_calibration(model, data_config_for(model.cfg, 32, 4, 0),
                                lm_loss, n_batches=1, device="cpu")
    return jstats, stats


def test_calibration_taps_match_jax(calibrated):
    """Tap names ``L<i>.rglru.w_gate`` … (the gate and branch share x's
    moments, ``w_a``/``w_x`` the conv output's) and ``L<i>.attn.wq`` … on
    the local layers, with JAX's counts and moments."""
    jstats, stats = calibrated
    assert sorted(stats) == sorted(jstats)
    for i in (0, 1, 3, 4):
        assert stats[f"L{i}.rglru.w_gate"] is stats[f"L{i}.rglru.w_branch"]
        assert stats[f"L{i}.rglru.w_a"] is stats[f"L{i}.rglru.w_x"]
        assert f"L{i}.rglru.w_out" in stats
    for key, st in stats.items():
        js = jstats[key]
        assert st.count == int(float(js.count))
        theirs = np.asarray(js.autocorr)
        np.testing.assert_allclose(
            st.autocorr.numpy(), theirs, rtol=0,
            atol=MOMENT_TOL * float(np.abs(theirs).max()))


def test_pass_quantizes_each_rglru_projection_under_its_layer(
        calibrated, monkeypatch):
    """The port's pass hands ``blocks.<i>.mixer.<name>`` the moments of
    ``L<i>.rglru.<name>`` (``L<i>.attn.<name>`` on a local layer) and
    keeps the biases."""
    _, stats = calibrated
    seen = {}
    real = port_quantize.quantize_layer

    def spy(name, w, cfg, gen, st, recorder=None):
        seen[name] = st
        return real(name, w, cfg, gen, st, recorder=recorder)

    monkeypatch.setattr(port_quantize, "quantize_layer", spy)
    _, cfg = _configs()
    model = init_lm(cfg, 1, device="cpu")
    keep = dict(stats)
    model, reports = quantize_model_params(
        model, PTQConfig(method="srr", rank=8, exact_svd=True, forced_k=3),
        stats=dict(stats), device="cpu")
    assert len(reports) == 4 * (5 + 3) + 2 * (4 + 3)
    for i, blk in enumerate(model.blocks):
        role = "rglru" if blk.kind == "rglru" else "attn"
        names = RGLRU_PROJECTIONS if role == "rglru" else ("wq", "wk", "wv",
                                                           "wo")
        for n in names:
            assert seen[f"blocks.{i}.mixer.{n}"] is keep[f"L{i}.{role}.{n}"]
            assert isinstance(getattr(blk.mixer, n), QLinear)
    assert model.blocks[0].mixer.w_x.b is not None
    assert isinstance(model.blocks[0].mixer.conv_w, torch.Tensor)


@pytest.mark.parametrize("name", RGLRU_PROJECTIONS)
def test_jax_pass_reads_first_layer_stats_for_rglru_roles(calibrated, name):
    """JAX's ``_ROLE`` has no RG-LRU names, so its suffix match hands
    every scanned RG-LRU layer (groups p0 and p1) ``L0.rglru.<name>``
    (ROADMAP §3); the port's pass looks up ``L<i>.rglru.<name>``."""
    jstats, _ = calibrated
    for pos in ("p0", "p1"):
        path = ["groups", pos, "mixer", name, "w"]
        assert jstats_for(jstats, path, "") is jstats[f"L0.rglru.{name}"]
    assert jstats[f"L4.rglru.{name}"] is not jstats[f"L0.rglru.{name}"]


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------
BUDGET = {0: 26, 1: 3, 2: 7, 3: 4, 4: 5}     # uid 0 wraps the ring
COMMON = dict(max_len=48, decode_batch=2, prefill_len=16, max_new_tokens=26)


def _requests(req_cls):
    rng = np.random.default_rng(0)
    return [req_cls(uid=i, prompt=rng.integers(0, 256, size=5 + (i % 3))
                    .astype(np.int32), max_new_tokens=BUDGET[i])
            for i in range(5)]


@pytest.mark.parametrize("kv", ["bf16", "int8", "int4"])
def test_engine_tokens_identical_to_jax(quantized, kv):
    """Greedy tokens over the SRR-quantized model equal the JAX engine's
    with slots reused mid-flight and uid 0's ring wrapping, for bf16,
    int8 and int4 KV (RG-LRU states in bf16 under int8/int4); the
    prefill template is still all zeros afterwards, and the snapshot has
    JAX's keys."""
    jcfg, qparams, model = quantized
    sc = dict(COMMON, kv_dtype=kv)
    jeng = JEngine(qparams, jcfg, JServeConfig(**sc))
    want = jeng.generate(_requests(JRequest))
    eng = Engine(model, model.cfg, ServeConfig(**sc), device="cpu")
    got = eng.generate(_requests(Request))
    assert [len(g.tokens) for g in got] == [26, 3, 7, 4, 5]
    assert [g.tokens.tolist() for g in got] == \
        [w.tokens.tolist() for w in want]
    fresh = init_cache(model.cfg, 1, 48, KV_KINDS[kv][1], "cpu")
    for mine, zero in zip(eng.slots.prefill_cache, fresh):
        assert mine.keys() == zero.keys()
        assert all(torch.equal(mine[k], zero[k]) for k in mine)
    assert set(eng.stats()) == set(jeng.stats())


def test_drift_probe_and_sanitizer_on_hybrid_int4(quantized):
    """At drift rate 1.0 with the sanitizer on, an int4 engine gives the
    bare engine's tokens; one reference step over a wrapped hybrid cache
    leaves every tensor bit for bit; an RG-LRU layer whose ``pos`` is
    off raises the sanitizer's ``pos`` verdict."""
    _, _, model = quantized
    cfg = model.cfg
    sc = dict(COMMON, kv_dtype="int4")
    want = [r.tokens.tolist() for r in Engine(
        model, cfg, ServeConfig(**sc), device="cpu").generate(
            _requests(Request))]
    eng = Engine(model, cfg, ServeConfig(**sc, sanitize=True,
                                         drift_monitor=True,
                                         drift_sample_rate=1.0),
                 device="cpu")
    assert [r.tokens.tolist() for r in eng.generate(_requests(Request))] \
        == want
    assert eng.stats()["drift_checks"] > 0
    assert eng.stats()["drift_nonfinite"] == 0

    toks = torch.from_numpy(np.random.default_rng(4).integers(0, 256, (2, 21)))
    _, cache = prefill(Ctx(), model, toks, init_cache(cfg, 2, 48, INT4, "cpu"),
                       lengths=torch.tensor([21, 9], dtype=torch.int32))
    tok = torch.tensor([[3], [7]])
    for _ in range(3):
        decode_step(Ctx(), model, tok, cache)
    before = [{k: v.clone() for k, v in c.items()} for c in cache]
    saved = [save_step_writes(c, blk.kind == "local")
             for c, blk in zip(cache, model.blocks)]
    decode_step(Ctx(fused="off"), model, tok, cache)
    for c, sv in zip(cache, saved):
        restore_step_writes(c, sv)
    for c, b in zip(cache, before):
        assert c.keys() == b.keys()
        assert all(torch.equal(c[k], b[k]) for k in c)

    eng = Engine(model, cfg, ServeConfig(**sc, sanitize=True), device="cpu")
    for r in _requests(Request)[:2]:
        eng.submit(r)
    eng.step()
    eng.step()
    eng.slots.cache[1]["pos"] = eng.slots.cache[1]["pos"] + 3
    with pytest.raises(SanitizerError, match="pos"):
        eng.step()


@pytest.mark.parametrize("kw", [dict(paged=True, page_size=8),
                                dict(speculative=True)],
                         ids=["paged", "speculative"])
def test_engine_refuses_like_jax(quantized, kw):
    jcfg, qparams, model = quantized
    with pytest.raises(ValueError) as jerr:
        JEngine(qparams, jcfg, JServeConfig(**COMMON, **kw))
    with pytest.raises(ValueError) as err:
        Engine(model, model.cfg, ServeConfig(**COMMON, **kw), device="cpu")
    assert str(err.value) == str(jerr.value)


def test_no_paged_cache_and_no_chunks(fp_model):
    """``init_cache(pages=)`` raises with JAX's message (the first
    recurrent layer), and a chunked prefill with its ``kind`` message."""
    jcfg, _, model = fp_model
    with pytest.raises(ValueError) as jerr:
        jinit_cache(jcfg, 2, 16, pages=8, page_size=8)
    with pytest.raises(ValueError) as err:
        init_cache(model.cfg, 2, 16, torch.float32, "cpu", pages=8,
                   page_size=8)
    assert str(err.value) == str(jerr.value)
    with pytest.raises(ValueError, match="paged KV supports full attention"):
        init_attn_cache(model.cfg, 2, 16, torch.float32, "cpu", pages=8,
                        page_size=8, local=True)
    cache = init_cache(model.cfg, 1, 16, torch.float32, "cpu")
    with pytest.raises(ValueError, match="kind='rglru'"):
        prefill_chunk(Ctx(), model, torch.zeros((1, 4), dtype=torch.long),
                      cache, 0, 0, 4)


# ---------------------------------------------------------------------------
# registry and refusals
# ---------------------------------------------------------------------------
def test_registered_and_laid_out():
    cfg = ARCHS[ARCH]
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jget_config(ARCH))
    check_supported(cfg)
    assert [kind_at(cfg, i) for i in range(cfg.n_layers)] == \
        ["rglru", "rglru", "local"] * 12 + ["rglru", "rglru"]
    model = init_lm(cfg.reduced(), 0, device="cpu")
    mixer = model.blocks[0].mixer
    assert isinstance(mixer, RGLRU) and isinstance(mixer.w_a, FpLinear)
    assert mixer.w_a.b.shape == (64,) and mixer.conv_w.shape == (4, 64)
    assert mixer.w_out.w.shape == (64, 64)
    # lam = softplus⁻¹(−log(u) / 8) with u in (0.9, 0.999)
    u = torch.exp(-8 * torch.nn.functional.softplus(mixer.lam))
    assert bool(((u > 0.9 - 1e-5) & (u < 0.999 + 1e-5)).all())
    cache = init_cache(cfg.reduced(), 2, 8, torch.int8, "cpu")
    assert cache[0]["conv"].dtype == torch.bfloat16
    assert cache[0]["h"].dtype == torch.float32
    assert cache[2]["k"].dtype == torch.int8


@pytest.mark.parametrize("arch", ["xlstm-125m", "whisper-large-v3",
                                  "internvl2-2b"])
def test_check_supported_refuses(arch):
    """The families after the hybrid are admitted: xlstm-125m,
    whisper-large-v3 and internvl2-2b's vision prefix
    (``tests/test_torch_xlstm.py``, ``tests/test_torch_whisper.py``,
    ``tests/test_torch_vlm.py``, which also holds the prefix refused
    beside an MoE, MLA, a hybrid, xLSTM or an encoder)."""
    cfg = ModelConfig(**dataclasses.asdict(jget_config(arch)))
    check_supported(cfg)
