"""Port parity: the dense variants — chatglm3-6b (half RoPE, QKV bias,
16 query heads a KV head), minitron-4b (3 a KV head, a 256,000-token
vocabulary) and qwen1.5-32b (QKV bias, θ = 10⁶) — against the JAX
package on the CPU.

``.reduced()`` keeps each family's RoPE, bias and θ but not its group
ratio (chatglm becomes G = 2, minitron and qwen G = 1), so two
``dataclasses.replace``d configs, the same in both packages, bring the
card's ratios down to CPU size: chatglm's with 16 query heads on one KV
head and minitron's with 6 on 2. JAX's init gives zero biases; every
bias here is filled with seeded numpy values before the conversion, so a
dropped or misplaced bias fails.

Tolerances: the rotation is f32 elementwise math on both sides (1e-6);
the decode-attention plain versions 2e-5 absolute on outputs of
magnitude ~1, as ``test_torch_attention.py``; model logits those of
``test_torch_model.py`` (1e-4 with f32/int8/int4 KV, 2e-3 with bf16 KV);
greedy tokens identical; the calibrated pass as
``test_torch_ptq_methods.py`` holds a container (codes equal but for a
step at a rounding tie, scales equal, Q + LR within 1e-4 of max|W|).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core.api import PTQConfig as JPTQConfig
from repro.core.scaling import \
    autocorr_scaling_from_moments as jautocorr_scaling
from repro.data import capture_calibration as jcapture
from repro.data import data_config_for as jdata_config_for
from repro.kernels import ops as jops
from repro.kernels.ref import decode_attention_ref
from repro.models import Ctx as JCtx
from repro.models import decode_step as jdecode_step
from repro.models import init_cache as jinit_cache
from repro.models import init_lm as jinit_lm
from repro.models import lm_loss as jlm_loss
from repro.models import prefill as jprefill
from repro.models.layers import apply_rope as japply_rope
from repro.models.quantize import quantize_model_params as jquantize
from repro.quant.base import QuantizerConfig
from repro.quant.mxint import pack_codes_4bit as jpack_codes_4bit
from repro.serve import Engine as JEngine
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro_torch.configs import ARCHS, get_config
from repro_torch.convert import convert_params
from repro_torch.core.api import PTQConfig
from repro_torch.core.scaling import range_autocorr_scaling
from repro_torch.data import capture_calibration, data_config_for
from repro_torch.kernels.decode_attention import (decode_attention_op,
                                                  group_blocks)
from repro_torch.kernels.mxint_matmul import dequant_blockwise
from repro_torch.models import (Ctx, decode_step, init_cache, init_lm,
                                lm_loss, prefill)
from repro_torch.models.layers import apply_rope
from repro_torch.models.quantize import quantize_model_params
from repro_torch.models.transformer import check_supported
from repro_torch.serve import Engine, Request, ServeConfig

DENSE = ("chatglm3-6b", "minitron-4b", "qwen1.5-32b")
# (name, arch, fields replaced in the reduced config of both packages)
VARIANTS = {
    "chatglm3-6b": ("chatglm3-6b", {}),
    "minitron-4b": ("minitron-4b", {}),
    "qwen1.5-32b": ("qwen1.5-32b", {}),
    "chatglm3-6b-g16": ("chatglm3-6b", dict(n_heads=16, n_kv_heads=1)),
    "minitron-4b-g3": ("minitron-4b", dict(n_heads=6, n_kv_heads=2)),
}
KV = {"f32": (jnp.float32, torch.float32),
      "bf16": (jnp.bfloat16, torch.bfloat16),
      "int8": (jnp.int8, torch.int8), "int4": ("int4", "int4")}
REC_TOL = 1e-4


def _configs(name, **extra):
    arch, fields = VARIANTS[name]
    fields = dict(fields, **extra)
    return (dataclasses.replace(jget_config(arch).reduced(), **fields),
            dataclasses.replace(get_config(arch).reduced(), **fields))


def _with_biases(params, seed):
    """JAX params whose wq/wk/wv biases hold seeded values (JAX's init
    leaves them zero)."""
    rng = np.random.default_rng(seed)
    mixer = params["groups"]["p0"]["mixer"]
    for n in ("wq", "wk", "wv"):
        if "b" in mixer[n]:
            b = mixer[n]["b"]
            mixer[n]["b"] = jnp.asarray(
                rng.standard_normal(b.shape).astype(np.float32) * 0.5)
    return params


def _jptq(k=3, rank=8, **kw):
    return JPTQConfig(method="srr", rank=rank, exact_svd=True, forced_k=k,
                      quantizer=QuantizerConfig(kind="mxint", bits=3,
                                                block_size=32), **kw)


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


# ---------------------------------------------------------------------------
# (a) half RoPE
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["full", "half", "none"])
@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_apply_rope_matches_jax(kind, theta):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 4000, (2, 7)).astype(np.int32)
    want = np.asarray(japply_rope(jnp.asarray(x), jnp.asarray(pos), theta,
                                  kind))
    got = apply_rope(_t(x), _t(pos), theta, kind).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    if kind == "half":                        # the second half untouched
        assert np.array_equal(got[..., 8:], x[..., 8:])
        assert not np.allclose(got[..., :8], x[..., :8])


# ---------------------------------------------------------------------------
# (b) K3/K5's plain versions at G = 16 and G = 3
# ---------------------------------------------------------------------------
def _decode_inputs(kind, g, rng, lead, kvh=2, s=48, hd=16):
    """q (3, kvh, g, hd) and k/v of leading shape ``lead`` (rows or pages)
    in ``kind``'s container, with their scales."""
    q = rng.standard_normal((3, kvh, g, hd)).astype(np.float32)
    k = rng.standard_normal((lead, kvh, s, hd)).astype(np.float32)
    v = rng.standard_normal((lead, kvh, s, hd)).astype(np.float32)
    ks = vs = None
    if kind in ("int8", "int4"):
        hi = 128 if kind == "int8" else 8
        k = rng.integers(-hi + 1, hi, k.shape).astype(np.int8)
        v = rng.integers(-hi + 1, hi, v.shape).astype(np.int8)
        ks = rng.uniform(0.01, 0.1, (lead, kvh, s)).astype(np.float32)
        vs = rng.uniform(0.01, 0.1, (lead, kvh, s)).astype(np.float32)
        if kind == "int4":
            k = np.asarray(jpack_codes_4bit(jnp.asarray(k)))
            v = np.asarray(jpack_codes_4bit(jnp.asarray(v)))
    elif kind == "bf16":
        k = np.asarray(jnp.asarray(k, jnp.bfloat16))
        v = np.asarray(jnp.asarray(v, jnp.bfloat16))
    return q, k, v, ks, vs


def _kv_t(a):
    if a is None:
        return None
    if a.dtype == jnp.bfloat16:
        return _t(a.astype(np.float32)).to(torch.bfloat16)
    return _t(a)


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8", "int4"])
@pytest.mark.parametrize("g", [16, 3])
@pytest.mark.parametrize("paged", [False, True], ids=["slots", "paged"])
def test_decode_plain_at_wide_groups_matches_jax(kind, g, paged):
    """Rows valid to their last slot, partly and not at all (zeros), a
    window on the paged case; unpaged over (3, 2, 48) slots, paged over a
    shuffled table of 6 pages of 8."""
    rng = np.random.default_rng(g + 7 * paged)
    ps, nb, pages = 8, 6, 20
    window = 9 if paged else 0
    q, k, v, ks, vs = _decode_inputs(kind, g, rng, pages if paged else 3,
                                     s=ps if paged else 48)
    s = nb * ps if paged else 48
    q_pos = np.array([s - 1, 17, 30], np.int32)
    k_pos = np.tile(np.arange(s, dtype=np.int32), (3, 1))
    k_pos[1, 20:] = -1
    k_pos[2] = -1                                    # an empty row → zeros
    bt = rng.permutation(pages)[:3 * nb].reshape(3, nb).astype(np.int32) \
        if paged else None
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    want = np.asarray(jops.decode_attention_op(
        j(q), j(k), j(v), j(q_pos), j(k_pos), k_scale=j(ks), v_scale=j(vs),
        window=window, kernel=True, block_table=j(bt)))
    oracle = np.asarray(decode_attention_ref(
        j(q), j(k), j(v), j(q_pos), j(k_pos), j(ks), j(vs), window=window,
        block_table=j(bt)))
    got = decode_attention_op(
        _t(q), _kv_t(k), _kv_t(v), _t(q_pos), _t(k_pos), k_scale=_kv_t(ks),
        v_scale=_kv_t(vs), window=window,
        block_table=None if bt is None else _t(bt)).numpy()
    assert got.shape == (3, 2, g, 16)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    np.testing.assert_allclose(got, oracle, rtol=0, atol=2e-5)
    assert np.all(got[2] == 0.0)


@pytest.mark.parametrize("g,blocks", [(1, 1), (3, 1), (8, 1), (9, 2),
                                      (16, 2)])
def test_wide_groups_split_across_blocks(g, blocks):
    assert group_blocks(g) == blocks


# ---------------------------------------------------------------------------
# (c) model logits, per arch
# ---------------------------------------------------------------------------
# each variant at one KV container, so every container runs once
MODEL_KV = {"chatglm3-6b": "int8", "minitron-4b": "bf16", "qwen1.5-32b": "f32",
            "chatglm3-6b-g16": "int4", "minitron-4b-g3": "f32"}


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    """Many small ops: two intra-op threads, as in
    ``tests/test_torch_train.py``; restored after the module."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def quantized(request):
    """(name, JAX config, SRR-quantized JAX params with seeded biases, the
    converted port model)."""
    jcfg, cfg = _configs(request.param)
    params = _with_biases(jinit_lm(jax.random.PRNGKey(3), jcfg), 1)
    qparams, _ = jquantize(params, None, _jptq())
    model = convert_params(jax.tree_util.tree_map(np.asarray, qparams), cfg,
                           device="cpu")
    return request.param, jcfg, qparams, model


@pytest.mark.parametrize("fused", ["on", "auto"])
def test_prefill_and_decode_logits_match_jax(quantized, fused):
    name, jcfg, qparams, model = quantized
    kv = MODEL_KV[name]
    jdt, tdt = KV[kv]
    tol = 2e-3 if kv == "bf16" else 1e-4
    if jcfg.qkv_bias:
        assert model.blocks[0].mixer.wk.b.abs().max() > 0
    rng = np.random.default_rng(3)
    toks = rng.integers(0, jcfg.vocab, (2, 16)).astype(np.int32)
    lengths = np.array([16, 9], np.int32)
    jctx = JCtx(fused=fused)
    jctx.use_pallas = fused == "on"
    jpre = jax.jit(lambda p, t, c, n: jprefill(jctx, p, {"tokens": t}, jcfg,
                                               c, lengths=n))
    jdec = jax.jit(lambda p, t, c: jdecode_step(jctx, p, t, c, jcfg))
    jl, jc = jpre(qparams, jnp.asarray(toks),
                  jinit_cache(jcfg, 2, 24, dtype=jdt), jnp.asarray(lengths))
    ctx = Ctx(fused=fused)
    tl, tc = prefill(ctx, model, _t(toks).long(),
                     init_cache(model.cfg, 2, 24, tdt, "cpu"),
                     lengths=_t(lengths))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=tol)
    for _ in range(3):
        tok = np.argmax(np.asarray(jl)[:, -1], -1)[:, None].astype(np.int32)
        jl, jc = jdec(qparams, jnp.asarray(tok), jc)
        tl, tc = decode_step(ctx, model, _t(tok).long(), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=tol)


# ---------------------------------------------------------------------------
# (d) greedy engine tokens, unpaged and paged
# ---------------------------------------------------------------------------
def _requests(cls, vocab):
    rng = np.random.default_rng(5)
    head = rng.integers(0, vocab, 8).astype(np.int32)
    return [cls(uid=i, prompt=np.concatenate(
        [head, rng.integers(0, vocab, 3 + 4 * i).astype(np.int32)]),
        max_new_tokens=(6, 3, 0, 5, 4)[i]) for i in range(5)]


@pytest.mark.parametrize("name", ["chatglm3-6b", "qwen1.5-32b"])
@pytest.mark.parametrize("paged", [False, True], ids=["unpaged", "paged"])
def test_engine_greedy_tokens_identical_to_jax(name, paged):
    jcfg, cfg = _configs(name)
    params = _with_biases(jinit_lm(jax.random.PRNGKey(2), jcfg), 2)
    qparams, _ = jquantize(params, None, _jptq())
    model = convert_params(jax.tree_util.tree_map(np.asarray, qparams), cfg,
                           device="cpu")
    # paged: prompts of 11–27 tokens in 16-wide chunks over pages of 8
    sc = dict(max_len=48, decode_batch=3, prefill_len=16 if paged else 32,
              kv_dtype="bf16")
    if paged:
        sc.update(paged=True, page_size=8)
    want = JEngine(qparams, jcfg, JServeConfig(**sc)).generate(
        _requests(JRequest, jcfg.vocab))
    eng = Engine(model, cfg, ServeConfig(**sc), device="cpu")
    got = eng.generate(_requests(Request, jcfg.vocab))
    assert [g.uid for g in got] == [w.uid for w in want]
    assert [g.tokens.tolist() for g in got] == \
        [w.tokens.tolist() for w in want]
    assert sum(len(g.tokens) for g in got) == 18
    if paged:
        assert eng.stats()["prefix_hit_tokens"] > 0


# ---------------------------------------------------------------------------
# (e) calibrate → qera-exact SRR, the one-layer chatglm
# ---------------------------------------------------------------------------
def _dequant(codes, scale, m):
    return dequant_blockwise(_t(codes), _t(scale), torch.float32)[:m].numpy()


def _container_close(got, want, w, k):
    """Scales and gscale equal, the preserved part within REC_TOL · max|W|;
    codes equal but for at most two a step off at a rounding tie of JAX's
    quantizer input; Q + LR within REC_TOL · max|W|, or within twice the
    flipped steps (Frobenius) where a code flipped."""
    m = w.shape[0]
    scale = np.asarray(want["scale"])
    assert np.array_equal(got["scale"], scale)
    assert np.array_equal(got["gscale"], np.asarray(want["gscale"]))
    jl, jr = np.asarray(want["l"]), np.asarray(want["r"])
    jpreserved = jl[:, :k] @ jr[:k]
    np.testing.assert_allclose(got["l"][:, :k] @ got["r"][:k], jpreserved,
                               rtol=0, atol=REC_TOL * float(np.abs(w).max()))
    codes, jcodes = got["codes"], np.asarray(want["codes"])
    rec = _dequant(codes, scale, m) + got["l"] @ got["r"]
    jrec = _dequant(jcodes, scale, m) + jl @ jr
    diff = codes != jcodes
    if not diff.any():
        np.testing.assert_allclose(rec, jrec, rtol=0,
                                   atol=REC_TOL * float(np.abs(w).max()))
        return
    step = np.repeat(scale, 32, axis=0)[:m]
    assert diff.sum() <= 2
    assert np.abs(codes.astype(int) - jcodes)[diff].max() == 1
    v = (w - jpreserved) / step
    assert np.all(np.abs(np.abs(v[diff[:m]]) % 1 - 0.5) < 1e-3), \
        "a code differs away from a rounding tie"
    assert np.linalg.norm(rec - jrec) <= 2 * np.linalg.norm(step[diff[:m]])


def test_calibrated_srr_pass_matches_jax():
    """One-layer reduced chatglm with seeded biases: the port calibrates
    its converted model itself (tap names and counts equal JAX's, moments
    within 2e-6 of their largest entry), then quantizes under qera-exact
    with exact SVDs and k forced to 3; every container agrees with JAX's
    pass over JAX's own calibration (one layer, so JAX's layer-0 lookup
    is the layer's own)."""
    jcfg, cfg = _configs("chatglm3-6b", n_layers=1)
    params = _with_biases(jinit_lm(jax.random.PRNGKey(0), jcfg), 3)
    tree = jax.tree_util.tree_map(np.asarray, params)
    jstats = jcapture(params, jcfg, jdata_config_for(jcfg, 32, 4, 0),
                      lambda c, p, b, cc: jlm_loss(c, p, b, cc), n_batches=2)
    model = convert_params(tree, cfg, device="cpu")
    stats = capture_calibration(model, data_config_for(cfg, 32, 4, 0),
                                lm_loss, n_batches=2, device="cpu")
    assert sorted(stats) == sorted(jstats)
    for key, st in stats.items():
        js = jstats[key]
        assert st.count == int(float(js.count))
        for mine, theirs in ((st.sum_sq, js.sum_sq),
                             (st.autocorr, js.autocorr)):
            theirs = np.asarray(theirs)
            np.testing.assert_allclose(mine.numpy(), theirs, rtol=0,
                                       atol=2e-6 * float(np.abs(theirs).max()))
    jq, _ = jquantize(params, jstats, _jptq(scaling="qera-exact"))
    want = jax.tree_util.tree_map(np.asarray, jq["groups"]["p0"])
    model, reports = quantize_model_params(
        model, PTQConfig(method="srr", scaling="qera-exact", rank=8,
                         exact_svd=True, forced_k=3), stats=stats,
        device="cpu")
    assert len(reports) == 7 and all(r.k_star == 3 for r in reports)
    group = tree["groups"]["p0"]
    for mod, names in (("mixer", ("wq", "wk", "wv", "wo")),
                       ("mlp", ("up", "gate", "down"))):
        for n in names:
            p = getattr(getattr(model.blocks[0], mod), n)
            got = {f: getattr(p, f).numpy() for f in
                   ("codes", "scale", "l", "r", "gscale")}
            _container_close(got, {f: want[mod][n][f][0] for f in got},
                             group[mod][n]["w"][0], 3)
            if "b" in group[mod][n]:                 # the bias rides along
                assert np.array_equal(p.b.numpy(), group[mod][n]["b"][0])


# ---------------------------------------------------------------------------
# qwen1.5-32b's 27,392-wide down input: qera-exact by R's range
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("m,rows", [(96, 40), (128, 100), (64, 63)])
def test_range_scaling_matches_eigh_and_jax(m, rows):
    """The range route (the card's for widths its eigh refuses, when R
    averages fewer samples than its width) against an f64 eigh of the
    same R (1e-6 of each matrix's largest entry: the f32 result's
    rounding) and against JAX's f32 eigh route (S to 1e-5, S⁻¹ to 2e-4:
    JAX's own f32 error, which the f64 comparison does not have, grows
    near the eigenvalue floor)."""
    rng = np.random.default_rng(m + rows)
    x = rng.standard_normal((rows, m)) * np.exp(rng.standard_normal(m))
    x[:, 3] *= 8.0
    r = torch.from_numpy((x.T @ x / rows).astype(np.float32))
    got = range_autocorr_scaling(r, rows)
    r64 = 0.5 * (r.double() + r.double().T)
    evals, evecs = torch.linalg.eigh(r64)
    half = torch.maximum(evals, 1e-4 * evals[-1]).sqrt()
    jax_s = jautocorr_scaling(jnp.asarray(r.numpy()))
    for mine, exact, theirs, tol in (
            (got.dense, (evecs * half) @ evecs.T, jax_s.dense, 1e-5),
            (got.dense_inv, (evecs / half) @ evecs.T, jax_s.dense_inv, 2e-4)):
        assert mine.dtype == torch.float32
        scale = float(exact.abs().max())
        assert float((mine.double() - exact).abs().max()) <= 1e-6 * scale
        np.testing.assert_allclose(mine.numpy(), np.asarray(theirs), rtol=0,
                                   atol=tol * scale)


# ---------------------------------------------------------------------------
# (f) what the port admits
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", DENSE)
def test_dense_variants_registered_and_admitted(name, monkeypatch):
    cfg = ARCHS[name]
    jcfg = jget_config(name)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    check_supported(cfg)
    model = init_lm(cfg.reduced(), 0, device="cpu")
    red = cfg.reduced()
    mixer = model.blocks[0].mixer
    for p, heads in ((mixer.wq, red.n_heads), (mixer.wk, red.n_kv_heads),
                     (mixer.wv, red.n_kv_heads)):
        if cfg.qkv_bias:               # JAX's init_linear(..., bias=True)
            assert p.b.shape == (heads * red.head_dim_,)
            assert torch.all(p.b == 0)
        else:
            assert p.b is None
    assert mixer.wo.b is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        init_lm(cfg.reduced(), 0)


@pytest.mark.parametrize("change", [
    dict(rope_kind="none"), dict(attn_kind="mla"),
    dict(block_pattern=("attn", "mlstm")), dict(act="gelu"),
    dict(norm="layernorm"), dict(enc_layers=2)])
def test_check_supported_rejects_the_rest(change):
    cfg = dataclasses.replace(get_config("chatglm3-6b").reduced(), **change)
    with pytest.raises(NotImplementedError):
        check_supported(cfg)
