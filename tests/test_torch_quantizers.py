"""Port parity: the quantizer substrate beside MXINT — ``QuantizerConfig``
and ``make_quantizer``, the uniform group quantizer, the GPTQ-style
quantizer — against the JAX package on the CPU.

The uniform quantizer is held to JAX's functions as the JAX package
runs them (eagerly: its ``quantize_layer`` calls them op by op): codes,
scales, zeros, the dequantized and the fake-quantized values bit for
bit, symmetric and asymmetric, over drawn shapes whose row count is not
a multiple of the group. (Under ``jax.jit`` XLA rewrites ``amax / qmax``
into ``amax · (1/qmax)``, a scale one ulp off the division.)

GPTQ: ``_cholesky_inv_upper`` within 1e-5 of max|U| (two LAPACK
inverses and Choleskys in f32); the row loop given JAX's U and group
scales, computed as JAX's jitted quantizer computes them, bit for bit
symmetric and within 2 ulps of max|W| asymmetric: inside JAX's jitted
loop XLA fuses the asymmetric dequantization ``c·s + z`` into one
multiply-add, rounded once, where the port rounds the product and the
sum apart, as JAX's source reads (a loop that rounds the two once
matches JAX bit for bit).

``quantize_layer`` under SRR with a forced k and exact SVDs: k* as
JAX's, the reconstruction Q + LR within 1e-4 of max|W| and Q within
1e-5 of it (the preserved part agrees to f32 noise, and a uniform scale,
unlike MXINT's power of two, carries that noise into every element), the
scaled error within 1e-5 relative.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core.api import CalibStats as JCalibStats
from repro.core.api import PTQConfig as JPTQConfig
from repro.core.api import quantize_layer as jquantize_layer
from repro.quant import QuantizerConfig as JQuantizerConfig
from repro.quant import effective_bits as jeffective_bits
from repro.quant import hessian_from_activations as jhessian
from repro.quant import make_quantizer as jmake_quantizer
from repro.quant import quant_error as jquant_error
from repro.quant import tree_bytes as jtree_bytes
from repro.quant.gptq import GPTQQuantizer as JGPTQ
from repro.quant.gptq import _cholesky_inv_upper as jcholesky_inv_upper
from repro.quant.uniform import UniformQuantizer as JUniform
from repro_torch.configs import get_config
from repro_torch.core.api import CalibStats, PTQConfig, quantize_layer
from repro_torch.models import init_lm
from repro_torch.models import quantize as port_quantize
from repro_torch.models.quantize import quantize_model_params
from repro_torch.obs import QuantRecorder
from repro_torch.quant import (BoundGPTQ, GPTQQuantizer, MXIntQuantizer,
                               QuantizerConfig, UniformQuantizer,
                               effective_bits, hessian_from_activations,
                               make_quantizer, quant_error, tree_bytes)
from repro_torch.quant.gptq import _cholesky_inv_upper, gptq_rows

U_TOL = 1e-5
REC_TOL = 1e-4
Q_TOL = 1e-5
ERR_TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    """Small ops in loops: two intra-op threads, as in
    ``tests/test_torch_train.py``; restored after the module."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _weights(m, n, seed, zero_group=None, g=1):
    """N(0, σ²) weights at a drawn scale; ``zero_group`` blanks one group
    (JAX's ``amax > 0`` / ``rng > 0`` guards)."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((m, n)) * np.exp(rng.standard_normal())
    if zero_group is not None:
        lo = (zero_group * g) % max(m, 1)
        w[lo:lo + g] = 0.0
    return w.astype(np.float32)


def _acts(m, n=200, seed=7):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, m)) * np.exp(rng.standard_normal(m) * 0.5)
    return x.astype(np.float32)


# ---------------------------------------------------------------------------
# the uniform group quantizer
# ---------------------------------------------------------------------------
@settings(max_examples=25, deadline=None, derandomize=True)
@given(m=st.sampled_from([7, 70]), g=st.sampled_from([8, 32]),
       bits=st.sampled_from([2, 3, 4, 8]), symmetric=st.booleans(),
       seed=st.integers(0, 2 ** 16), blank=st.booleans())
def test_uniform_matches_jax(m, g, bits, symmetric, seed, blank):
    """7 or 70 rows of 5 (two shapes, so that JAX's eager ops compile
    once a shape; neither a multiple of the group), groups of 8 and 32,
    2–8 bits, one group blanked or none."""
    n = 5
    w = _weights(m, n, seed, zero_group=seed if blank else None, g=g)
    jq, q = JUniform(bits, g, symmetric), UniformQuantizer(bits, g, symmetric)
    jp, p = jq.quantize(jnp.asarray(w)), q.quantize(_t(w))
    assert p.codes.dtype == torch.int8
    assert (p.group_size, p.bits, p.orig_rows) == (g, bits, m)
    assert p.codes.shape == (m + (-m) % g, n)
    for name in ("codes", "scales", "zeros"):
        assert np.array_equal(getattr(p, name).numpy(),
                              np.asarray(getattr(jp, name))), name
    assert np.array_equal(q.dequantize(p).numpy(),
                          np.asarray(jq.dequantize(jp)))
    assert np.array_equal(q.fake_quant(_t(w)).numpy(),
                          np.asarray(jq.fake_quant(jnp.asarray(w))))
    assert np.array_equal(
        q.round_with_scales(_t(w), p.scales, p.zeros).numpy(),
        np.asarray(jq.round_with_scales(jnp.asarray(w), jp.scales,
                                        jp.zeros)))
    assert np.array_equal(quant_error(q, _t(w)).numpy(),
                          np.asarray(jquant_error(jq, jnp.asarray(w))))
    assert tree_bytes(p) == jtree_bytes(jp)


def test_uniform_codes_stay_in_range():
    """Symmetric codes in [−2^(b−1), 2^(b−1) − 1]; asymmetric codes
    recentred from [0, 2^b − 1] by −2^(b−1), the zero point shifted by
    scale · 2^(b−1) to match; a blank group takes scale 1 and zero 0."""
    w = _weights(40, 6, 3, zero_group=1, g=8)
    for symmetric in (True, False):
        p = UniformQuantizer(3, 8, symmetric).quantize(_t(w))
        assert int(p.codes.min()) >= -4 and int(p.codes.max()) <= 3
        assert bool((p.scales[1] == 1.0).all())
        assert bool((p.zeros[1] == (0.0 if symmetric else 4.0)).all())


# ---------------------------------------------------------------------------
# GPTQ
# ---------------------------------------------------------------------------
M, N, G = 40, 24, 16


@pytest.fixture(scope="module")
def hessian():
    x = _acts(M)
    return x, np.asarray(jhessian(jnp.asarray(x)))


def test_hessian_and_cholesky_match_jax(hessian):
    """H = XᵀX / N, and the upper U with H⁻¹ = UᵀU after the damping,
    within ``U_TOL`` of max|U|."""
    x, h = hessian
    got = hessian_from_activations(_t(x))
    np.testing.assert_allclose(got.numpy(), h, rtol=0,
                               atol=1e-6 * np.abs(h).max())
    want = np.asarray(jcholesky_inv_upper(jnp.asarray(h), 0.01))
    u = _cholesky_inv_upper(_t(h), 0.01)
    assert bool((u.tril(-1) == 0).all())
    np.testing.assert_allclose(u.numpy(), want, rtol=0,
                               atol=U_TOL * np.abs(want).max())
    hinv = np.linalg.inv(h.astype(np.float64) + (0.01 * np.diag(h).mean()
                                                 + 1e-8) * np.eye(M))
    np.testing.assert_allclose((u.T @ u).double().numpy(), hinv, rtol=0,
                               atol=U_TOL * np.abs(hinv).max())


@pytest.mark.parametrize("symmetric", [True, False],
                         ids=["symmetric", "asymmetric"])
def test_gptq_rows_match_jax(hessian, symmetric):
    """The row loop given JAX's U and group scales (each as JAX's jitted
    ``fake_quant_with_hessian`` computes it) against that function: bit
    for bit symmetric, within 2 ulps of max|W| asymmetric (the module
    docstring says why). A row count not a multiple of the group."""
    _, h = hessian
    w = _weights(M, N, 11)
    jg = JGPTQ(bits=3, group_size=G, symmetric=symmetric, damping=0.01)
    want = np.asarray(jg.fake_quant_with_hessian(jnp.asarray(w),
                                                 jnp.asarray(h)))
    uinv = jax.jit(jcholesky_inv_upper, static_argnums=1)(jnp.asarray(h),
                                                          0.01)
    base = jax.jit(JUniform(3, G, symmetric).quantize)(jnp.asarray(w))
    got = gptq_rows(_t(w), _t(uinv), _t(base.scales), _t(base.zeros), 3, G,
                    symmetric).numpy()
    if symmetric:
        assert np.array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=2 * np.spacing(np.abs(want).max()))
    # the port's own pass: its U and scales, one step of the grid
    own = GPTQQuantizer(3, G, symmetric, 0.01).fake_quant_with_hessian(
        _t(w), _t(h)).numpy()
    np.testing.assert_allclose(own, want, rtol=0,
                               atol=2 * np.spacing(np.abs(want).max()))


def test_bound_gptq_beats_round_to_nearest(hessian):
    """``make_quantizer`` binds the Hessian: the bound quantizer's proxy
    error tr((W − Q)ᵀ H (W − Q)) is below uniform round-to-nearest's with
    the same group scales; ``quantize`` / ``dequantize`` store its output
    in the uniform container, as JAX's ``BoundGPTQ`` does."""
    _, h = hessian
    w = _t(_weights(M, N, 12))
    cfg = QuantizerConfig(kind="gptq", bits=3, block_size=G)
    gq = make_quantizer(cfg, _t(h))
    rtn = make_quantizer(dataclasses.replace(cfg, kind="uniform"))
    assert isinstance(gq, BoundGPTQ) and isinstance(rtn, UniformQuantizer)

    def proxy(q):
        e = (w - q).double()
        return float(torch.trace(e.T @ _t(h).double() @ e))

    assert proxy(gq.fake_quant(w)) < proxy(rtn.fake_quant(w))
    p = gq.quantize(w)
    np.testing.assert_array_equal(gq.dequantize(p).numpy(),
                                  rtn.fake_quant(gq.fake_quant(w)).numpy())
    jq = jmake_quantizer(JQuantizerConfig(kind="gptq", bits=3, block_size=G),
                         jnp.asarray(h))
    assert gq.effective_bits == jq.effective_bits == 3 + 16 / G


# ---------------------------------------------------------------------------
# the config, the factory, effective bits
# ---------------------------------------------------------------------------
KINDS = [dict(kind="mxint"), dict(kind="uniform"),
         dict(kind="uniform", symmetric=False, block_size=128),
         dict(kind="gptq", bits=4), dict(kind="gptq", symmetric=False),
         dict(kind="none")]


@pytest.mark.parametrize("kw", KINDS, ids=lambda kw: "-".join(
    str(v) for v in kw.values()))
def test_config_and_effective_bits_match_jax(kw):
    """Field for field JAX's config (defaults, ``key()``), and
    ``effective_bits`` equal to JAX's; a built quantizer's
    ``effective_bits`` is its config's."""
    cfg, jcfg = QuantizerConfig(**kw), JQuantizerConfig(**kw)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.key() == jcfg.key()
    assert effective_bits(cfg) == jeffective_bits(jcfg)
    if cfg.kind in ("mxint", "uniform"):
        assert make_quantizer(cfg).effective_bits == effective_bits(cfg)


def test_make_quantizer_types_and_errors_match_jax():
    """mxint → ``MXIntQuantizer``, uniform → ``UniformQuantizer`` (group
    = block size), gptq + Hessian → ``BoundGPTQ``; gptq without a Hessian
    and an unknown kind raise JAX's errors, as ``effective_bits`` of an
    unknown kind does."""
    mx = make_quantizer(QuantizerConfig(bits=4, block_size=16))
    assert mx == MXIntQuantizer(bits=4, block_size=16)
    assert make_quantizer(QuantizerConfig(kind="uniform", symmetric=False)) \
        == UniformQuantizer(bits=3, group_size=32, symmetric=False)
    for kw in (dict(kind="gptq"), dict(kind="fp8"), dict(kind="none")):
        with pytest.raises(ValueError) as jerr:
            jmake_quantizer(JQuantizerConfig(**kw))
        with pytest.raises(ValueError) as err:
            make_quantizer(QuantizerConfig(**kw))
        assert str(err.value) == str(jerr.value)
    with pytest.raises(ValueError) as jerr:
        jeffective_bits(JQuantizerConfig(kind="fp8"))
    with pytest.raises(ValueError) as err:
        effective_bits(QuantizerConfig(kind="fp8"))
    assert str(err.value) == str(jerr.value)


def test_ptq_config_default_is_jax():
    """``PTQConfig.quantizer`` defaults to JAX's (mxint, 3, 32)."""
    assert dataclasses.asdict(PTQConfig().quantizer) == \
        dataclasses.asdict(JPTQConfig().quantizer)
    assert PTQConfig().quantizer == QuantizerConfig(kind="mxint", bits=3,
                                                    block_size=32)


# ---------------------------------------------------------------------------
# quantize_layer and the model-level pass
# ---------------------------------------------------------------------------
def _planted(m=64, n=96, seed=0):
    rng = np.random.default_rng(seed)
    u, v = rng.standard_normal((m, 6)), rng.standard_normal((6, n))
    return (u @ v * 0.2 + rng.standard_normal((m, n)) * 0.02
            ).astype(np.float32)


@pytest.mark.parametrize("kind,symmetric", [("uniform", True),
                                            ("uniform", False),
                                            ("gptq", True)])
def test_quantize_layer_srr_matches_jax(kind, symmetric):
    """SRR (rank 8, k forced to 3, exact SVDs) under the qera-approx
    scaling of the same activations with a uniform and a bound-GPTQ
    quantizer (3 bits, groups of 16, the Hessian of those activations),
    handed in as ``quantizer=`` and, for uniform, built from
    ``cfg.quantizer``: k*, Q, Q + LR and the scaled error against JAX's
    ``quantize_layer``."""
    w, x = _planted(), _acts(64, 300)
    qc = dict(kind=kind, bits=3, block_size=16, symmetric=symmetric)
    common = dict(method="srr", scaling="qera-approx", rank=8,
                  exact_svd=True, forced_k=3)
    jcfg = JPTQConfig(quantizer=JQuantizerConfig(**qc), **common)
    cfg = PTQConfig(quantizer=QuantizerConfig(**qc), **common)
    h = x.T @ x / x.shape[0]
    jq = jmake_quantizer(jcfg.quantizer, jnp.asarray(h))
    jd, jr = jquantize_layer("x", jnp.asarray(w),
                             JCalibStats.init(64).update(jnp.asarray(x)),
                             jcfg, jax.random.PRNGKey(0), quantizer=jq)
    stats = CalibStats.init(64).update(_t(x))
    runs = [make_quantizer(cfg.quantizer, _t(h))]
    if kind == "uniform":
        runs.append(None)
    for quantizer in runs:
        d, r = quantize_layer("x", _t(w), cfg, None, stats,
                              quantizer=quantizer)
        assert d.k == jd.k == 3
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(d.q.numpy(), np.asarray(jd.q), rtol=0,
                                   atol=Q_TOL * scale)
        np.testing.assert_allclose(d.reconstruct().numpy(),
                                   np.asarray(jd.reconstruct()), rtol=0,
                                   atol=REC_TOL * scale)
        assert abs(r.scaled_err - jr.scaled_err) <= ERR_TOL * jr.scaled_err


def test_model_pass_packs_mxint_whatever_the_kind(monkeypatch):
    """The model-level pass decomposes with ``cfg.quantizer`` (a uniform
    Q here) and packs the container as MXINT at its bits and block size,
    as JAX's pass does (ROADMAP §3); the quant report names the kind; a
    GPTQ config raises JAX's error, since the pass binds no Hessian."""
    seen = {}
    real = port_quantize.quantize_layer

    def spy(name, w, cfg, gen, st, recorder=None):
        dec, rep = real(name, w, cfg, gen, st, recorder=recorder)
        seen[name] = dec
        return dec, rep

    monkeypatch.setattr(port_quantize, "quantize_layer", spy)
    cfg = get_config("phi3-mini-3.8b").reduced()
    qc = QuantizerConfig(kind="uniform", bits=3, block_size=32)
    rec = QuantRecorder()
    model, reports = quantize_model_params(
        init_lm(cfg, 0, device="cpu"),
        PTQConfig(method="srr", scaling="identity", quantizer=qc, rank=4,
                  exact_svd=True), recorder=rec, device="cpu")
    assert len(reports) == len(seen) == 14
    p = model.blocks[1].mlp.down
    packed = MXIntQuantizer(bits=3, block_size=32).quantize(
        seen["blocks.1.mlp.down"].q)
    assert torch.equal(p.codes, packed.codes)
    assert torch.equal(p.scale, torch.exp2(packed.exponents.float()))
    report = rec.build_report()
    assert report["config"]["quantizer"] == "uniform"
    assert report["config"]["bits"] == 3
    # the records' bits are the uniform quantizer's (3 + 16/32), not
    # MXINT's (3 + 8/32): the decomposition ran under uniform
    assert {r["bits"] for r in report["layers"].values()} == {3 + 16 / 32}
    with pytest.raises(ValueError, match="needs a calibration Hessian"):
        quantize_model_params(
            init_lm(cfg, 0, device="cpu"),
            PTQConfig(quantizer=QuantizerConfig(kind="gptq"), rank=4),
            device="cpu")
