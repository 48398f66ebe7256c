"""Port parity: xlstm-125m's stack (mLSTM and sLSTM blocks, LayerNorm, no
RoPE) against the JAX package on the CPU.

The reduced config keeps the family's structure: 4 layers of (mlstm,
slstm) × 2, d 64, 4 heads (mLSTM hd 32 over dp 128; sLSTM hd 16), the
sLSTM FFN 85 wide (so its ``ffn_down`` has MXINT padding rows and
``ffn_up`` an N that is not a multiple of 4), vocabulary 256. Weights
come from seeded JAX inits (fp, or through JAX's SRR pass) converted to
the port, with the ``w_if``/``w_gates`` biases and the LayerNorm shifts
filled from a numpy seed so that those paths carry real values; inputs
from numpy seeds. JAX's Pallas Q+LR kernels run in interpret mode
(``fused="on"``), as its own tests run them, against the port's plain
versions.

Tolerances: the mixers' outputs and states 1e-5 of their largest
magnitude, or absolute below 1 (f32; the parallel form's and the
closed-form fold's sums run in another order than JAX's einsums and
scan, ulp-level: observed up to 1.5e-6 relative where a small
normaliser makes the output large); LayerNorm 1e-6; logits 1e-4;
greedy tokens identical; calibration moments 1e-5 of their largest
entry.
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
from repro.models.layers import norm as jnorm
from repro.models.quantize import _stats_for as jstats_for
from repro.models.quantize import quantize_model_params as jquantize
from repro.models.xlstm import _mlstm_fold as jmlstm_fold
from repro.models.xlstm import _mlstm_parallel as jmlstm_parallel
from repro.models.xlstm import init_mlstm_cache as jinit_mlstm_cache
from repro.models.xlstm import init_slstm_cache as jinit_slstm_cache
from repro.models.xlstm import mlstm_seq as jmlstm_seq
from repro.models.xlstm import mlstm_step as jmlstm_step
from repro.models.xlstm import slstm_seq as jslstm_seq
from repro.models.xlstm import slstm_step as jslstm_step
from repro.quant.base import QuantizerConfig
from repro.serve import Engine as JEngine
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro_torch.configs import ARCHS, get_config
from repro_torch.convert import convert_params
from repro_torch.core.api import PTQConfig
from repro_torch.data import capture_calibration, data_config_for
from repro_torch.models import (Ctx, decode_step, init_cache, init_lm,
                                lm_loss, prefill, prefill_chunk)
from repro_torch.models import quantize as port_quantize
from repro_torch.models.attention import (restore_step_writes,
                                          save_step_writes)
from repro_torch.models.layers import LayerNorm, layernorm
from repro_torch.models.linear import FpLinear, QLinear
from repro_torch.models.quantize import quantize_model_params
from repro_torch.models.transformer import check_supported, kind_at
from repro_torch.models.xlstm import (MLSTM, MLSTM_PROJECTIONS, SLSTM,
                                      SLSTM_PROJECTIONS, _mlstm_fold,
                                      _mlstm_parallel, init_mlstm_cache,
                                      init_slstm_cache, mlstm_seq,
                                      mlstm_step, slstm_seq, slstm_step)
from repro_torch.serve import Engine, Request, ServeConfig
from repro_torch.serve.sanitizer import SanitizerError

ARCH = "xlstm-125m"
LOGIT_TOL = 1e-4
STATE_TOL = 1e-5
NORM_TOL = 1e-6
MOMENT_TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _seed_biases(tree, seed):
    """Fill the ``w_if`` and ``w_gates`` biases and every LayerNorm shift
    of a numpy tree from a seed (JAX's init makes them zero)."""
    rng = np.random.default_rng(seed)
    groups = tree["groups"]
    for pos, name in (("p0", "w_if"), ("p1", "w_gates")):
        b = groups[pos]["mixer"][name]["b"]
        groups[pos]["mixer"][name]["b"] = (
            rng.standard_normal(b.shape) * 0.5).astype(np.float32)
    for node in [groups["p0"]["norm1"], groups["p1"]["norm1"],
                 tree["final_norm"]]:
        node["b"] = (rng.standard_normal(node["b"].shape) * 0.1
                     ).astype(np.float32)
    return tree


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
    """(JAX config, JAX fp params with seeded biases, the converted
    model) of the reduced config."""
    jcfg, cfg = jget_config(ARCH).reduced(), get_config(ARCH).reduced()
    init = jax.jit(jinit_lm, static_argnums=1)
    tree = _seed_biases(_tree(init(jax.random.PRNGKey(3), jcfg)), 7)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    return jcfg, params, convert_params(tree, cfg, device="cpu")


def _layer(params, i):
    """Layer ``i``'s JAX block tree (group i // 2, pattern position
    i % 2)."""
    return jax.tree_util.tree_map(lambda a: a[i // 2],
                                  params["groups"][f"p{i % 2}"])


def _close(got, want, what=""):
    """``got`` within ``STATE_TOL`` of ``want``'s largest magnitude (or 1)."""
    want = np.asarray(want)
    np.testing.assert_allclose(
        got.numpy(), want, rtol=0,
        atol=STATE_TOL * max(1.0, float(np.abs(want).max())), err_msg=what)


def _state_close(mine, theirs, keys):
    for key in keys:
        _close(mine[key], theirs[key], key)
    np.testing.assert_array_equal(mine["pos"].numpy(),
                                  np.asarray(theirs["pos"]))


# ---------------------------------------------------------------------------
# the mLSTM
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("s,chunk", [(21, 8), (21, 64), (32, 16)])
def test_mlstm_parallel_matches_jax(s, chunk):
    """The chunked parallel form with an online max over key chunks: S
    not a multiple of the chunk (keys padded with +inf), one chunk, and
    an exact multiple; gates from numpy, against JAX's
    ``_mlstm_parallel`` at the same chunk."""
    rng = np.random.default_rng(s + chunk)
    q, k, v = (rng.standard_normal((2, s, 4, 8)).astype(np.float32)
               for _ in range(3))
    i_pre = rng.standard_normal((2, s, 4)).astype(np.float32)
    f_pre = (rng.standard_normal((2, s, 4)) + 2.0).astype(np.float32)
    want = jmlstm_parallel(*(jnp.asarray(a) for a in
                             (q, k, v, i_pre, f_pre)), chunk=chunk)
    got = _mlstm_parallel(*(_t(a) for a in (q, k, v, i_pre, f_pre)),
                          chunk=chunk)
    _close(got, want)


@pytest.mark.parametrize("ragged", [False, True])
def test_mlstm_block_matches_jax(fp_model, ragged):
    """``mlstm_seq`` over 13 steps folding into a zero state (rows of 13
    and 6 with ``lengths``: each row's state stops at its length), then
    four ``mlstm_step``s: y, C, n, m and pos against JAX's; a prefill
    leaves the cache it started from untouched."""
    jcfg, params, model = fp_model
    cfg = model.cfg
    jp = _layer(params, 0)["mixer"]
    mixer = model.blocks[0].mixer
    assert isinstance(mixer, MLSTM)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 13, cfg.d_model)).astype(np.float32)
    lens = np.asarray([13, 6], np.int32) if ragged else None
    jseq = jax.jit(lambda p_, x_, c_, n_: jmlstm_seq(
        JCtx(fused="off"), p_, x_, jcfg, cache=c_, lengths=n_))
    jstep = jax.jit(lambda p_, x_, c_: jmlstm_step(JCtx(fused="off"), p_,
                                                     x_, c_, jcfg))
    jy, jc = jseq(jp, jnp.asarray(x), jinit_mlstm_cache(jcfg, 2),
                  None if lens is None else jnp.asarray(lens))
    cache = init_mlstm_cache(cfg, 2, "cpu")
    assert cache["C"].shape == (2, 4, 32, 32)
    y, c = mlstm_seq(Ctx(), mixer, _t(x), cfg, cache=cache,
                     lengths=None if lens is None else _t(lens))
    assert all(not t.any() for t in cache.values())      # fresh tensors
    _close(y, jy)
    for _ in range(4):
        _state_close(c, jc, ("C", "n", "m"))
        xt = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        jy, jc = jstep(jp, jnp.asarray(xt), jc)
        y, c = mlstm_step(Ctx(), mixer, _t(xt), c, cfg)
        _close(y, jy)
    _state_close(c, jc, ("C", "n", "m"))


def test_mlstm_fold_closed_form_holds_the_scan_at_2048():
    """The closed-form fold against JAX's scan at 2048 steps (the longest
    prompt the card run folds), from a nonzero state, with forget gates
    near 1 (long memory) and rows of 2048 and 1500: C, n and m within
    1e-5 of the state's largest magnitude."""
    rng = np.random.default_rng(5)
    b, s, h, hd = 2, 2048, 2, 8
    k, v = (rng.standard_normal((b, s, h, hd)).astype(np.float32)
            for _ in range(2))
    i_pre = rng.standard_normal((b, s, h)).astype(np.float32)
    f_pre = (rng.standard_normal((b, s, h)) + 4.0).astype(np.float32)
    lens = np.asarray([2048, 1500], np.int32)
    c0 = {"C": rng.standard_normal((b, h, hd, hd)).astype(np.float32),
          "n": rng.standard_normal((b, h, hd)).astype(np.float32),
          "m": rng.standard_normal((b, h)).astype(np.float32),
          "pos": np.asarray([3, 5], np.int32)}
    want = jax.jit(jmlstm_fold)(
        None, *(jnp.asarray(a) for a in (k, v, i_pre, f_pre)),
        {key: jnp.asarray(a) for key, a in c0.items()}, jnp.asarray(lens))
    got = _mlstm_fold(*(_t(a) for a in (k, v, i_pre, f_pre)),
                      {key: _t(a) for key, a in c0.items()}, _t(lens))
    _state_close(got, want, ("C", "n", "m"))
    assert got["pos"].tolist() == [2051, 1505]


# ---------------------------------------------------------------------------
# the sLSTM
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("ragged", [False, True])
def test_slstm_block_matches_jax(fp_model, ragged):
    """``slstm_seq`` over 13 steps (rows of 13 and 6 with ``lengths``),
    then three ``slstm_step``s, at H = 4, where the reference's
    head-major recurrent layout gives z all of head 0's recurrent output,
    i head 1's, f head 2's and o head 3's: y, c, n, h, m and pos against
    JAX's."""
    jcfg, params, model = fp_model
    cfg = model.cfg
    jp = _layer(params, 1)["mixer"]
    mixer = model.blocks[1].mixer
    assert isinstance(mixer, SLSTM) and mixer.r_gates.shape == (4, 16, 64)
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, 13, cfg.d_model)).astype(np.float32)
    lens = np.asarray([13, 6], np.int32) if ragged else None
    jseq = jax.jit(lambda p_, x_, c_, n_: jslstm_seq(
        JCtx(fused="off"), p_, x_, jcfg, cache=c_, lengths=n_))
    jstep = jax.jit(lambda p_, x_, c_: jslstm_step(JCtx(fused="off"), p_,
                                                     x_, c_, jcfg))
    jy, jc = jseq(jp, jnp.asarray(x), jinit_slstm_cache(jcfg, 2),
                  None if lens is None else jnp.asarray(lens))
    y, c = slstm_seq(Ctx(), mixer, _t(x), cfg,
                     cache=init_slstm_cache(cfg, 2, "cpu"),
                     lengths=None if lens is None else _t(lens))
    _close(y, jy)
    for _ in range(3):
        _state_close(c, jc, ("c", "n", "h", "m"))
        xt = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        jy, jc = jstep(jp, jnp.asarray(xt), jc)
        y, c = slstm_step(Ctx(), mixer, _t(xt), c, cfg)
        _close(y, jy)
    _state_close(c, jc, ("c", "n", "h", "m"))


def test_layernorm_matches_jax():
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((3, 5, 64)) * 3 + 1).astype(np.float32)
    g, b = (rng.standard_normal(64).astype(np.float32) for _ in range(2))
    want = jnorm({"g": jnp.asarray(g), "b": jnp.asarray(b)}, jnp.asarray(x),
                 "layernorm")
    got = layernorm(LayerNorm(_t(g), _t(b)), _t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=NORM_TOL)


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------
LENGTHS, SLOTS = [20, 13, 18], 32


@pytest.mark.parametrize("fused", ["off", "on"])
def test_xlstm_logits_match_jax(fp_model, fused, request):
    """Prompts of 20, 13 and 18 tokens (right-padded, ``lengths``), then
    four greedy decode steps, logits every step; ``on``: JAX's Pallas
    Q+LR kernels (interpret mode) over SRR-quantized weights against the
    port's K1/K2 plain versions."""
    jcfg, params, model = fp_model
    if fused == "on":
        jcfg, params, model = request.getfixturevalue("quantized")
    b = len(LENGTHS)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, jcfg.vocab, (b, max(LENGTHS))).astype(np.int32)
    lens = np.asarray(LENGTHS, np.int32)
    jctx = JCtx(fused=fused)
    jctx.use_pallas = fused == "on"
    jl, jc = jax.jit(lambda p, t, c, n: jprefill(jctx, p, {"tokens": t}, jcfg,
                                                 c, lengths=n))(
        params, jnp.asarray(toks), jinit_cache(jcfg, b, SLOTS),
        jnp.asarray(lens))
    jdec = jax.jit(lambda p, t, c: jdecode_step(jctx, p, t, c, jcfg))
    ctx = Ctx(fused="off" if fused == "off" else "auto")
    tl, tc = prefill(ctx, model, _t(toks).long(),
                     init_cache(model.cfg, b, SLOTS, torch.bfloat16, "cpu"),
                     lengths=_t(lens))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=LOGIT_TOL)
    for _ in range(4):
        tok = np.argmax(np.asarray(jl)[:, -1], -1)[:, None].astype(np.int32)
        jl, jc = jdec(params, jnp.asarray(tok), jc)
        tl, tc = decode_step(ctx, model, _t(tok).long(), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=LOGIT_TOL)
    assert tc[0]["C"].dtype == torch.float32      # f32 under a bf16 cache
    assert tc[1]["pos"].tolist() == [24, 17, 22]


# ---------------------------------------------------------------------------
# the converter, the PTQ pass, calibration, JAX's first-layer lookup
# ---------------------------------------------------------------------------
def _jptq():
    return JPTQConfig(method="srr", rank=8, exact_svd=True, forced_k=3,
                      quantizer=QuantizerConfig(kind="mxint", bits=3,
                                                block_size=32))


@pytest.fixture(scope="module")
def quantized(fp_model):
    """(JAX config, JAX SRR-quantized params (int8), the converted
    model)."""
    jcfg, params, model = fp_model
    qparams, _ = jquantize(params, None, _jptq())
    return jcfg, qparams, convert_params(_tree(qparams), model.cfg,
                                         device="cpu")


def _packed4(tree):
    """A copy of a JAX int8 container tree with every ``codes`` leaf
    replaced by its ``packed`` nibbles, JAX's ``pack_codes_4bit`` (row 2i
    the low nibble, 2i + 1 the high one) in numpy."""
    if isinstance(tree, dict):
        out = {k: _packed4(v) for k, v in tree.items() if k != "codes"}
        if "codes" in tree:
            u = (np.asarray(tree["codes"]).astype(np.int32) & 0xF
                 ).astype(np.uint8)
            out["packed"] = u[..., 0::2, :] | (u[..., 1::2, :] << 4)
        return out
    return tree


@pytest.mark.parametrize("container", ["int8", "packed4"])
def test_converter_takes_quantized_xlstm(fp_model, quantized, container):
    """Every mLSTM and sLSTM projection arrives as a Q + LR container
    (``w_if`` at rank 4, ``ffn_down``'s codes padded to 96 rows) with its
    bias; ``r_gates`` and the LayerNorms stay f32, as JAX's pass leaves
    them; the fp tree arrives as ``FpLinear``s."""
    jcfg, params, fp = fp_model
    qparams, model = quantized[1:]
    qparams = _tree(qparams)
    if container == "packed4":
        # JAX's packed4 container: its pass's int8 codes through
        # pack_codes_4bit, as quantize_model_params(container="packed4")
        # stores them
        qparams = _packed4(qparams)
        model = convert_params(qparams, fp.cfg, device="cpu")
    for i, names in ((2, MLSTM_PROJECTIONS), (3, SLSTM_PROJECTIONS)):
        jp = _layer(qparams, i)
        mixer = model.blocks[i].mixer
        for n in names:
            p = getattr(mixer, n)
            assert isinstance(p, QLinear)
            for key, want in jp["mixer"][n].items():
                assert np.array_equal(getattr(p, key).numpy(), want), (n, key)
        for key in ("g", "b"):
            assert np.array_equal(getattr(model.blocks[i].norm1, key).numpy(),
                                  jp["norm1"][key])
    assert model.blocks[0].mixer.w_if.r.shape == (4, 8)
    store = "codes" if container == "int8" else "packed"
    rows = getattr(model.blocks[1].mixer.ffn_down, store).shape[0]
    assert rows == (96 if container == "int8" else 48)
    assert model.blocks[1].mixer.w_gates.b is not None
    assert np.array_equal(model.blocks[3].mixer.r_gates.numpy(),
                          np.asarray(_layer(qparams, 3)["mixer"]["r_gates"]))
    assert isinstance(fp.blocks[0].mixer.wq, FpLinear)
    assert fp.blocks[0].norm2 is None and fp.blocks[0].mlp is None


@pytest.fixture(scope="module")
def calibrated(fp_model):
    jcfg, params, model = fp_model
    jstats = jcapture(params, jcfg, jdata_config_for(jcfg, 32, 4, 0),
                      lambda c, p, b, cc: jlm_loss(c, p, b, cc), n_batches=1)
    stats = capture_calibration(model, data_config_for(model.cfg, 32, 4, 0),
                                lm_loss, n_batches=1, device="cpu")
    return jstats, stats


def test_calibration_taps_match_jax(calibrated):
    """Tap names ``L<i>.mlstm.<name>`` and ``L<i>.slstm.<name>`` with
    JAX's counts and moments; ``up``/``up_gate`` share x's moments and
    ``wq``/``wk``/``wv``/``w_if`` the up-projection's."""
    jstats, stats = calibrated
    assert sorted(stats) == sorted(jstats)
    assert len(stats) == 2 * 7 + 2 * 4
    for i in (0, 2):
        assert stats[f"L{i}.mlstm.up"] is stats[f"L{i}.mlstm.up_gate"]
        assert stats[f"L{i}.mlstm.wq"] is stats[f"L{i}.mlstm.w_if"]
    for key, st in stats.items():
        js = jstats[key]
        assert st.count == int(float(js.count))
        theirs = np.asarray(js.autocorr)
        np.testing.assert_allclose(
            st.autocorr.numpy(), theirs, rtol=0,
            atol=MOMENT_TOL * float(np.abs(theirs).max()), err_msg=key)


def test_pass_quantizes_each_xlstm_projection_under_its_layer(
        calibrated, monkeypatch):
    """The port's pass hands ``blocks.<i>.mixer.<name>`` the moments of
    ``L<i>.<kind>.<name>``, keeps the biases and leaves ``r_gates`` and
    the norms f32."""
    _, stats = calibrated
    seen = {}
    real = port_quantize.quantize_layer

    def spy(name, w, cfg, gen, st, recorder=None):
        seen[name] = st
        return real(name, w, cfg, gen, st, recorder=recorder)

    monkeypatch.setattr(port_quantize, "quantize_layer", spy)
    model = init_lm(get_config(ARCH).reduced(), 1, device="cpu")
    keep = dict(stats)
    model, reports = quantize_model_params(
        model, PTQConfig(method="srr", rank=8, exact_svd=True, forced_k=3),
        stats=dict(stats), device="cpu")
    assert len(reports) == 2 * 7 + 2 * 4
    for i, blk in enumerate(model.blocks):
        names = MLSTM_PROJECTIONS if blk.kind == "mlstm" \
            else SLSTM_PROJECTIONS
        for n in names:
            assert seen[f"blocks.{i}.mixer.{n}"] is \
                keep[f"L{i}.{blk.kind}.{n}"]
            assert isinstance(getattr(blk.mixer, n), QLinear)
    assert model.blocks[0].mixer.w_if.b is not None
    assert model.blocks[0].mixer.w_if.r.shape == (4, 8)      # rank 4
    assert isinstance(model.blocks[1].mixer.r_gates, torch.Tensor)


@pytest.mark.parametrize("name", MLSTM_PROJECTIONS + SLSTM_PROJECTIONS)
def test_jax_pass_reads_first_layer_stats_for_xlstm_roles(calibrated, name):
    """JAX's ``_ROLE`` has no xLSTM names, so its suffix match hands every
    scanned mLSTM layer ``L0.mlstm.<name>`` and every sLSTM layer
    ``L1.slstm.<name>`` (ROADMAP §3); the port's pass looks up
    ``L<i>.<kind>.<name>``."""
    jstats, _ = calibrated
    kind, first = ("mlstm", 0) if name in MLSTM_PROJECTIONS else ("slstm", 1)
    pos = f"p{first}"
    path = ["groups", pos, "mixer", name, "w"]
    assert jstats_for(jstats, path, "") is jstats[f"L{first}.{kind}.{name}"]
    assert jstats[f"L{first + 2}.{kind}.{name}"] is not \
        jstats[f"L{first}.{kind}.{name}"]


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------
BUDGET = {0: 9, 1: 3, 2: 7, 3: 4, 4: 5}
COMMON = dict(max_len=48, decode_batch=2, prefill_len=16, max_new_tokens=9)


def _requests(req_cls, n=5):
    rng = np.random.default_rng(0)
    return [req_cls(uid=i, prompt=rng.integers(0, 256, size=5 + (i % 3))
                    .astype(np.int32), max_new_tokens=BUDGET[i])
            for i in range(n)]


@pytest.mark.parametrize("kv,scheduler", [("bf16", "continuous"),
                                          ("int8", "continuous"),
                                          ("bf16", "bucketed")])
def test_engine_tokens_identical_to_jax(quantized, kv, scheduler):
    """Greedy tokens over the SRR-quantized model equal the JAX engine's
    with slots reused mid-flight (continuous) and through the bucketed
    scheduler, bf16 and int8 KV (the xLSTM states f32 under both); the
    prefill template is still all zeros afterwards, and the snapshot has
    JAX's keys."""
    jcfg, qparams, model = quantized
    sc = dict(COMMON, kv_dtype=kv, scheduler=scheduler)
    n = 5 if scheduler == "continuous" else 2
    jeng = JEngine(qparams, jcfg, JServeConfig(**sc))
    want = jeng.generate(_requests(JRequest, n))
    eng = Engine(model, model.cfg, ServeConfig(**sc), device="cpu")
    got = eng.generate(_requests(Request, n))
    assert [g.tokens.tolist() for g in got] == \
        [w.tokens.tolist() for w in want]
    if scheduler == "continuous":
        assert [len(g.tokens) for g in got] == [9, 3, 7, 4, 5]
        for mine in eng.slots.prefill_cache:
            assert all(t.dtype in (torch.float32, torch.int32) and not t.any()
                       for t in mine.values())
        assert set(eng.stats()) == set(jeng.stats())


def test_no_state_leak_across_admissions(quantized):
    """JAX's ``test_no_state_leak_across_admissions_recurrent`` on the
    port: five requests through two continuous lanes (each admission
    prefilled from the shared zero template) give the bucketed
    scheduler's tokens, request by request."""
    _, _, model = quantized
    budget = {i: 3 + (i % 3) for i in range(5)}
    kw = dict(max_len=64, decode_batch=2, max_new_tokens=6, prefill_len=16)

    def reqs():
        rng = np.random.default_rng(0)
        return [Request(uid=i, prompt=rng.integers(0, 256, size=5 + (i % 3))
                        .astype(np.int32), max_new_tokens=budget[i])
                for i in range(5)]

    res_c = Engine(model, model.cfg, ServeConfig(**kw), device="cpu"
                   ).generate(reqs())
    res_b = Engine(model, model.cfg, ServeConfig(**kw, scheduler="bucketed"),
                   device="cpu").generate(reqs())
    assert [r.tokens.tolist() for r in res_c] == \
        [r.tokens.tolist() for r in res_b]


def test_drift_probe_and_sanitizer_leave_states(quantized):
    """At drift rate 1.0 with the sanitizer on, the engine gives the bare
    engine's tokens; one reference step over live xLSTM states leaves
    every tensor bit for bit; an sLSTM layer whose ``pos`` is off raises
    the sanitizer's ``pos`` verdict."""
    _, _, model = quantized
    cfg = model.cfg
    want = [r.tokens.tolist() for r in Engine(
        model, cfg, ServeConfig(**COMMON), device="cpu").generate(
            _requests(Request))]
    eng = Engine(model, cfg, ServeConfig(**COMMON, sanitize=True,
                                         drift_monitor=True,
                                         drift_sample_rate=1.0),
                 device="cpu")
    assert [r.tokens.tolist() for r in eng.generate(_requests(Request))] \
        == want
    assert eng.stats()["drift_checks"] > 0
    assert eng.stats()["drift_nonfinite"] == 0

    toks = torch.from_numpy(np.random.default_rng(4).integers(0, 256, (2, 21)))
    _, cache = prefill(Ctx(), model, toks,
                       init_cache(cfg, 2, 48, torch.bfloat16, "cpu"),
                       lengths=torch.tensor([21, 9], dtype=torch.int32))
    tok = torch.tensor([[3], [7]])
    decode_step(Ctx(), model, tok, cache)
    before = [{k: v.clone() for k, v in c.items()} for c in cache]
    saved = [save_step_writes(c) for c in cache]
    decode_step(Ctx(fused="off"), model, tok, cache)
    assert not torch.equal(cache[0]["C"], before[0]["C"])
    for c, sv in zip(cache, saved):
        restore_step_writes(c, sv)
    for c, b in zip(cache, before):
        assert c.keys() == b.keys()
        assert all(torch.equal(c[k], b[k]) for k in c)

    eng = Engine(model, cfg, ServeConfig(**COMMON, sanitize=True),
                 device="cpu")
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
    """``init_cache(pages=)`` raises with JAX's message (the first xLSTM
    layer), and a chunked prefill with its ``kind`` message."""
    jcfg, _, model = fp_model
    with pytest.raises(ValueError) as jerr:
        jinit_cache(jcfg, 2, 16, pages=8, page_size=8)
    with pytest.raises(ValueError) as err:
        init_cache(model.cfg, 2, 16, torch.float32, "cpu", pages=8,
                   page_size=8)
    assert str(err.value) == str(jerr.value)
    cache = init_cache(model.cfg, 1, 16, torch.float32, "cpu")
    with pytest.raises(ValueError, match="kind='mlstm'"):
        prefill_chunk(Ctx(), model, torch.zeros((1, 4), dtype=torch.long),
                      cache, 0, 0, 4)


# ---------------------------------------------------------------------------
# registry and refusals
# ---------------------------------------------------------------------------
def test_registered_and_laid_out():
    """The port's copy of the config equals JAX's field for field; the
    full model alternates mLSTM and sLSTM over 12 layers; a reduced init
    has LayerNorms, a rank-able 8-column ``w_if`` and f32 states under an
    int8 KV request (14,266,512 bytes a lane at full width)."""
    cfg = ARCHS[ARCH]
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jget_config(ARCH))
    check_supported(cfg)
    assert [kind_at(cfg, i) for i in range(cfg.n_layers)] == \
        ["mlstm", "slstm"] * 6
    model = init_lm(cfg.reduced(), 0, device="cpu")
    assert isinstance(model.final_norm, LayerNorm)
    mixer = model.blocks[0].mixer
    assert mixer.w_if.w.shape == (128, 8) and mixer.w_if.b.shape == (8,)
    assert model.blocks[1].mixer.ffn_up.w.shape == (64, 85)
    cache = init_cache(cfg.reduced(), 2, 8, torch.int8, "cpu")
    assert {t.dtype for c in cache for k, t in c.items() if k != "pos"} == \
        {torch.float32}
    full = init_cache(cfg, 1, 8, torch.bfloat16, "meta")
    assert sum(t.numel() * t.element_size() for c in full
               for t in c.values()) == 14_266_512


def test_mixed_patterns_stay_refused():
    """An xLSTM block beside attention, an FFN width or an MoE on an
    xLSTM stack are refused."""
    base = ARCHS[ARCH]
    for kw in (dict(block_pattern=("attn", "mlstm")), dict(d_ff=128),
               dict(moe=True, n_routed=4, top_k=2, d_expert=32)):
        with pytest.raises(NotImplementedError):
            check_supported(dataclasses.replace(base, **kw))
    check_supported(dataclasses.replace(base, block_pattern=("mlstm",)))
