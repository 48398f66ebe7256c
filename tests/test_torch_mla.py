"""Port parity: MLA (deepseek-v2-lite-16b's multi-head latent attention)
against the JAX package on the CPU.

The reduced config keeps MLA's structure (a 16-wide latent, an 8-wide
RoPE key, 4 heads of 16, the MoE FFN after a dense lead-in layer); a
``dataclasses.replace``d copy, the same in both packages, brings the
heads up to the full model's 16 (G = 16 over the one latent head), and
another turns on the q-LoRA branch (``q_lora_rank=16``). Inputs and
weights come from seeded JAX inits and numpy, converted to the port.

Cases: ``mla_seq`` / ``mla_step`` through a whole model in the two-einsum
form (``fused="off"`` on both sides) and in the kernel form (JAX's
``fused="on"``, its Pallas decode kernel in interpret mode, against the
port's K3 plain version), with ragged rows, a row that writes the last
slot and rows past it (no write); the absorbed weights of quantized
mixers; the converter's fp, int8 and packed4 MLA trees (the dense lead-in
``prefix`` and the scan-stacked ``groups``); calibration taps per layer;
the SRR pass's containers; the engine (greedy tokens continuous and
bucketed, sampled lanes, the int8-KV float rule, the paged and
speculative refusals, the drift probe and the sanitizer); and the K3
wrapper's checks at the latent head.

Tolerances: logits 1e-4 absolute (f32 latents; the two frameworks sum in
other orders, observed ≤ 5e-6 at this size) and caches 1e-5 (one f32
projection and RMSNorm); absorbed weights 1e-6 of their scale (one f32
``L·R``); containers as ``test_torch_dense_variants.py`` holds them
(codes equal but for a step at a rounding tie, scales equal, Q + LR within
1e-4 of max|W|); moments 2e-6 of their largest entry; greedy and sampled
tokens identical.
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
from repro.models.attention import absorb_mla_weights as jabsorb
from repro.models.quantize import _stats_for as jstats_for
from repro.models.quantize import quantize_model_params as jquantize
from repro.quant.base import QuantizerConfig
from repro.serve import Engine as JEngine
from repro.serve import Request as JRequest
from repro.serve import SamplingParams as JSamplingParams
from repro.serve import ServeConfig as JServeConfig
from repro_torch.configs import ARCHS, get_config
from repro_torch.convert import convert_params
from repro_torch.core.api import PTQConfig
from repro_torch.data import capture_calibration, data_config_for
from repro_torch.kernels import decode_attention as dk
from repro_torch.kernels.mxint_matmul import dequant_blockwise
from repro_torch.models import (Ctx, decode_step, init_cache, init_lm,
                                lm_loss, prefill, prefill_chunk,
                                verify_chunk)
from repro_torch.models.attention import (MLA, MLA_PROJECTIONS,
                                          absorb_mla_weights, init_mla_cache,
                                          mla_step, restore_step_writes,
                                          save_step_writes)
from repro_torch.models.linear import FpLinear, QLinear
from repro_torch.models.quantize import quantize_model_params
from repro_torch.models.transformer import check_supported
from repro_torch.quant.mxint import pack_codes_4bit
from repro_torch.serve import Engine, Request, SamplingParams, ServeConfig
from repro_torch.serve.sanitizer import SanitizerError

ARCH = "deepseek-v2-lite-16b"
VARIANTS = {"reduced": {}, "h16": dict(n_heads=16, n_kv_heads=16),
            "qlora": dict(q_lora_rank=16)}
PROJ = ("w_q", "w_dkv", "w_kpe", "w_uk", "w_uv", "wo")
LOGIT_TOL = 1e-4
REC_TOL = 1e-4


def _configs(variant="reduced"):
    fields = VARIANTS[variant]
    return (dataclasses.replace(jget_config(ARCH).reduced(), **fields),
            dataclasses.replace(get_config(ARCH).reduced(), **fields))


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _jptq():
    return JPTQConfig(method="srr", rank=8, exact_svd=True, forced_k=3,
                      quantizer=QuantizerConfig(kind="mxint", bits=3,
                                                block_size=32))


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    """Many small ops: two intra-op threads, as in
    ``tests/test_torch_train.py``; restored after the module."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def quantized():
    """(JAX config, JAX SRR-quantized params (int8), the converted model)
    of the reduced config: one JAX pass for the module."""
    jcfg, cfg = _configs()
    params = jinit_lm(jax.random.PRNGKey(2), jcfg)
    qparams, _ = jquantize(params, None, _jptq())
    return jcfg, params, qparams, convert_params(_tree(qparams), cfg,
                                                 device="cpu")


# ---------------------------------------------------------------------------
# prefill and decode logits, the latent cache, through a whole model
# ---------------------------------------------------------------------------
# rows of 12, 7 and 15 tokens in 16 slots (one shape for every model
# case, so JAX's eager ops compile once)
LENGTHS, SLOTS = [12, 7, 15], 16


def _run_both(jcfg, params, model, fused, steps, seed=3):
    """Prefill right-padded prompts of ``LENGTHS`` into a ``SLOTS``-slot
    f32 cache, then ``steps`` greedy decode steps on both sides; asserts
    the logits every step and the latent rows at the end, and returns the
    final positions."""
    b, s_max = len(LENGTHS), SLOTS
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, jcfg.vocab, (b, max(LENGTHS))).astype(np.int32)
    lens = np.asarray(LENGTHS, np.int32)
    jctx = JCtx(fused=fused)
    jctx.use_pallas = fused == "on"
    jpre = jax.jit(lambda p, t, c, n: jprefill(jctx, p, {"tokens": t}, jcfg,
                                               c, lengths=n))
    jdec = jax.jit(lambda p, t, c: jdecode_step(jctx, p, t, c, jcfg))
    jl, jc = jpre(params, jnp.asarray(toks),
                  jinit_cache(jcfg, b, s_max, dtype=jnp.float32),
                  jnp.asarray(lens))
    ctx = Ctx(fused="off" if fused == "off" else "auto")
    tl, tc = prefill(ctx, model, _t(toks).long(),
                     init_cache(model.cfg, b, s_max, torch.float32, "cpu"),
                     lengths=_t(lens))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=LOGIT_TOL)
    for _ in range(steps):
        tok = np.argmax(np.asarray(jl)[:, -1], -1)[:, None].astype(np.int32)
        jl, jc = jdec(params, jnp.asarray(tok), jc)
        tl, tc = decode_step(ctx, model, _t(tok).long(), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=LOGIT_TOL)
    r = jcfg.kv_lora_rank
    layers = list(jc["prefix"]) + [
        {k: v[0] for k, v in jc["groups"]["p0"].items()}]
    for mine, theirs in zip(tc, layers):
        np.testing.assert_array_equal(mine["pos"].numpy(),
                                      np.asarray(theirs["pos"]))
        np.testing.assert_allclose(mine["lat"][..., :r].numpy(),
                                   np.asarray(theirs["ckv"]), rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(mine["lat"][..., r:].numpy(),
                                   np.asarray(theirs["kpe"]), rtol=0,
                                   atol=1e-5)
    return tc[0]["pos"].numpy()


@pytest.mark.parametrize("fused", ["off", "on"])
def test_mla_logits_and_latents_match_jax(fused):
    """Rows of 12, 7 and 15 tokens in 16 slots, five decode steps: row 2
    writes the last slot at its first step and then runs past it (JAX's
    scatter drops those writes, the port's mask too), row 0 reaches it at
    its fourth step. The kernel route is JAX's Pallas decode kernel
    (interpret mode) against the port's K3 plain version."""
    jcfg, cfg = _configs()
    params = jinit_lm(jax.random.PRNGKey(1), jcfg)
    model = convert_params(_tree(params), cfg, device="cpu")
    pos = _run_both(jcfg, params, model, fused, 5)
    assert pos.tolist() == [17, 12, 20]


def test_sixteen_heads_match_jax():
    """The full model's 16 heads over the one latent head (G = 16 in K3's
    plain version), through the kernel route."""
    jcfg, cfg = _configs("h16")
    params = jinit_lm(jax.random.PRNGKey(4), jcfg)
    model = convert_params(_tree(params), cfg, device="cpu")
    assert model.blocks[0].mixer.w_q.w.shape == (64, 16 * (16 + 8))
    _run_both(jcfg, params, model, "on", 2, seed=4)


def test_q_lora_branch_matches_jax():
    """``q_lora_rank=16``: w_dq → RMSNorm → w_uq instead of w_q (the
    two-einsum form: the branch is upstream of the attention form)."""
    jcfg, cfg = _configs("qlora")
    params = jinit_lm(jax.random.PRNGKey(5), jcfg)
    model = convert_params(_tree(params), cfg, device="cpu")
    mixer = model.blocks[1].mixer
    assert mixer.w_q is None and mixer.w_dq.w.shape == (64, 16)
    _run_both(jcfg, params, model, "off", 2, seed=5)
    # init_lm builds the same branch
    mine = init_lm(cfg, 0, device="cpu").blocks[0].mixer
    assert mine.w_q is None and mine.q_norm.g.shape == (16,)


def test_past_the_last_slot_writes_nothing_and_probe_restores():
    """One MLA step over rows at slot 3, at the last slot (7) and past it
    (9): the first two rows write their latent row, the third writes
    nothing and still attends over every slot; every ``pos`` moves on.
    ``save_step_writes`` / ``restore_step_writes`` undo the step bit for
    bit."""
    cfg = get_config(ARCH).reduced()
    model = init_lm(cfg, 3, device="cpu")
    mixer = model.blocks[0].mixer
    cache = init_mla_cache(cfg, 3, 8, torch.float32, "cpu")
    gen = torch.Generator().manual_seed(0)
    cache["lat"].copy_(torch.randn(cache["lat"].shape, generator=gen))
    cache["pos"] = torch.tensor([3, 7, 9], dtype=torch.int32)
    before = {k: v.clone() for k, v in cache.items()}
    x = torch.randn((3, 1, cfg.d_model), generator=gen)
    saved = save_step_writes(cache)
    for fused in ("auto", "off"):
        restore_step_writes(cache, saved)
        y, cache = mla_step(Ctx(fused=fused), mixer, x, cache, cfg)
        assert cache["pos"].tolist() == [4, 8, 10]
        changed = (cache["lat"] != before["lat"]).any(-1)
        assert changed[0].tolist() == [False] * 3 + [True] + [False] * 4
        assert changed[1].tolist() == [False] * 7 + [True]
        assert not changed[2].any()
        assert torch.isfinite(y).all()
    restore_step_writes(cache, saved)
    for k in before:
        assert torch.equal(cache[k], before[k])


# ---------------------------------------------------------------------------
# the converter, the absorbed weights, the SRR pass
# ---------------------------------------------------------------------------
def _packed4(tree):
    """JAX's packed4 container of an int8 tree: the same factors, the
    codes packed two to a byte along the rows (by the port's
    ``pack_codes_4bit``, bit-exact to JAX's in ``test_torch_mxint.py``;
    JAX's eager packing compiles once per matrix shape)."""
    if isinstance(tree, dict):
        if "codes" in tree:
            out = {k: v for k, v in tree.items() if k != "codes"}
            out["packed"] = pack_codes_4bit(_t(tree["codes"])).numpy()
            return out
        return {k: _packed4(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_packed4(v) for v in tree]
    return tree


def _layer_trees(tree):
    """Each layer's block tree: the ``prefix`` lead-in, then the
    ``groups`` layers unstacked."""
    group = tree["groups"]["p0"]
    n = np.asarray(group["norm1"]["g"]).shape[0]
    unstack = lambda t, i: ({k: unstack(v, i) for k, v in t.items()}  # noqa
                            if isinstance(t, dict) else np.asarray(t)[i])
    return list(tree["prefix"]) + [unstack(group, i) for i in range(n)]


@pytest.mark.parametrize("container", ["fp", "int8", "packed4"])
def test_converter_takes_mla_trees(quantized, container):
    """Every MLA buffer of the prefix and group layers lands bit for bit;
    the packed4 model's prefill logits equal the int8 model's (the same
    codes; the engine and SRR cases hold the int8 model to JAX)."""
    jcfg, params, qparams, int8_model = quantized
    tree = _tree(params if container == "fp" else qparams)
    if container == "packed4":
        tree = _packed4(tree)
    model = convert_params(tree, get_config(ARCH).reduced(), device="cpu")
    for blk, layer in zip(model.blocks, _layer_trees(tree)):
        mx = layer["mixer"]
        assert isinstance(blk.mixer, MLA)
        assert np.array_equal(blk.mixer.ckv_norm.g.numpy(),
                              mx["ckv_norm"]["g"])
        for n in PROJ:
            p = getattr(blk.mixer, n)
            assert isinstance(p, FpLinear if container == "fp" else QLinear)
            for key, want in mx[n].items():
                assert np.array_equal(getattr(p, key).numpy(),
                                      np.asarray(want)), (n, key)
    if container != "packed4":
        return
    toks = torch.from_numpy(np.random.default_rng(8).integers(
        0, jcfg.vocab, (2, 11)))
    lens = torch.tensor([11, 6], dtype=torch.int32)
    got, want = (prefill(Ctx(), m, toks, init_cache(
        m.cfg, 2, 16, torch.float32, "cpu"), lengths=lens)[0]
        for m in (model, int8_model))
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def test_absorbed_weights_match_jax(quantized):
    """``absorb_mla_weights`` of each quantized mixer (dequant(Q) + L·R in
    f32) against JAX's on the prefix layer and on the stacked group; the
    engine builds them once and its decode reads them."""
    jcfg, _, qparams, model = quantized
    want = [jabsorb(qparams["prefix"][0]["mixer"])]
    grp = jabsorb(qparams["groups"]["p0"]["mixer"])
    want += [{k: np.asarray(grp[k])[i] for k in ("w_uk_dense", "w_uv_dense")}
             for i in range(len(model.blocks) - 1)]
    for blk, w in zip(model.blocks, want):
        uk, uv = absorb_mla_weights(blk.mixer)
        for mine, theirs in ((uk, w["w_uk_dense"]), (uv, w["w_uv_dense"])):
            theirs = np.asarray(theirs)
            np.testing.assert_allclose(mine.numpy(), theirs, rtol=0,
                                       atol=1e-6 * np.abs(theirs).max())
    eng = Engine(model, model.cfg, ServeConfig(max_len=16, decode_batch=2),
                 device="cpu")
    assert set(eng.ctx.absorbed) == {blk.mixer for blk in model.blocks}
    assert eng._rctx.absorbed is eng.ctx.absorbed
    tok = torch.tensor([[5], [9]])
    cache = init_cache(model.cfg, 2, 16, torch.float32, "cpu")
    a = decode_step(eng.ctx, model, tok, [dict(c) for c in cache])[0]
    b = decode_step(Ctx(), model, tok, [
        {k: v.clone() for k, v in c.items()} for c in
        init_cache(model.cfg, 2, 16, torch.float32, "cpu")])[0]
    assert torch.equal(a, b)


def _dequant(codes, scale, m):
    return dequant_blockwise(_t(codes), _t(scale), torch.float32)[:m].numpy()


def _container_close(got, want, w, k):
    """As ``test_torch_dense_variants.py``: scales and gscale equal, the
    preserved part within REC_TOL · max|W|; codes equal but for at most
    two a step off at a rounding tie of JAX's quantizer input; Q + LR
    within REC_TOL · max|W|, or within twice the flipped steps."""
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


def test_srr_pass_matches_jax(quantized):
    """The port's ``quantize_model_params`` of the converted fp model
    (``stats=None``, exact SVDs, k forced to 3) against JAX's pass: all
    six MLA projections of every layer, and nothing else in the mixer."""
    jcfg, params, qparams, _ = quantized
    model = convert_params(_tree(params), get_config(ARCH).reduced(),
                           device="cpu")
    model, reports = quantize_model_params(
        model, PTQConfig(method="srr", rank=8, exact_svd=True, forced_k=3),
        device="cpu")
    assert len(reports) == 43 and all(r.k_star == 3 for r in reports)
    mla = [r.name for r in reports if ".mixer." in r.name]
    assert len(mla) == 12 and mla[:6] == [f"blocks.0.mixer.{n}"
                                          for n in MLA_PROJECTIONS
                                          if n in PROJ]
    fp, q = _layer_trees(_tree(params)), _layer_trees(_tree(qparams))
    for blk, w_layer, q_layer in zip(model.blocks, fp, q):
        for n in PROJ:
            p = getattr(blk.mixer, n)
            got = {f: getattr(p, f).numpy() for f in
                   ("codes", "scale", "l", "r", "gscale")}
            _container_close(got, q_layer["mixer"][n],
                             w_layer["mixer"][n]["w"], 3)
        assert isinstance(blk.mixer.ckv_norm.g, torch.Tensor)


# ---------------------------------------------------------------------------
# calibration taps, and JAX's layer-0 lookup of the MLA roles
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def calibrated():
    jcfg, cfg = _configs()
    params = jinit_lm(jax.random.PRNGKey(0), jcfg)
    jstats = jcapture(params, jcfg, jdata_config_for(jcfg, 32, 4, 0),
                      lambda c, p, b, cc: jlm_loss(c, p, b, cc), n_batches=2)
    model = convert_params(_tree(params), cfg, device="cpu")
    stats = capture_calibration(model, data_config_for(cfg, 32, 4, 0),
                                lm_loss, n_batches=2, device="cpu")
    return jstats, stats


def test_calibration_taps_match_jax(calibrated):
    """Tap names ``L<i>.attn.w_q`` / ``.w_dkv`` / ``.w_kpe`` (x),
    ``.w_uk`` / ``.w_uv`` (the normed latent) and ``.wo`` per layer, with
    JAX's counts and moments; the port shares one moment set among the
    projections fed one tensor."""
    jstats, stats = calibrated
    assert sorted(stats) == sorted(jstats)
    for i in range(2):
        for n in PROJ:
            assert f"L{i}.attn.{n}" in stats
        assert stats[f"L{i}.attn.w_q"] is stats[f"L{i}.attn.w_dkv"] \
            is stats[f"L{i}.attn.w_kpe"]
        assert stats[f"L{i}.attn.w_uk"] is stats[f"L{i}.attn.w_uv"]
    for key, st in stats.items():
        js = jstats[key]
        assert st.count == int(float(js.count))
        for mine, theirs in ((st.sum_sq, js.sum_sq),
                             (st.autocorr, js.autocorr)):
            theirs = np.asarray(theirs)
            np.testing.assert_allclose(mine.numpy(), theirs, rtol=0,
                                       atol=2e-6 * float(np.abs(theirs).max()))


@pytest.mark.parametrize("name", PROJ)
def test_jax_pass_reads_layer_zero_stats_for_mla_roles(calibrated, name):
    """JAX's ``_ROLE`` table has no MLA names, so its suffix match hands
    every scanned layer's MLA projection ``L0.attn.<name>`` (ROADMAP §3);
    the port's pass looks up ``L<i>.attn.<name>``."""
    jstats, _ = calibrated
    path = ["groups", "p0", "mixer", name, "w"]
    assert jstats_for(jstats, path, "") is jstats[f"L0.attn.{name}"]
    assert jstats[f"L1.attn.{name}"] is not jstats[f"L0.attn.{name}"]


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------
COMMON = dict(max_len=40, decode_batch=3, prefill_len=24, kv_dtype="bf16",
              max_new_tokens=8)
SAMPLING = [None, dict(temperature=0.8, seed=3), dict(temperature=1.0,
                                                      top_p=0.9),
            None, dict(temperature=0.7, top_k=11)]


def _requests(req_cls, sp_cls, sampled):
    """Five requests in two prompt lengths (two buckets of the baseline)."""
    rng = np.random.default_rng(5)
    out = []
    for i in range(5):
        prompt = rng.integers(0, 256, size=6 + 8 * (i % 2)).astype(np.int32)
        sp = SAMPLING[i] if sampled else None
        out.append(req_cls(uid=i, prompt=prompt, max_new_tokens=(8, 3, 6, 0,
                                                                  5)[i],
                           params=None if sp is None else sp_cls(**sp)))
    return out


@pytest.mark.parametrize("mode", ["continuous", "bucketed", "sampled"])
def test_engine_tokens_identical_to_jax(quantized, mode):
    """Greedy tokens under both schedulers, and sampled lanes mixed with
    greedy ones under the continuous scheduler, equal the JAX engine's
    over the same quantized params (bf16 latents)."""
    jcfg, _, qparams, model = quantized
    sc = dict(COMMON, scheduler="bucketed" if mode == "bucketed"
              else "continuous")
    sampled = mode == "sampled"
    want = JEngine(qparams, jcfg, JServeConfig(**sc)).generate(
        _requests(JRequest, JSamplingParams, sampled), seed=7)
    got = Engine(model, model.cfg, ServeConfig(**sc), device="cpu").generate(
        _requests(Request, SamplingParams, sampled), seed=7)
    assert [g.uid for g in got] == [w.uid for w in want]
    assert [g.tokens.tolist() for g in got] == \
        [w.tokens.tolist() for w in want]
    assert sum(len(g.tokens) for g in got) == 22


def test_int8_kv_keeps_bf16_latents(quantized):
    """JAX's float rule: an int8 (or int4) KV request stores the latents in
    bf16, so the engine's tokens are the bf16 engine's."""
    _, _, _, model = quantized
    cache = init_cache(model.cfg, 2, 8, torch.int8, "cpu")
    assert all(c["lat"].dtype == torch.bfloat16 for c in cache)
    assert init_cache(model.cfg, 2, 8, "int4", "cpu")[0]["lat"].dtype == \
        torch.bfloat16
    toks = {}
    for kv in ("bf16", "int8"):
        eng = Engine(model, model.cfg, ServeConfig(**dict(COMMON, kv_dtype=kv)),
                     device="cpu")
        toks[kv] = [r.tokens.tolist() for r in eng.generate(
            _requests(Request, SamplingParams, False))]
    assert toks["int8"] == toks["bf16"]


@pytest.mark.parametrize("kw", [dict(paged=True, page_size=8),
                                dict(speculative=True)],
                         ids=["paged", "speculative"])
def test_engine_refuses_like_jax(quantized, kw):
    jcfg, _, qparams, model = quantized
    with pytest.raises(ValueError) as jerr:
        JEngine(qparams, jcfg, JServeConfig(**COMMON, **kw))
    with pytest.raises(ValueError) as err:
        Engine(model, model.cfg, ServeConfig(**COMMON, **kw), device="cpu")
    assert str(err.value) == str(jerr.value)


def test_no_paged_cache_and_no_chunks():
    """``init_cache(pages=)`` raises with JAX's message; the chunked
    prefill and the speculative verify refuse an MLA model."""
    jcfg, cfg = _configs()
    with pytest.raises(ValueError) as jerr:
        jinit_cache(jcfg, 2, 16, pages=8, page_size=8)
    with pytest.raises(ValueError) as err:
        init_cache(cfg, 2, 16, torch.float32, "cpu", pages=8, page_size=8)
    assert str(err.value) == str(jerr.value)
    model = init_lm(cfg, 0, device="cpu")
    cache = init_cache(cfg, 1, 16, torch.float32, "cpu")
    tok = torch.zeros((1, 4), dtype=torch.long)
    for fn in (prefill_chunk, verify_chunk):
        with pytest.raises(ValueError, match="MLA"):
            fn(Ctx(), model, tok, cache, 0, 0, 4)


def test_drift_probe_and_sanitizer_on_mla(quantized):
    """The drift monitor at rate 1.0 (its reference pass over the MLA
    cache, put back bit for bit) and the sanitizer leave the tokens as
    they were; a lane whose device ``pos`` is off raises the sanitizer's
    ``pos`` verdict."""
    _, _, _, model = quantized
    plain = Engine(model, model.cfg, ServeConfig(**COMMON), device="cpu")
    want = [r.tokens.tolist() for r in plain.generate(
        _requests(Request, SamplingParams, False))]
    eng = Engine(model, model.cfg, ServeConfig(
        **COMMON, sanitize=True, drift_monitor=True, drift_sample_rate=1.0),
        device="cpu")
    got = [r.tokens.tolist() for r in eng.generate(
        _requests(Request, SamplingParams, False))]
    assert got == want
    st = eng.stats()
    assert st["drift_checks"] > 0 and st["drift_nonfinite"] == 0
    eng = Engine(model, model.cfg, ServeConfig(**COMMON, sanitize=True),
                 device="cpu")
    for r in _requests(Request, SamplingParams, False)[:2]:
        eng.submit(r)
    eng.step()
    eng.step()
    eng.slots.cache[1]["pos"] = eng.slots.cache[1]["pos"] + 3
    with pytest.raises(SanitizerError, match="pos"):
        eng.step()


# ---------------------------------------------------------------------------
# registry, admission, the K3 wrapper at the latent head
# ---------------------------------------------------------------------------
def test_registered_and_admitted(monkeypatch):
    cfg = ARCHS[ARCH]
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jget_config(ARCH))
    check_supported(cfg)
    model = init_lm(cfg.reduced(), 0, device="cpu")
    mixer = model.blocks[0].mixer
    assert isinstance(mixer, MLA) and mixer.w_dq is None
    assert mixer.w_dkv.w.shape == (64, 16) and mixer.w_kpe.w.shape == (64, 8)
    assert mixer.w_uk.w.shape == (16, 64) and mixer.wo.w.shape == (64, 64)
    lat = init_cache(cfg.reduced(), 2, 8, torch.bfloat16, "cpu")[0]["lat"]
    assert lat.shape == (2, 8, 24)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        init_lm(cfg.reduced(), 0)


@pytest.mark.parametrize("change", [dict(kv_lora_rank=0),
                                    dict(rope_head_dim=0),
                                    dict(rope_head_dim=7)])
def test_check_supported_needs_a_latent(change):
    cfg = dataclasses.replace(get_config(ARCH).reduced(), **change)
    with pytest.raises(NotImplementedError):
        check_supported(cfg)


def _latent_args(hd=24, dv=16, dtype=torch.float32):
    q = torch.zeros((2, 1, 4, hd))
    lat = torch.zeros((2, 32, hd), dtype=dtype)
    k_pos = torch.arange(32, dtype=torch.int32).repeat(2, 1)
    return q, lat[:, None], lat[:, None, :, :dv], torch.tensor([3, 31]), k_pos


@pytest.mark.parametrize("case", ["v_copy", "v_offset", "dv_over_512",
                                  "int8", "scales", "over_576", "g17"])
def test_latent_wrapper_raises_before_launch(case):
    """K3's latent route takes only V = k[..., :dv] (dv ≤ 512) of a float
    cache with no scales, at most 576 wide, G ≤ 16; it raises on the rest
    before anything reaches the card."""
    hd = 640 if case == "over_576" else 576
    q, k, v, q_pos, k_pos = _latent_args(hd, 512)
    ks = vs = None
    err = ValueError
    if case == "v_copy":
        v = v.contiguous()
    elif case == "v_offset":
        v = k[..., 64:]
    elif case == "dv_over_512":
        v = k
    elif case == "int8":
        k = torch.zeros(k.shape, dtype=torch.int8)
        v, err = k[..., :512], TypeError
    elif case == "scales":
        ks = vs = torch.ones(k.shape[:3])
    elif case == "g17":
        q = torch.zeros((2, 1, 17, hd))
    with pytest.raises(err):
        dk.flash_decode(q, k, v, q_pos, k_pos, ks, vs, scale=0.1,
                        latent=True)


def test_latent_plain_version_and_group_blocks():
    """The plain version returns V's dv columns; the latent instance
    takes 4 heads a block (16 heads: 4 blocks), K3's narrow one 8."""
    gen = torch.Generator().manual_seed(1)
    q = torch.randn((2, 1, 16, 40), generator=gen)
    lat = torch.randn((2, 32, 40), generator=gen)
    k_pos = torch.arange(32, dtype=torch.int32).repeat(2, 1)
    q_pos = torch.tensor([5, 40], dtype=torch.int32)
    out = dk.decode_attention_op(q, lat[:, None], lat[:, None, :, :32],
                                 q_pos, k_pos, scale=0.125)
    full = dk.decode_attention_op(q, lat[:, None], lat[:, None], q_pos,
                                  k_pos, scale=0.125)
    assert out.shape == (2, 1, 16, 32)
    torch.testing.assert_close(out, full[..., :32], rtol=0, atol=1e-6)
    assert dk.group_blocks(16, latent=True) == 4 and dk.group_blocks(16) == 2
