"""Self-speculative decoding in the port (``ServeConfig(speculative=
True)``: a Q-only draft through ``Ctx(draft=True)``, one ``verify_chunk``
a lane), mirroring ``tests/test_serve_spec.py`` and held against the JAX
engine on the same converted params:

* spec-on tokens equal spec-off tokens — the fp model over f32/int4 KV
  × paged/unpaged (the verify is read-only there), the JAX-SRR-quantized
  model over f32/bf16/int8/int4 paged, fused on/off, and int8 unpaged
  (the verify stores full-model K/V over the drafts'); page refcounts
  conserved;
* the port's speculative tokens and ``spec_rounds`` /
  ``spec_draft_tokens`` / ``spec_accepted_tokens`` equal the JAX
  engine's, and one reduced deepseek-moe case (its routed experts keep
  their LR in the draft, as JAX's expert path does);
* ``verify_chunk`` logits within 1e-4 · max|logit| of JAX's for store
  True/False over the paged and unpaged caches, a store=False chunk
  leaving the cache untouched; the draft's rank-0 ``linear``;
* a stop token inside an accepted window, sampled lanes falling back to
  per-token decode, the step-budget charges, logprobs on every token and
  an abort between rounds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core.api import PTQConfig as JPTQConfig
from repro.models import Ctx as JCtx
from repro.models import init_cache as jinit_cache
from repro.models import init_lm as jinit_lm
from repro.models import prefill_chunk as jprefill_chunk
from repro.models import verify_chunk as jverify_chunk
from repro.models.linear import linear as jlinear
from repro.models.quantize import quantize_model_params as jquantize
from repro.quant.base import QuantizerConfig
from repro.serve import Engine as JEngine
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro.serve.pages import set_block_table_row as jset_row
from repro_torch.configs import get_config
from repro_torch.convert import convert_params
from repro_torch.models import (Ctx, init_cache, linear, prefill_chunk,
                                verify_chunk)
from repro_torch.serve import Engine, Request, SamplingParams, ServeConfig
from repro_torch.serve.pages import set_block_table_row

PTQ = JPTQConfig(method="srr", rank=8, exact_svd=True, forced_k=3,
                 quantizer=QuantizerConfig(kind="mxint", bits=3,
                                           block_size=32))
KV = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16,
                                                     torch.bfloat16),
      "int8": (jnp.int8, torch.int8), "int4": ("int4", "int4")}


def _models(arch, quantize):
    jcfg = jget_config(arch).reduced()
    params = jinit_lm(jax.random.PRNGKey(0 if not quantize else 2), jcfg)
    if quantize:
        params, _ = jquantize(params, None, PTQ)
    model = convert_params(jax.tree_util.tree_map(np.asarray, params),
                           get_config(arch).reduced(), device="cpu")
    return jcfg, params, model


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    """Many small ops: two intra-op threads, as in
    ``tests/test_torch_train.py``; restored after the module."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def fp():
    return _models("phi3-mini-3.8b", quantize=False)


@pytest.fixture(scope="module")
def quantized():
    return _models("phi3-mini-3.8b", quantize=True)


def _sc(**kw):
    return dict(dict(max_len=128, decode_batch=3, max_new_tokens=12,
                     prefill_len=16), **kw)


def _engine(model, **kw):
    return Engine(model, model.cfg, ServeConfig(**_sc(**kw)), device="cpu")


def _reqs(n, base_len=5, params=None, budget=None, cls=Request):
    rng = np.random.default_rng(0)
    return [cls(uid=i, prompt=rng.integers(0, 256, size=base_len + (i % 3))
                .astype(np.int32), max_new_tokens=budget,
                params=params[i] if params else None) for i in range(n)]


def _same(a, b, msg=""):
    assert [r.uid for r in a] == [r.uid for r in b]
    for ra, rb in zip(a, b):
        assert ra.tokens.tolist() == rb.tokens.tolist(), (msg, ra.uid)
        assert ra.finish_reason == rb.finish_reason, (msg, ra.uid)


def _spec_vs_plain(model, spec_k=4, nreq=4, params=None, **kw):
    plain = _engine(model, **kw).generate(_reqs(nreq, params=params))
    eng = _engine(model, speculative=True, spec_k=spec_k, **kw)
    spec = eng.generate(_reqs(nreq, params=params))
    return plain, spec, eng


def _assert_pool_conserved(eng):
    pool = eng.pool
    assert pool.n_free + pool.n_cold + pool.n_hot == pool.n_pages
    # every request retired: only the parked per-lane pages hold a ref
    assert sum(pool.refcount(p) for p in range(pool.n_pages)) \
        == eng.sc.decode_batch


# --------------------------------------------------------------------------
# spec-on equals spec-off
# --------------------------------------------------------------------------
@pytest.mark.parametrize("kv", ["f32", "int4"])
@pytest.mark.parametrize("paged", [False, True], ids=["unpaged", "paged"])
def test_spec_parity_fp(fp, kv, paged):
    """No low-rank correction: the draft is the model and the verify is
    read-only, so parity is structural."""
    _, _, model = fp
    kw = dict(kv_dtype=kv, **(dict(paged=True, page_size=8) if paged else {}))
    plain, spec, eng = _spec_vs_plain(model, **kw)
    _same(plain, spec, f"kv={kv} paged={paged}")
    assert not eng._spec_store
    st = eng.stats()
    assert st["spec_rounds"] >= 1
    assert st["spec_accepted_tokens"] <= st["spec_draft_tokens"]
    if paged:
        _assert_pool_conserved(eng)


@pytest.mark.parametrize("kv", ["f32", "bf16", "int8", "int4"])
def test_spec_parity_quantized_paged(quantized, kv):
    """Q + LR: the draft skips the LR, rejections and the post-rejection
    plain step dominate, and the verify upgrades the drafts' K/V."""
    _, _, model = quantized
    plain, spec, eng = _spec_vs_plain(model, kv_dtype=kv, paged=True,
                                      page_size=8, nreq=3)
    _same(plain, spec, f"kv={kv}")
    assert eng._spec_store
    st = eng.stats()
    assert st["spec_rounds"] >= 1
    assert st["spec_accepted_tokens"] < st["spec_draft_tokens"]
    _assert_pool_conserved(eng)


@pytest.mark.parametrize("fused", ["on", "off"])
def test_spec_parity_quantized_fused_modes(quantized, fused):
    _, _, model = quantized
    plain, spec, _ = _spec_vs_plain(model, kv_dtype="int4", paged=True,
                                    page_size=8, fused=fused, nreq=3)
    _same(plain, spec, f"fused={fused}")


def test_spec_parity_quantized_unpaged(quantized):
    _, _, model = quantized
    plain, spec, eng = _spec_vs_plain(model, kv_dtype="int8", nreq=3)
    _same(plain, spec, "unpaged int8")
    assert eng.stats()["spec_rounds"] >= 1


# --------------------------------------------------------------------------
# against the JAX engine
# --------------------------------------------------------------------------
SPEC_COUNTERS = ("spec_rounds", "spec_draft_tokens", "spec_accepted_tokens")


@pytest.mark.parametrize("which,kv,paged", [("fp", "f32", True),
                                            ("quantized", "bf16", False),
                                            ("quantized", "int4", True)])
def test_spec_matches_jax_engine(request, which, kv, paged):
    jcfg, params, model = request.getfixturevalue(which)
    kw = _sc(kv_dtype=kv, speculative=True, spec_k=4,
             **(dict(paged=True, page_size=8) if paged else {}))
    sp = [None, SamplingParams(logprobs=2), None, None]
    jeng = JEngine(params, jcfg, JServeConfig(**kw))
    want = jeng.generate(_reqs(4, cls=JRequest))
    eng = Engine(model, model.cfg, ServeConfig(**kw), device="cpu")
    got = eng.generate(_reqs(4, params=sp))
    _same(got, want, f"{which} kv={kv} paged={paged}")
    js, ts = jeng.stats(), eng.stats()
    assert [ts[k] for k in SPEC_COUNTERS] == [js[k] for k in SPEC_COUNTERS]
    assert ts["spec_rounds"] >= 1
    # one histogram observation a lane a round, of its accepted drafts
    hist = ts["spec_accept_per_round"]
    assert hist["count"] >= ts["spec_rounds"]
    assert hist["sum"] == ts["spec_accepted_tokens"]
    assert hist["count"] == js["spec_accept_per_round"]["count"]


def test_spec_moe_matches_plain_and_jax():
    """Reduced deepseek-moe: the router and shared experts run at rank 0
    in the draft, the routed experts keep their LR (JAX's expert path
    never reads the draft flag)."""
    jcfg, params, model = _models("deepseek-moe-16b", quantize=True)
    kw = dict(max_len=48, decode_batch=3, max_new_tokens=8, prefill_len=16,
              kv_dtype="bf16")
    plain = Engine(model, model.cfg, ServeConfig(**kw),
                   device="cpu").generate(_reqs(3))
    spec_kw = dict(kw, speculative=True, spec_k=3)
    eng = Engine(model, model.cfg, ServeConfig(**spec_kw), device="cpu")
    got = eng.generate(_reqs(3))
    _same(got, plain, "moe spec vs plain")
    jeng = JEngine(params, jcfg, JServeConfig(**spec_kw))
    want = jeng.generate(_reqs(3, cls=JRequest))
    _same(got, want, "moe spec vs jax")
    js, ts = jeng.stats(), eng.stats()
    assert [ts[k] for k in SPEC_COUNTERS] == [js[k] for k in SPEC_COUNTERS]
    assert ts["spec_rounds"] >= 1


@pytest.mark.parametrize("fused", ["on", "off"])
def test_draft_linear_is_rank0_as_jax(quantized, fused):
    jcfg, params, model = quantized
    jp = jax.tree_util.tree_map(lambda a: a[0],
                                params["groups"]["p0"]["mixer"]["wq"])
    x = np.random.default_rng(1).standard_normal((3, jcfg.d_model)) \
        .astype(np.float32)
    p = model.blocks[0].mixer.wq
    assert p.l.shape[1] > 0
    for draft in (False, True):
        want = np.asarray(jlinear(JCtx(fused=fused, draft=draft), jp,
                                  jnp.asarray(x)))
        got = linear(Ctx(fused=fused, draft=draft), p, torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
    full = linear(Ctx(fused=fused), p, torch.from_numpy(x))
    q_only = linear(Ctx(fused=fused, draft=True), p, torch.from_numpy(x))
    assert not torch.allclose(full, q_only)


# verify_chunk: (store, paged, kv); the prompt fills [0, 11), the chunk
# scores 4 tokens at 11 (an odd start: the int4 read-modify-write keeps
# position 10's nibble)
VERIFY = [(True, False, "int4"), (True, True, "int8"),
          (False, False, "bf16"), (False, True, "int4")]


@pytest.mark.parametrize("store,paged,kv", VERIFY)
def test_verify_chunk_matches_jax(quantized, store, paged, kv):
    jcfg, params, model = quantized
    jdt, tdt = KV[kv]
    max_len, row, c = 32, 1, 16
    rng = np.random.default_rng(7)
    prompt = rng.integers(0, 256, 11).astype(np.int32)
    fed = rng.integers(0, 256, (1, 4)).astype(np.int32)
    pages = dict(pages=12, page_size=8) if paged else {}
    jc = jinit_cache(jcfg, 2, max_len, dtype=jdt, **pages)
    tc = init_cache(model.cfg, 2, max_len, tdt, "cpu", **pages)
    if paged:
        table = [5, 2, 9, 0]
        jc = jset_row(jc, jnp.int32(row), jnp.asarray(table, jnp.int32),
                      jnp.int32(0))
        set_block_table_row(tc, row, torch.tensor(table, dtype=torch.int32),
                            0)
    toks = np.zeros((1, c), np.int32)
    toks[0, :11] = prompt
    _, jc = jax.jit(lambda p, t, cc: jprefill_chunk(
        JCtx(), p, t, jcfg, cc, jnp.int32(row), jnp.int32(0),
        jnp.int32(11)))(params, jnp.asarray(toks), jc)
    _, tc = prefill_chunk(Ctx(), model, torch.from_numpy(toks).long(), tc,
                          row, 0, 11)
    before = [{k: v.clone() for k, v in layer.items()} for layer in tc]
    jl, jc = jax.jit(lambda p, t, cc: jverify_chunk(
        JCtx(), p, t, jcfg, cc, jnp.int32(row), jnp.int32(11), jnp.int32(4),
        store=store))(params, jnp.asarray(fed), jc)
    tl, tc = verify_chunk(Ctx(), model, torch.from_numpy(fed).long(), tc,
                          row, 11, 4, store=store)
    jl = np.asarray(jl)
    assert tl.shape == jl.shape == (1, 4, jcfg.vocab)
    np.testing.assert_allclose(tl.numpy(), jl, rtol=0,
                               atol=1e-4 * np.abs(jl).max())
    jpos = np.asarray(jc["groups"]["p0"]["pos"])                # (L, B)
    for i, layer in enumerate(tc):
        np.testing.assert_array_equal(layer["pos"].numpy(), jpos[i])
        assert int(layer["pos"][row]) == (15 if store else 11)
        if not store:
            for key, t in layer.items():
                assert torch.equal(t, before[i][key]), key


# --------------------------------------------------------------------------
# engine semantics
# --------------------------------------------------------------------------
def test_spec_stop_token_in_accepted_window(fp):
    """A stop token inside the accepted window truncates right there with
    finish_reason='stop', as plain decode retires."""
    _, _, model = fp
    probe = _engine(model).generate(_reqs(1))
    stop = int(probe[0].tokens[3])
    cut = probe[0].tokens.tolist().index(stop)
    sp = [SamplingParams(stop=(stop,), max_new_tokens=12)]
    eng = _engine(model, speculative=True, spec_k=6)
    res = eng.generate(_reqs(1, params=sp))
    assert res[0].finish_reason == "stop" and res[0].tokens[-1] == stop
    assert res[0].tokens.tolist() == probe[0].tokens[:cut + 1].tolist()
    assert eng.stats()["spec_rounds"] >= 1


def test_spec_sampled_lanes_fall_back(fp):
    """Temperature lanes decode per token: an all-sampled batch, and one
    with a single sampled lane, run no round and match plain decode."""
    _, _, model = fp
    for sp in ([SamplingParams(temperature=0.8, seed=7 + i)
                for i in range(3)],
               [None, SamplingParams(temperature=1.1, seed=3), None]):
        plain, spec, eng = _spec_vs_plain(model, nreq=3, params=sp)
        _same(plain, spec, "sampled lanes")
        assert eng.stats()["spec_rounds"] == 0


def test_spec_respects_step_budget(fp):
    """Draft and verify passes are charged against max_step_tokens: at 17
    (prefill width + 1) a 3-lane k=4 round costs 3 + 9 + 12 = 24 > 17,
    so rounds run only while at most 2 lanes decode — and the output
    still equals the unbudgeted plain engine's."""
    _, _, model = fp
    ref = _engine(model).generate(_reqs(3))
    tight = _engine(model, speculative=True, spec_k=4, max_step_tokens=17)
    _same(ref, tight.generate(_reqs(3)), "tight budget")
    st = tight.stats()
    assert st["spec_draft_tokens"] <= 2 * 3 * st["spec_rounds"]
    roomy = _engine(model, speculative=True, spec_k=4, max_step_tokens=64)
    _same(ref, roomy.generate(_reqs(3)), "roomy budget")
    assert roomy.stats()["spec_rounds"] >= 1


def test_spec_logprobs_cover_every_token(fp):
    _, _, model = fp
    sp = [SamplingParams(logprobs=2) for _ in range(2)]
    eng = _engine(model, speculative=True, spec_k=4, decode_batch=2)
    infos = {}
    eng.on_token = lambda uid, tok, info: \
        infos.setdefault(uid, []).append((tok, info))
    res = eng.generate(_reqs(2, params=sp))
    assert eng.stats()["spec_rounds"] >= 1
    for r in res:
        recs = infos[r.uid]
        assert [t for t, _ in recs] == r.tokens.tolist()
        for tok, info in recs:
            assert isinstance(info["logprob"], float)
            assert len(info["top_logprobs"]) == 2
            top_tok, top_lp = info["top_logprobs"][0]
            assert top_tok == tok                  # greedy: the argmax
            assert abs(top_lp - info["logprob"]) < 1e-6


def test_spec_abort_between_rounds_conserves_pages(quantized):
    _, _, model = quantized
    eng = _engine(model, speculative=True, spec_k=4, paged=True,
                  page_size=8, max_new_tokens=16)
    for r in _reqs(4, budget=16):
        eng.submit(r)
    done = []
    for _ in range(2):
        done.extend(eng.step())
    assert eng.stats()["spec_rounds"] >= 1
    res = eng.abort(1)
    assert res is not None and res.finish_reason == "abort"
    done.append(res)
    done.extend(eng.drain())
    assert sorted(r.uid for r in done) == [0, 1, 2, 3]
    _assert_pool_conserved(eng)


def test_spec_config_checks(fp):
    _, _, model = fp
    with pytest.raises(ValueError, match="spec_k"):
        _engine(model, speculative=True, spec_k=1)
    with pytest.raises(ValueError, match="continuous"):
        _engine(model, speculative=True, scheduler="bucketed")
