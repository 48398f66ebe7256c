"""Port parity for the engine's request surface against the JAX engine
(``repro.serve.Engine``), both serving the same JAX-SRR-quantized params
(reduced phi3, converted):

* sampled lanes (temperature, top-k, top-p, mixed with greedy lanes)
  token-identical under the continuous scheduler, unpaged and paged, and
  under the bucketed baseline; logprob ids identical and values within
  1e-5 · max(1, |value|); per-request stop ids with
  ``finish_reason="stop"``;
* ``abort`` while queued, while decoding, and mid-chunked-prefill with a
  prefix match (page refcounts conserved, pool state equal to JAX's);
* the bucketed scheduler against the continuous one under sampling, seed
  determinism, ``on_token`` against ``Result``, the ``max_new_tokens``
  shim and the validation errors.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core.api import PTQConfig as JPTQConfig
from repro.models import init_lm as jinit_lm
from repro.models.quantize import quantize_model_params as jquantize
from repro.quant.base import QuantizerConfig
from repro.serve import Engine as JEngine
from repro.serve import Request as JRequest
from repro.serve import SamplingParams as JSamplingParams
from repro.serve import ServeConfig as JServeConfig
from repro_torch.configs import get_config
from repro_torch.convert import convert_params
from repro_torch.serve import Engine, Request, SamplingParams, ServeConfig

COMMON = dict(max_len=48, decode_batch=3, prefill_len=16, kv_dtype="bf16",
              max_new_tokens=10)
MODES = {"continuous": {}, "paged": dict(paged=True, page_size=8),
         "bucketed": dict(scheduler="bucketed")}
# one request of each kind; request 0 (greedy) gets a stop id below
SAMPLING = [dict(logprobs=5), dict(temperature=0.8, seed=3),
            dict(temperature=1.0, top_p=0.9),
            dict(temperature=0.7, top_k=11, logprobs=3), dict(logprobs=2),
            dict(temperature=1.2, top_k=5, top_p=0.8)]


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
    jcfg = jget_config("phi3-mini-3.8b").reduced()
    ptq = JPTQConfig(method="srr", rank=8, exact_svd=True, forced_k=3,
                     quantizer=QuantizerConfig(kind="mxint", bits=3,
                                               block_size=32))
    qparams, _ = jquantize(jinit_lm(jax.random.PRNGKey(2), jcfg), None, ptq)
    model = convert_params(jax.tree_util.tree_map(np.asarray, qparams),
                           get_config("phi3-mini-3.8b").reduced(), device="cpu")
    return jcfg, qparams, model


def _prompts(n, base=4):
    rng = np.random.default_rng(5)
    return [rng.integers(0, 256, size=base + (3 * i) % 9).astype(np.int32)
            for i in range(n)]


def _engine(model, **kw):
    return Engine(model, model.cfg, ServeConfig(**dict(COMMON, **kw)),
                  device="cpu")


def _requests(req_cls, sp_cls, sampling, budget=None):
    return [req_cls(uid=i, prompt=p, max_new_tokens=budget,
                    params=sp_cls(**sp) if sp is not None else None)
            for i, (p, sp) in enumerate(zip(_prompts(len(sampling)),
                                            sampling))]


def _stream(eng):
    recs = {}
    eng.on_token = lambda uid, tok, info: recs.setdefault(uid, []).append(
        (tok, info))
    return recs


@pytest.fixture(scope="module")
def stop_id(quantized):
    """A token request 0 (greedy) emits at index 3: its stop id."""
    _, _, model = quantized
    probe = _engine(model).generate(_requests(Request, SamplingParams,
                                              SAMPLING), seed=4)
    return int(probe[0].tokens[3])


@pytest.mark.parametrize("mode", sorted(MODES))
def test_sampled_lanes_identical_to_jax(quantized, stop_id, mode):
    jcfg, qparams, model = quantized
    sampling = [dict(SAMPLING[0], stop=(stop_id,))] + SAMPLING[1:]
    jeng = JEngine(qparams, jcfg, JServeConfig(**COMMON, **MODES[mode]))
    eng = _engine(model, **MODES[mode])
    jrecs, recs = _stream(jeng), _stream(eng)
    want = jeng.generate(_requests(JRequest, JSamplingParams, sampling),
                         seed=4)
    got = eng.generate(_requests(Request, SamplingParams, sampling), seed=4)
    assert [r.uid for r in got] == [r.uid for r in want]
    for g, w in zip(got, want):
        assert g.tokens.tolist() == w.tokens.tolist(), (mode, g.uid)
        assert g.finish_reason == w.finish_reason, (mode, g.uid)
    assert got[0].finish_reason == "stop" and got[0].tokens[-1] == stop_id
    assert all(r.finish_reason == "length" for r in got[1:])
    if mode == "bucketed":
        assert not recs           # the baseline streams nothing
        return
    assert recs.keys() == jrecs.keys()
    for uid in recs:
        assert [t for t, _ in recs[uid]] == [t for t, _ in jrecs[uid]]
        for (_, info), (_, jinfo) in zip(recs[uid], jrecs[uid]):
            if jinfo is None:
                assert info is None
                continue
            # values within 1e-5 of their scale: the two frameworks'
            # logits already differ in the sixth significant digit
            got_v = [info["logprob"]] + [v for _, v in info["top_logprobs"]]
            want_v = [jinfo["logprob"]] \
                + [v for _, v in jinfo["top_logprobs"]]
            np.testing.assert_allclose(got_v, want_v, rtol=1e-5, atol=1e-5)
            assert [i for i, _ in info["top_logprobs"]] \
                == [i for i, _ in jinfo["top_logprobs"]]
            assert len(info["top_logprobs"]) == sampling[uid]["logprobs"]
            top1 = info["top_logprobs"][0][1]
            assert info["logprob"] <= top1 + 1e-6 and top1 <= 0.0


def test_continuous_matches_bucketed_with_sampling(quantized):
    _, _, model = quantized
    cont = _engine(model).generate(
        _requests(Request, SamplingParams, SAMPLING), seed=9)
    buck = _engine(model, scheduler="bucketed").generate(
        _requests(Request, SamplingParams, SAMPLING), seed=9)
    for c, b in zip(cont, buck):
        assert c.uid == b.uid
        assert c.tokens.tolist() == b.tokens.tolist()
        assert c.finish_reason == b.finish_reason
    assert _engine(model, scheduler="bucketed").stats()["admitted"] == 0


def test_seed_determinism(quantized):
    _, _, model = quantized
    eng = _engine(model)
    sp = [dict(temperature=1.0)] * 3
    a = eng.generate(_requests(Request, SamplingParams, sp), seed=1)
    b = eng.generate(_requests(Request, SamplingParams, sp), seed=1)
    c = eng.generate(_requests(Request, SamplingParams, sp), seed=2)
    assert [r.tokens.tolist() for r in a] == [r.tokens.tolist() for r in b]
    assert [r.tokens.tolist() for r in a] != [r.tokens.tolist() for r in c]
    # an explicit SamplingParams.seed wins over the run's base seed
    sp = [dict(temperature=1.0, seed=42)] * 3
    d = eng.generate(_requests(Request, SamplingParams, sp), seed=1)
    e = eng.generate(_requests(Request, SamplingParams, sp), seed=2)
    assert [r.tokens.tolist() for r in d] == [r.tokens.tolist() for r in e]


def test_top_k1_is_greedy_and_top_p1_is_off(quantized):
    _, _, model = quantized
    greedy = _engine(model).generate(_requests(Request, SamplingParams,
                                               [None] * 3))
    k1 = _engine(model).generate(_requests(
        Request, SamplingParams, [dict(temperature=1.3, top_k=1)] * 3))
    assert [r.tokens.tolist() for r in k1] \
        == [r.tokens.tolist() for r in greedy]
    runs = [_engine(model).generate(_requests(Request, SamplingParams,
                                              [dict(temperature=0.9, **kw)]
                                              * 3), seed=11)
            for kw in ({}, dict(top_p=1.0), dict(top_k=256), dict(top_p=0.5))]
    toks = [[r.tokens.tolist() for r in run] for run in runs]
    assert toks[0] == toks[1] == toks[2] and toks[3] != toks[0]


def test_on_token_matches_results(quantized):
    _, _, model = quantized
    eng = _engine(model, paged=True, page_size=8)
    recs = _stream(eng)
    res = eng.generate(_requests(Request, SamplingParams, SAMPLING), seed=4)
    for r in res:
        assert [t for t, _ in recs[r.uid]] == r.tokens.tolist()
        want_info = SAMPLING[r.uid].get("logprobs") is not None
        assert all((info is not None) == want_info for _, info in recs[r.uid])


def test_max_new_tokens_shim(quantized):
    _, _, model = quantized
    prompts = _prompts(3)
    reqs = [Request(uid=0, prompt=prompts[0], max_new_tokens=3),
            Request(uid=1, prompt=prompts[1], max_new_tokens=3,
                    params=SamplingParams(max_new_tokens=5)),
            Request(uid=2, prompt=prompts[2],
                    params=SamplingParams(temperature=0.5))]
    for mode in ("continuous", "bucketed"):
        res = _engine(model, **MODES[mode]).generate(reqs)
        assert [len(r.tokens) for r in res] == [3, 5, COMMON["max_new_tokens"]]


def test_validation_errors(quantized):
    _, _, model = quantized
    eng = _engine(model)
    for sp in (SamplingParams(temperature=-1.0), SamplingParams(top_p=0.0),
               SamplingParams(top_k=-2), SamplingParams(max_new_tokens=-1),
               SamplingParams(logprobs=6)):
        with pytest.raises(ValueError, match="request 0"):
            eng.submit(Request(uid=0, prompt=np.zeros((3,), np.int32),
                               params=sp))
    with pytest.raises(ValueError, match="scheduler"):
        _engine(model, scheduler="fifo")
    with pytest.raises(ValueError, match="continuous"):
        _engine(model, scheduler="bucketed", paged=True)
    with pytest.raises(RuntimeError, match="continuous"):
        _engine(model, scheduler="bucketed").submit(
            Request(uid=0, prompt=np.zeros((3,), np.int32)))


# --------------------------------------------------------------------------
# abort
# --------------------------------------------------------------------------
def _abort_script(eng, req_cls):
    """Submit 4 requests into 3 lanes, step once, abort the queued one
    (3) and a decoding one (0), then drain."""
    for r in _requests(req_cls, lambda **kw: None, [None] * 4, budget=8):
        eng.submit(r)
    eng.step()
    res_q = eng.abort(3)
    res_d = eng.abort(0)
    return res_q, res_d, eng.abort(99), eng.drain()


def test_abort_queued_and_decoding_matches_jax(quantized):
    jcfg, qparams, model = quantized
    jeng = JEngine(qparams, jcfg, JServeConfig(**COMMON))
    eng = _engine(model)
    want, got = _abort_script(jeng, JRequest), _abort_script(eng, Request)
    for g, w in zip(got[:2], want[:2]):
        assert g.uid == w.uid and g.finish_reason == w.finish_reason == "abort"
        assert g.tokens.tolist() == w.tokens.tolist()
    assert len(got[0].tokens) == 0 and len(got[1].tokens) >= 1
    assert got[2] is None
    assert [(r.uid, r.tokens.tolist()) for r in got[3]] \
        == [(r.uid, r.tokens.tolist()) for r in want[3]] and \
        [r.uid for r in got[3]] == [1, 2]
    assert eng.stats()["aborted"] == 2


def _prefill_abort_script(eng, req_cls):
    """Abort mid-chunked-prefill: first with no prefix match, then with
    three matched pages; returns the pool's state after each."""
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, 256, size=30).astype(np.int32)
    eng.submit(req_cls(uid=0, prompt=prompt))
    eng.step()                       # admit + the first chunk (8 of 30)
    assert eng._prefill_jobs
    res0 = eng.abort(0)
    after0 = (eng.pool.n_hot, eng.pool.n_cold, eng.pool.n_free)
    eng.generate([req_cls(uid=1, prompt=prompt.copy())])  # 3 blocks cached
    tail = rng.integers(0, 256, size=30).astype(np.int32)
    eng.submit(req_cls(uid=2, prompt=np.concatenate([prompt[:24], tail])))
    eng.step()
    job = next(iter(eng._prefill_jobs.values()))
    matched = job.matched_tokens
    res2 = eng.abort(2)
    after2 = (eng.pool.n_hot, eng.pool.n_cold, eng.pool.n_free)
    refs = sum(eng.pool.refcount(p) for p in range(eng.pool.n_pages))
    return res0, res2, after0, after2, matched, refs


def test_abort_mid_prefill_conserves_refcounts_as_jax(quantized):
    jcfg, qparams, model = quantized
    kw = dict(COMMON, paged=True, page_size=8, max_len=160, prefill_len=8,
              max_new_tokens=8)
    want = _prefill_abort_script(JEngine(qparams, jcfg, JServeConfig(**kw)),
                                 JRequest)
    eng = Engine(model, model.cfg, ServeConfig(**kw), device="cpu")
    got = _prefill_abort_script(eng, Request)
    for res in got[:2]:
        assert res.finish_reason == "abort" and len(res.tokens) == 0
    assert got[2:] == want[2:]
    assert got[4] == 24                              # three pages matched
    assert got[2][0] == got[3][0] == eng.sc.decode_batch   # parked only
    assert got[3][1] == 3                            # the match released
    assert got[5] == eng.sc.decode_batch
    assert not eng._prefill_jobs
