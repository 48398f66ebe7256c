"""Port parity for the paged slice: the paged cache, prefix reuse, chunked
prefill and the token budget of ``repro_torch`` against the JAX package.

* K5's plain version (``decode_attention_op(block_table=...)`` on CPU
  tensors) against the JAX Pallas kernel in interpret mode and the jnp
  oracle, on a shuffled block table: f32 math on both sides, 2e-5 on
  outputs of magnitude ~1 covers summation-order noise.
* ``prefill_chunk`` / ``attention_chunk`` against JAX on converted
  SRR-quantized params: logits within 1e-4 · max|logit| (f32 compute on
  both sides; bf16 KV: 2e-3 · max|logit|, since the two frameworks round
  the stored context to bf16 separately, as in test_torch_model.py), the
  pools to f32/bf16 noise and int pools to one quantization step. On
  identical chunk K/V the stored pools — int codes, scales, packed4
  nibbles — are bit-exact.
* ``PagePool``, ``RadixPrefixCache`` and ``StepBudget`` against JAX's on
  one scripted sequence: every page id and every decision identical.
* The engines: greedy tokens identical to the JAX paged engine and to
  the port's unpaged engine; chunk and prefix counters equal to JAX's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core.api import PTQConfig as JPTQConfig
from repro.kernels import ops as jops
from repro.kernels.ref import decode_attention_ref
from repro.models import Ctx as JCtx
from repro.models import init_cache as jinit_cache
from repro.models import init_lm as jinit_lm
from repro.models import prefill_chunk as jprefill_chunk
from repro.models.quantize import quantize_model_params as jquantize
from repro.quant.base import QuantizerConfig
from repro.quant.mxint import pack_codes_4bit
from repro.serve import Engine as JEngine
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro.serve.pages import PagePool as JPagePool
from repro.serve.pages import set_block_table_row as jset_row
from repro.serve.prefix import RadixPrefixCache as JRadixPrefixCache
from repro.serve.scheduler import StepBudget as JStepBudget
from repro_torch.configs import get_config
from repro_torch.convert import convert_params
from repro_torch.kernels.decode_attention import (decode_attention_op,
                                                  gather_pages)
from repro_torch.models import Ctx, init_cache, prefill_chunk
from repro_torch.quant.mxint import unpack_codes_4bit
from repro_torch.serve import Engine, Request, ServeConfig
from repro_torch.serve.pages import PagePool, set_block_table_row
from repro_torch.serve.prefix import RadixPrefixCache
from repro_torch.serve.scheduler import StepBudget

KV = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16),
      "int8": (jnp.int8, torch.int8), "int4": ("int4", "int4")}


def _t(a):
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


# ---------------------------------------------------------------------------
# K5's plain version
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("container", ["f32", "int8", "int4"])
def test_paged_decode_plain_matches_jax(container, window=9):
    rng = np.random.default_rng(11)
    b, kv, g, hd, ps, nb, pages = 3, 2, 2, 16, 8, 4, 14
    q = rng.normal(size=(b, kv, g, hd)).astype(np.float32)
    q_pos = np.array([3, 17, 31], np.int32)
    k_pos = np.broadcast_to(np.arange(nb * ps, dtype=np.int32)[None],
                            (b, nb * ps)).copy()
    bt = rng.permutation(pages)[:b * nb].reshape(b, nb).astype(np.int32)
    ks = vs = None
    if container == "f32":
        k = rng.normal(size=(pages, kv, ps, hd)).astype(np.float32)
        v = rng.normal(size=(pages, kv, ps, hd)).astype(np.float32)
    else:
        hi = 128 if container == "int8" else 8
        k = rng.integers(-hi + 1, hi, size=(pages, kv, ps, hd)).astype(np.int8)
        v = rng.integers(-hi + 1, hi, size=(pages, kv, ps, hd)).astype(np.int8)
        ks = rng.uniform(0.01, 0.1, size=(pages, kv, ps)).astype(np.float32)
        vs = rng.uniform(0.01, 0.1, size=(pages, kv, ps)).astype(np.float32)
        if container == "int4":
            k = np.asarray(pack_codes_4bit(jnp.asarray(k)))
            v = np.asarray(pack_codes_4bit(jnp.asarray(v)))
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    want = np.asarray(jops.decode_attention_op(
        j(q), j(k), j(v), j(q_pos), j(k_pos), k_scale=j(ks), v_scale=j(vs),
        window=window, kernel=True, block_table=j(bt)))
    oracle = np.asarray(decode_attention_ref(
        j(q), j(k), j(v), j(q_pos), j(k_pos), j(ks), j(vs), window=window,
        block_table=j(bt)))
    t = lambda a: None if a is None else _t(a)  # noqa: E731
    got = decode_attention_op(t(q), t(k), t(v), t(q_pos), t(k_pos),
                              k_scale=t(ks), v_scale=t(vs), window=window,
                              block_table=t(bt)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, oracle, rtol=2e-5, atol=2e-5)
    np.testing.assert_array_equal(
        gather_pages(t(k), t(bt)).numpy(),
        np.asarray(jops.gather_pages(j(k), j(bt))))


# ---------------------------------------------------------------------------
# prefill_chunk / attention_chunk on converted params
# ---------------------------------------------------------------------------
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
    qparams, _ = jquantize(jinit_lm(jax.random.PRNGKey(4), jcfg), None, ptq)
    model = convert_params(jax.tree_util.tree_map(np.asarray, qparams),
                           get_config("phi3-mini-3.8b").reduced(), device="cpu")
    return jcfg, qparams, model


def _jax_layers(cache):
    """The JAX cache's per-layer dicts in depth order (groups unstacked)."""
    out = list(cache["prefix"])
    if cache["groups"]:
        period = len(cache["groups"])
        n = next(iter(cache["groups"]["p0"].values())).shape[0]
        for i in range(n):
            for p in range(period):
                out.append({k: v[i] for k, v in
                            cache["groups"][f"p{p}"].items()})
    return out + list(cache["suffix"])


# (max_len, rows' block tables, chunks as (row, prompt slice start, length))
# multi-chunk: a 40-token prompt in 16-wide chunks; overhang: the final
# chunk [16, 32) overhangs a 24-slot table; prefix offset: row 1 maps row
# 0's first two pages and prefills from position 16
CASES = {
    "multi_chunk": (48, {0: [5, 2, 9, 0, 7, 3]},
                    [(0, 0, 16), (0, 16, 16), (0, 32, 8)]),
    "overhang": (24, {0: [4, 1, 6]}, [(0, 0, 16), (0, 16, 4)]),
    "prefix_offset": (32, {0: [3, 8, 1, 6], 1: [3, 8, 10, 2]},
                      [(0, 0, 16), (0, 16, 5), (1, 16, 11)]),
}


@pytest.mark.parametrize("kv", ["f32", "bf16", "int8", "int4"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_prefill_chunk_matches_jax(quantized, kv, case):
    jcfg, qparams, model = quantized
    max_len, tables, chunks = CASES[case]
    jdt, tdt = KV[kv]
    ps, n_pages, c = 8, 12, 16
    rng = np.random.default_rng(len(case))
    prompts = {r: rng.integers(0, jcfg.vocab, 48).astype(np.int32)
               for r in tables}
    prompts[1 if 1 in tables else 0][:16] = prompts[0][:16]  # shared prefix
    jcache = jinit_cache(jcfg, 2, max_len, dtype=jdt, pages=n_pages,
                         page_size=ps)
    tcache = init_cache(model.cfg, 2, max_len, tdt, "cpu", pages=n_pages,
                        page_size=ps)
    for row, pages in tables.items():
        start = chunks[[r for r, _, _ in chunks].index(row)][1]
        jcache = jset_row(jcache, jnp.int32(row), jnp.asarray(pages, jnp.int32),
                          jnp.int32(start))
        set_block_table_row(tcache, row, torch.tensor(pages, dtype=torch.int32),
                            start)
    jctx = JCtx(fused="auto")
    jchunk = jax.jit(lambda p, t, cc, r, s, n: jprefill_chunk(
        jctx, p, t, jcfg, cc, r, s, n))
    tol = 2e-3 if kv == "bf16" else 1e-4
    for row, start, length in chunks:
        toks = np.zeros((1, c), np.int32)
        toks[0, :length] = prompts[row][start:start + length]
        jl, jcache = jchunk(qparams, jnp.asarray(toks), jcache, jnp.int32(row),
                            jnp.int32(start), jnp.int32(length))
        tl, tcache = prefill_chunk(Ctx(), model, torch.from_numpy(toks).long(),
                                   tcache, row, start, length)
        jl = np.asarray(jl)
        np.testing.assert_allclose(tl.numpy(), jl, rtol=0,
                                   atol=tol * np.abs(jl).max())
    for jl_, tl_ in zip(_jax_layers(jcache), tcache):
        np.testing.assert_array_equal(tl_["pos"].numpy(), np.asarray(jl_["pos"]))
        np.testing.assert_array_equal(tl_["block_table"].numpy(),
                                      np.asarray(jl_["block_table"]))
        for key in ("k", "v"):
            if kv in ("int8", "int4"):
                # codes can differ by one step where the two frameworks'
                # f32 K/V (summation order, RoPE ulps) straddle a
                # rounding tie: compare the dequantized pools to one step
                # here; test_attention_chunk_store_bit_exact holds the
                # codes bit-exact on identical K/V
                tsc, jsc = tl_[key + "_scale"], np.asarray(jl_[key + "_scale"])
                np.testing.assert_allclose(tsc.numpy(), jsc, rtol=1e-5,
                                           atol=0)
                tq = _dequant(tl_[key], tsc)
                jq = _dequant(_t(jl_[key]), _t(jsc))
                np.testing.assert_allclose(tq, jq, rtol=0,
                                           atol=1.01 * float(jsc.max()))
            else:
                np.testing.assert_allclose(
                    _np(tl_[key]), np.asarray(jl_[key]).astype(np.float32),
                    rtol=0, atol=1e-5 if kv == "f32" else 2 ** -7)


def _dequant(codes, scale):
    if codes.dtype == torch.uint8:
        codes = unpack_codes_4bit(codes)
    return (codes.float() * scale[..., None]).numpy()


# the storage path on identical K/V: _qkv patched in both packages to hand
# the same chunk q/k/v to attention_chunk. Starts of any parity exercise the
# packed4 read-modify-write (a boundary byte keeps its partner nibble)
STORE_CASES = {
    "odd_starts": (48, {0: [8, 6, 1, 11, 2, 4]},
                   [(0, 0, 5), (0, 5, 16), (0, 21, 6), (0, 27, 1)]),
    "overhang": (24, {0: [4, 1, 6]}, [(0, 0, 16), (0, 16, 4)]),
    "shared": (32, {0: [3, 8, 1, 6], 1: [3, 8, 10, 2]},
               [(0, 0, 16), (1, 16, 9), (0, 16, 7)]),
}


@pytest.mark.parametrize("kv", ["f32", "bf16", "int8", "int4"])
@pytest.mark.parametrize("case", sorted(STORE_CASES))
def test_attention_chunk_store_bit_exact(monkeypatch, kv, case):
    import repro.models.attention as jattn
    import repro_torch.models.attention as tattn
    from repro_torch.models.linear import FpLinear

    jcfg = jget_config("phi3-mini-3.8b").reduced()
    cfg = get_config("phi3-mini-3.8b").reduced()
    max_len, tables, chunks = STORE_CASES[case]
    jdt, tdt = KV[kv]
    ps, n_pages, c = 8, 12, 16
    kvh, g, hd = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.head_dim_
    rng = np.random.default_rng(len(case) + len(kv))
    wo = rng.normal(size=(cfg.n_heads * hd, cfg.d_model)).astype(np.float32)
    qkv = {}
    for row, start, _ in chunks:
        qkv[start] = (rng.normal(size=(1, c, kvh, g, hd)).astype(np.float32),
                      rng.normal(size=(1, c, kvh, hd)).astype(np.float32),
                      rng.normal(size=(1, c, kvh, hd)).astype(np.float32))
    monkeypatch.setattr(jattn, "_qkv", lambda ctx, p, x, cfg_, pos, *a: tuple(
        jnp.asarray(t) for t in qkv[int(pos[0])]))
    monkeypatch.setattr(tattn, "_qkv", lambda ctx, p, x, cfg_, pos: tuple(
        torch.from_numpy(t) for t in qkv[int(pos[0])]))

    jc = jattn.init_attn_cache(jcfg, 2, max_len, False, dtype=jdt,
                               pages=n_pages, page_size=ps)
    tc = tattn.init_attn_cache(cfg, 2, max_len, tdt, "cpu", pages=n_pages,
                               page_size=ps)
    for row, pages in tables.items():
        jc["block_table"] = jc["block_table"].at[row].set(
            jnp.asarray(pages, jnp.int32))
        tc["block_table"][row] = torch.tensor(pages, dtype=torch.int32)
    blk = tattn.Attention(None, None, None, FpLinear(torch.from_numpy(wo)))
    x = np.zeros((1, c, cfg.d_model), np.float32)
    for row, start, length in chunks:
        jy, jc = jattn.attention_chunk(JCtx(), {"wo": {"w": jnp.asarray(wo)}},
                                       jnp.asarray(x), jc, jcfg,
                                       jnp.int32(row), jnp.int32(start),
                                       jnp.int32(length))
        ty, tc = tattn.attention_chunk(Ctx(), blk, torch.from_numpy(x), tc,
                                       cfg, row, start, length)
        jy = np.asarray(jy)[0, :length]
        np.testing.assert_allclose(ty.numpy()[0, :length], jy, rtol=0,
                                   atol=1e-5 * np.abs(jy).max())
    assert set(tc) == set(jc)
    for key in tc:
        np.testing.assert_array_equal(_np(tc[key]),
                                      np.asarray(jc[key]).astype(
                                          _np(tc[key]).dtype))


# ---------------------------------------------------------------------------
# host-side allocator, prefix tree and budget: identical decisions
# ---------------------------------------------------------------------------
def _script(pool_cls, tree_cls, budget_cls):
    """One scripted run of alloc/incref/decref/match/insert/evict and
    try_take; returns everything each call decided."""
    log = []
    pool = pool_cls(12, 4)
    tree = tree_cls(pool)
    rng = np.random.default_rng(0)
    a = rng.integers(0, 50, 17).astype(np.int32)
    b = np.concatenate([a[:8], rng.integers(0, 50, 6).astype(np.int32)])
    pa = pool.alloc(5)
    log.append(("alloc", pa))
    log.append(("insert", tree.insert(a, pa[:4])))
    log.append(("match_b", tree.match(b, max_blocks=(len(b) - 1) // 4)))
    pool.decref(pa)
    log.append(("after_decref", pool.stats()))
    m = tree.match(a, max_blocks=(len(a) - 1) // 4)
    log.append(("match_a", m, pool.stats()))
    tree.release_match(m, (len(a) - 1) // 4)
    log.append(("released", tree.stats(), pool.stats()))
    pb = pool.alloc(9)                       # evicts cold prefix pages
    log.append(("alloc_evict", pb, pool.stats(), tree.stats()))
    log.append(("alloc_none", pool.alloc(20)))
    pool.incref(pb[:2])
    pool.decref(pb[:2] + pb)
    log.append(("freed", pool.stats(), [pool.refcount(p) for p in range(12)]))
    log.append(("insert_b", tree.insert(b, pool.alloc(3)), tree.stats()))
    pool.decref(tree.match(b, 3))
    log.append(("watermark", pool.ensure_free(12), pool.stats(),
                tree.stats()))
    budget = budget_cls(20)
    budget.take(3)
    log.append(("budget", [budget.try_take(n) for n in (16, 2, 1, 1)],
                budget.can(0), budget.used))
    unbounded = budget_cls(None)
    log.append(("unbounded", unbounded.try_take(10 ** 9), unbounded.can(1)))
    return log


def test_pool_prefix_and_budget_decisions_match_jax():
    want = _script(JPagePool, JRadixPrefixCache, JStepBudget)
    got = _script(PagePool, RadixPrefixCache, StepBudget)
    assert got == want
    assert ("alloc_none", None) in got


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------
def _reqs(vocab, n, base_len, budgets, seed, cls, shared=0):
    rng = np.random.default_rng(seed)
    head = rng.integers(0, vocab, shared).astype(np.int32)
    out = []
    for i in range(n):
        tail = rng.integers(0, vocab, base_len + 7 * (i % 3)).astype(np.int32)
        out.append(cls(uid=i, prompt=np.concatenate([head, tail]),
                       max_new_tokens=budgets[i % len(budgets)]))
    return out


def _same(got, want):
    assert [r.uid for r in got] == [r.uid for r in want]
    for g, w in zip(got, want):
        assert g.tokens.tolist() == w.tokens.tolist(), g.uid


COUNTERS = ("prefill_chunks", "prefill_tokens_computed", "prompt_tokens_total",
            "prefix_hit_tokens")


@pytest.mark.parametrize("kv", ["f32", "bf16", "int8", "int4"])
def test_paged_engine_matches_jax_and_unpaged(quantized, kv):
    """Prompts of 5–19 tokens (one or two 16-wide chunks, pages of 8),
    six requests on three lanes, a shared 8-token head so later requests
    hit the prefix cache: greedy tokens identical to the JAX paged
    engine, and, for prompts that fit one chunk, to the port's unpaged
    engine."""
    jcfg, qparams, model = quantized
    common = dict(max_len=48, decode_batch=3, prefill_len=16, kv_dtype=kv)
    paged = dict(common, paged=True, page_size=8)
    budgets = [5, 3, 0, 6]
    mk = lambda cls: _reqs(jcfg.vocab, 6, 5, budgets, 1, cls, shared=8)  # noqa: E731
    jeng = JEngine(qparams, jcfg, JServeConfig(**paged))
    want = jeng.generate(mk(JRequest))
    eng = Engine(model, model.cfg, ServeConfig(**paged), device="cpu")
    got = eng.generate(mk(Request))
    _same(got, want)
    st, jst = eng.stats(), jeng.stats()
    assert {k: st[k] for k in COUNTERS} == {k: jst[k] for k in COUNTERS}
    assert st["prefix_hit_tokens"] > 0 and st["prefill_chunks"] > 6
    assert st["pages_hot"] == common["decode_batch"]    # only parked pages
    # without prefix hits, a prompt that fits one chunk runs the ops of
    # the unpaged one-shot prefill: the same tokens
    one_chunk = lambda: [r for r in mk(Request) if len(r.prompt) <= 16]  # noqa: E731
    cold = Engine(model, model.cfg, ServeConfig(**paged, prefix_cache=False),
                  device="cpu")
    unpaged = Engine(model, model.cfg, ServeConfig(**common), device="cpu")
    _same(cold.generate(one_chunk()), unpaged.generate(one_chunk()))


def test_prefix_reuse_across_generate_calls(quantized):
    jcfg, qparams, model = quantized
    sc = dict(max_len=64, decode_batch=2, prefill_len=16, kv_dtype="f32",
              paged=True, page_size=8)
    mk = lambda cls: _reqs(jcfg.vocab, 3, 17, [4], 2, cls)  # noqa: E731
    jeng = JEngine(qparams, jcfg, JServeConfig(**sc))
    eng = Engine(model, model.cfg, ServeConfig(**sc), device="cpu")
    for run in range(2):
        _same(eng.generate(mk(Request)), jeng.generate(mk(JRequest)))
        st, jst = eng.stats(), jeng.stats()
        assert {k: st[k] for k in COUNTERS} == {k: jst[k] for k in COUNTERS}
    assert st["prefix_hit_tokens"] > 0                      # warm second run
    assert st["prefill_tokens_computed"] < st["prompt_tokens_total"]


@pytest.mark.parametrize("limit", ["pool", "budget"])
def test_pool_exhaustion_and_step_budget_match_jax(quantized, limit):
    """``pool``: pages for one resident request at a time, so the second
    admission is deferred until the first retires. ``budget``: a
    17-token step budget lets one 16-wide chunk through per step, so a
    second prefilling request's chunks are capped. Tokens and counters
    equal JAX's either way."""
    jcfg, qparams, model = quantized
    sc = dict(max_len=64, decode_batch=2, prefill_len=16, kv_dtype="f32",
              paged=True, page_size=8, prefix_cache=False)
    if limit == "pool":
        sc["n_pages"] = 10            # 2 parked + 8: one 5-block request
    else:
        sc["max_step_tokens"] = 17
    mk = lambda cls: _reqs(jcfg.vocab, 3, 30, [4], 6, cls)  # noqa: E731
    jeng = JEngine(qparams, jcfg, JServeConfig(**sc))
    eng = Engine(model, model.cfg, ServeConfig(**sc), device="cpu")
    _same(eng.generate(mk(Request)), jeng.generate(mk(JRequest)))
    st, jst = eng.stats(), jeng.stats()
    keys = COUNTERS + ("budget_capped_chunks", "budget_deferred_admissions",
                       "decode_steps", "occupancy")
    assert {k: st[k] for k in keys} == {k: jst[k] for k in keys}
    if limit == "pool":
        assert st["occupancy"] <= 0.75       # the lanes never ran together
    else:
        assert st["budget_capped_chunks"] > 0


def test_decode_writes_stay_in_own_pages(quantized):
    """The in-place invariants: a decode step writes each row only into
    the page that holds its position (its own tail page, or its parked
    page once retired) and never into a prefix-shared page."""
    jcfg, _, model = quantized
    eng = Engine(model, model.cfg, ServeConfig(
        max_len=48, decode_batch=3, prefill_len=16, kv_dtype="f32",
        paged=True, page_size=8, max_new_tokens=5), device="cpu")
    for r in _reqs(jcfg.vocab, 5, 3, [5], 3, Request, shared=16):
        eng.submit(r)
    checked = 0
    while eng.sched.has_work:
        pure_decode = not eng.sched.queue and not eng._prefill_jobs
        layer = eng.slots.cache[0]
        pos = layer["pos"].clamp(max=47).tolist()
        tails = {int(layer["block_table"][s, pos[s] // 8]) for s in range(3)}
        tree = {p for p in range(eng.pool.n_pages) if eng.pool._cached[p]}
        before = layer["k"].clone()
        eng.step()
        if not pure_decode:
            continue
        touched = set(torch.nonzero((layer["k"] != before).flatten(1).any(1))
                      .flatten().tolist())
        assert touched <= tails and not tails & tree, (touched, tails, tree)
        checked += 1
    assert checked > 0 and eng.stats()["prefix_hit_tokens"] > 0
