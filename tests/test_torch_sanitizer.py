"""The port's runtime invariant sanitizer (``repro_torch.serve.sanitizer``)
against the JAX package's.

Each corruption ``tests/test_sanitizer.py`` injects into the JAX engine is
injected into the port's own structures (its ``PagePool``, the per-layer
block tables and positions, the radix tree, the slot states) and must be
caught under the JAX invariant's name; a clean engine passes, and a
sanitized speculative paged engine gives a bare one's tokens. One
deliberate difference: a mid-prefill lane's position may run ahead of its
chunk frontier (lockstep decode advances it), never behind it. The JAX
sanitizer wants it exactly at the frontier and so raises on a healthy
engine — shown here on the JAX engine itself.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import init_lm as jinit_lm
from repro.serve import Engine as JEngine
from repro.serve import Request as JRequest
from repro.serve import SanitizerError as JSanitizerError
from repro.serve import ServeConfig as JServeConfig
from repro_torch.configs import get_config
from repro_torch.kernels.constraints import PACKED4_ALIGN
from repro_torch.models import init_lm
from repro_torch.serve import Engine, Request, SanitizerError, ServeConfig
from repro_torch.serve.sanitizer import _attn_layers


@pytest.fixture(scope="module")
def model():
    return init_lm(get_config("phi3-mini-3.8b").reduced(), 0, device="cpu")


def _reqs(cls, vocab, n, seed=0, base=5):
    rng = np.random.default_rng(seed)
    return [cls(uid=i, prompt=rng.integers(0, vocab, size=base + i % 3)
                .astype(np.int32)) for i in range(n)]


def _engine(model, **kw):
    sc = dict(max_len=64, decode_batch=2, max_new_tokens=8, prefill_len=16,
              sanitize=True)
    sc.update(kw)
    return Engine(model, model.cfg, ServeConfig(**sc), device="cpu")


@pytest.fixture()
def decoding_engine(model):
    """A paged int4 engine mid-decode: lanes holding generated tokens,
    pages mapped, the sanitizer armed and passing."""
    eng = _engine(model, paged=True, kv_dtype="int4", page_size=8)
    for r in _reqs(Request, model.cfg.vocab, 3):
        eng.submit(r)
    for _ in range(12):
        eng.step()
        if any(st.tokens for st in eng.sched.table.active.values()):
            break
    assert any(st.tokens for st in eng.sched.table.active.values())
    return eng


def _decoding_slot(eng):
    return next(s for s, st in eng.sched.table.active.items() if st.tokens)


def test_clean_engine_passes(decoding_engine):
    decoding_engine._san.check(decoding_engine)


def test_detects_refcount_leak(decoding_engine):
    eng = decoding_engine
    page = eng._row_pages[_decoding_slot(eng)][0]
    eng.pool._ref[page] += 1
    with pytest.raises(SanitizerError, match=r"\[sanitize:refcount\]"):
        eng._san.check(eng)
    eng.pool._ref[page] -= 1
    eng._san.check(eng)


def test_detects_block_table_corruption(decoding_engine):
    eng = decoding_engine
    slot = _decoding_slot(eng)
    _, layer = next(p for p in _attn_layers(eng.slots.cache)
                    if "block_table" in p[1])
    saved = layer["block_table"][slot, 0].clone()
    # another valid page id: the device row no longer mirrors the host
    layer["block_table"][slot, 0] = (int(eng._row_pages[slot][0]) + 1) \
        % eng.pool.n_pages
    with pytest.raises(SanitizerError, match=r"\[sanitize:block-table\]"):
        eng._san.check(eng)
    layer["block_table"][slot, 0] = saved
    eng._san.check(eng)


def test_detects_pos_drift(decoding_engine):
    eng = decoding_engine
    slot = _decoding_slot(eng)
    _, layer = next(iter(_attn_layers(eng.slots.cache)))
    layer["pos"][slot] += 1
    with pytest.raises(SanitizerError, match=r"\[sanitize:pos\]"):
        eng._san.check(eng)
    layer["pos"][slot] -= 1
    eng._san.check(eng)


def test_detects_unpaged_slot_pos_beyond_pos(model):
    eng = _engine(model)
    for r in _reqs(Request, model.cfg.vocab, 2):
        eng.submit(r)
    eng.step()
    eng._san.check(eng)
    _, layer = next(iter(_attn_layers(eng.slots.cache)))
    layer["slot_pos"][0, -1] = int(layer["pos"][0]) + 5
    with pytest.raises(SanitizerError, match=r"\[sanitize:pos\].*slot_pos"):
        eng._san.check(eng)


def test_detects_uncommitted_rollback(decoding_engine):
    eng = decoding_engine
    state = eng.sched.table.active[_decoding_slot(eng)]
    eng._san.check(eng)                       # records the watermark
    tok = state.tokens.pop()                  # "roll back" an emitted token
    with pytest.raises(SanitizerError, match="pos-monotonic"):
        eng._san.check(eng)
    state.tokens.append(tok)
    eng._san.check(eng)


def test_detects_packed4_misalignment(decoding_engine):
    eng = decoding_engine
    _, layer = next(p for p in _attn_layers(eng.slots.cache)
                    if p[1]["k"].dtype == torch.uint8)
    saved = layer["k"]
    layer["k"] = saved[..., :-1, :]           # drop one packed byte row
    with pytest.raises(SanitizerError, match="int4-align"):
        eng._san.check(eng)
    layer["k"] = saved
    eng._san.check(eng)
    assert eng.page_size % PACKED4_ALIGN == 0


def test_detects_prefix_cache_disagreement(model):
    """Both directions: an orphaned cached flag (no tree owner) and a
    ghost tree node (the pool no longer flags the page)."""
    eng = _engine(model, paged=True, kv_dtype="int4", page_size=8,
                  max_new_tokens=4)
    rng = np.random.default_rng(7)
    shared = rng.integers(0, model.cfg.vocab, size=16).astype(np.int32)
    eng.generate([Request(uid=i, prompt=np.concatenate(
        [shared, rng.integers(0, model.cfg.vocab, size=4).astype(np.int32)]))
        for i in range(2)])
    assert eng.prefix._by_page
    eng._san.check(eng)
    page = next(iter(eng.prefix._by_page))
    node = eng.prefix._by_page.pop(page)
    with pytest.raises(SanitizerError, match="prefix-cache"):
        eng._san.check(eng)
    eng.prefix._by_page[page] = node
    eng._san.check(eng)
    eng.pool._cached[page] = False
    with pytest.raises(SanitizerError, match="prefix-cache"):
        eng._san._check_prefix_cache(eng)
    with pytest.raises(SanitizerError):
        eng._san.check(eng)
    eng.pool._cached[page] = True
    eng._san.check(eng)


def test_mid_prefill_frontier(model):
    """A 40-token prompt chunked by 16 while another lane decodes: the
    JAX sanitizer raises on the healthy engine; the port's passes, and
    catches a position behind the frontier."""
    vocab = model.cfg.vocab
    sc = dict(max_len=64, decode_batch=2, max_new_tokens=8, prefill_len=16,
              paged=True, page_size=8, sanitize=True)
    jcfg = jget_config("phi3-mini-3.8b").reduced()
    engines = {"jax": JEngine(jinit_lm(jax.random.PRNGKey(0), jcfg), jcfg,
                              JServeConfig(**sc)),
               "port": Engine(model, model.cfg, ServeConfig(**sc),
                              device="cpu")}
    for name, eng in engines.items():
        cls = JRequest if name == "jax" else Request
        short, long_ = (_reqs(cls, vocab, 1, seed=1)[0],
                        _reqs(cls, vocab, 1, seed=2, base=40)[0])
        long_.uid = 1
        eng.submit(short)
        eng.step()
        eng.step()
        eng.submit(long_)
        if name == "jax":
            with pytest.raises(JSanitizerError,
                               match="mid-prefill frontier 16"):
                eng.drain()
            continue
        eng.step()                            # first chunk + a decode
        slot = next(s for s in eng._prefill_jobs)
        front = eng._prefill_jobs[slot].next
        pos = [int(layer["pos"][slot]) for layer in eng.slots.cache]
        assert front == 16 and all(p > front for p in pos)
        _, layer = next(iter(_attn_layers(eng.slots.cache)))
        saved = layer["pos"][slot].clone()
        layer["pos"][slot] = front - 1
        with pytest.raises(SanitizerError, match="behind its mid-prefill"):
            eng._san.check(eng)
        layer["pos"][slot] = saved
        assert len(eng.drain()) == 2


def test_sanitize_requires_continuous_scheduler(model):
    with pytest.raises(ValueError, match="sanitize"):
        _engine(model, scheduler="bucketed")


@pytest.mark.parametrize("kw", [
    dict(paged=True, kv_dtype="int8", speculative=True, spec_k=3),
    dict(kv_dtype="int4", speculative=True, spec_k=3),
    dict(paged=True, page_size=8, prefill_len=8)],
    ids=["spec_paged_int8", "spec_unpaged_int4", "paged_chunked"])
def test_sanitizer_is_token_invisible(model, kw):
    def run(sanitize):
        eng = _engine(model, max_new_tokens=6, sanitize=sanitize,
                      **dict(dict(page_size=16), **kw))
        out = eng.generate(_reqs(Request, model.cfg.vocab, 4, base=7))
        return [r.tokens.tolist() for r in out]

    assert run(False) == run(True)
