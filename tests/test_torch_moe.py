"""Port parity for the MoE slice on ``deepseek-moe-16b.reduced()`` (2
layers, the first dense; 8 routed experts + 1 shared, top-2, d_expert 32):

* K6's plain version ``qlr_matmul_batched_plain`` against the JAX
  package's ``ops.mxint_lowrank_matmul_batched`` (the Pallas kernel in
  interpret mode) and ``ops._qlr_matmul_batched_xla``, without and with
  per-expert ``counts`` (rows past a count zero in x and exactly 0 in y);
* the counts ``moe_apply`` hands the experts against the JAX routing's
  per-expert load, clamped at the capacity;
* ``moe_apply`` against JAX ``moe_apply`` on converted params — fp, int8
  and packed4 experts, ``fused`` auto/off — at 128 tokens, where the
  capacity (40) drops assignments, and at a 3-token decode;
* whole-model prefill logits at 128 tokens (drops in every MoE layer)
  against JAX ``prefill``;
* greedy engine tokens identical to JAX ``Engine.generate``, unpaged and
  paged, both engines serving the same JAX-SRR-quantized params;
* ``convert_params`` carrying every leaf of the MoE tree over unchanged.

Float tolerances: f32 sums in another order than XLA's, 1e-5 of the
output scale for one layer, 1e-4 absolute for logits.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core.api import PTQConfig as JPTQConfig
from repro.kernels import ops as jops
from repro.models import Ctx as JCtx
from repro.models import init_cache as jinit_cache
from repro.models import init_lm as jinit_lm
from repro.models import prefill as jprefill
from repro.models.moe import moe_apply as jmoe_apply
from repro.models.quantize import quantize_model_params as jquantize
from repro.quant.base import QuantizerConfig
from repro.quant.mxint import pack_codes_4bit as jpack_codes_4bit
from repro.serve import Engine as JEngine
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro_torch.configs import get_config
from repro_torch.convert import _ffn, convert_params
from repro_torch.kernels import mxint_matmul as mk
from repro_torch.models import Ctx, init_cache, prefill
from repro_torch.models.linear import FpLinear, QLinear
from repro_torch.models.moe import MoE, capacity, moe_apply, route
from repro_torch.serve import Engine, Request, ServeConfig

ARCH = "deepseek-moe-16b"
PTQ = JPTQConfig(method="srr", rank=8, seed=0, exact_svd=True, forced_k=3,
                 quantizer=QuantizerConfig(kind="mxint", bits=3,
                                           block_size=32))


def _tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _close(got, want, rel):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


# --------------------------------------------------------------------------
# K6: the stacked Q + LR matmul
# --------------------------------------------------------------------------
@pytest.mark.parametrize("rank", [0, 8])
@pytest.mark.parametrize("m", [3, 8, 40])
def test_batched_plain_matches_jax_kernel_and_xla(rank, m):
    rng = np.random.default_rng(m + rank)
    e, k, n = 4, 64, 48
    x = rng.standard_normal((e, m, k)).astype(np.float32)
    codes = rng.integers(-4, 4, (e, k, n)).astype(np.int8)
    scale = np.exp2(rng.integers(-6, -2, (e, k // 32, n))).astype(np.float32)
    l = (rng.standard_normal((e, k, rank)) * 0.1).astype(np.float32)
    r = (rng.standard_normal((e, rank, n)) * 0.1).astype(np.float32)
    got = mk.qlr_matmul_batched(*map(torch.from_numpy, (x, codes, scale, l, r)))
    assert got.shape == (e, m, n) and got.dtype == torch.float32
    j = tuple(map(jnp.asarray, (x, codes, scale, l, r)))
    _close(got.numpy(), jops.mxint_lowrank_matmul_batched(*j), 1e-5)
    _close(got.numpy(), jops._qlr_matmul_batched_xla(*j), 1e-5)


@pytest.mark.parametrize("counts", [[0, 0, 0, 0], [0, 1, 2, 3], [5, 0, 8, 2],
                                    [8, 8, 8, 8]],
                         ids=["none", "partial", "mixed", "full"])
def test_batched_plain_counts_match_jax_kernel(counts):
    """On a stack zero past each expert's count (as the dispatch buffer
    is), the plain K6 with counts equals the full plain version, the JAX
    kernel (interpret mode) and its XLA lowering, and its rows past the
    counts are exactly 0."""
    rng = np.random.default_rng(sum(counts))
    e, m, k, n, rank = 4, 8, 64, 48, 8
    x = rng.standard_normal((e, m, k)).astype(np.float32)
    past = np.arange(m)[None, :] >= np.asarray(counts)[:, None]
    x[past] = 0
    codes = rng.integers(-4, 4, (e, k, n)).astype(np.int8)
    scale = np.exp2(rng.integers(-6, -2, (e, k // 32, n))).astype(np.float32)
    l = (rng.standard_normal((e, k, rank)) * 0.1).astype(np.float32)
    r = (rng.standard_normal((e, rank, n)) * 0.1).astype(np.float32)
    args = tuple(map(torch.from_numpy, (x, codes, scale, l, r)))
    c = torch.tensor(counts, dtype=torch.int32)
    got = mk.qlr_matmul_batched(*args, counts=c)
    assert got.shape == (e, m, n) and not got.numpy()[past].any()
    assert torch.equal(got, mk.qlr_matmul_batched_plain(*args, c))
    _close(got.numpy(), mk.qlr_matmul_batched_plain(*args).numpy(), 1e-6)
    j = tuple(map(jnp.asarray, (x, codes, scale, l, r)))
    _close(got.numpy(), jops.mxint_lowrank_matmul_batched(*j), 1e-5)
    _close(got.numpy(), jops._qlr_matmul_batched_xla(*j), 1e-5)


# --------------------------------------------------------------------------
# moe_apply, with capacity drops
# --------------------------------------------------------------------------
@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    """Many small ops: two intra-op threads, as in
    ``tests/test_torch_train.py``; restored after the module."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def jax_models():
    """The reduced model, f32 and JAX-SRR-quantized (int8 container)."""
    jcfg = jget_config(ARCH).reduced()
    params = jinit_lm(jax.random.PRNGKey(2), jcfg)
    qparams, _ = jquantize(params, None, PTQ)
    return jcfg, params, qparams


@pytest.fixture(scope="module")
def moe_params(jax_models):
    """The MoE block of the reduced model in three containers: (JAX
    tree, port module)."""
    _, params, qparams = jax_models
    block = lambda tree: jax.tree_util.tree_map(  # noqa: E731
        lambda a: a[0], tree["groups"]["p0"]["moe"])
    fp, int8 = block(params), block(qparams)
    # the packed4 container holds the same codes two to a byte
    packed4 = jax.tree_util.tree_map(lambda a: a, int8)
    for lin in [packed4["router"], *packed4["experts"].values(),
                *packed4["shared"].values()]:
        lin["packed"] = jpack_codes_4bit(lin.pop("codes"))
    out = {"fp": fp, "int8": int8, "packed4": packed4}
    return {c: (p, _ffn({"moe": _tree(p)}, "cpu")) for c, p in out.items()}


def _jax_route(jctx, jp, x, cfg):
    from repro.models.linear import linear as jlinear
    logits = jlinear(jctx, jp["router"], jnp.asarray(x.reshape(-1, x.shape[-1])),
                     "moe.router").astype(jnp.float32)
    return np.asarray(jax.lax.top_k(jax.nn.softmax(logits, -1), cfg.top_k)[1])


@pytest.mark.parametrize("container", ["fp", "int8", "packed4"])
@pytest.mark.parametrize("fused", ["auto", "off"])
@pytest.mark.parametrize("b,s", [(2, 64), (3, 1)], ids=["t128-drops", "decode"])
def test_moe_apply_matches_jax(moe_params, container, fused, b, s):
    jcfg, cfg = jget_config(ARCH).reduced(), get_config(ARCH).reduced()
    jp, port = moe_params[container]
    rng = np.random.default_rng(b * s)
    # hidden states share a direction, so the router favours some experts
    # and at 128 tokens their queues overflow the capacity
    x = (rng.standard_normal((b, s, cfg.d_model))
         + rng.standard_normal(cfg.d_model)).astype(np.float32)
    # fused="auto" against the JAX Pallas kernels in interpret mode
    jctx = JCtx(fused="on" if fused == "auto" else "off")
    want, _ = jax.jit(lambda p, xx: jmoe_apply(jctx, p, xx, jcfg))(
        jp, jnp.asarray(x))
    ctx = Ctx(fused=fused, route_log=[])
    got = moe_apply(ctx, port, torch.from_numpy(x), cfg)
    _close(got.numpy(), want, 1e-5)
    # the same routing, and at 128 tokens some assignments dropped
    idx = ctx.route_log[0].numpy()
    assert np.array_equal(idx, _jax_route(jctx, jp, x, jcfg))
    t, cap = b * s, capacity(b * s, cfg)
    load = np.bincount(idx.reshape(-1), minlength=cfg.n_routed)
    if t == 128:
        assert cap == 40 and load.max() > cap, load
    else:
        assert cap == t


@pytest.mark.parametrize("b,s", [(2, 64), (3, 1)], ids=["t128-drops", "decode"])
def test_moe_counts_match_jax_routing(moe_params, monkeypatch, b, s):
    """The per-expert counts ``moe_apply`` hands ``expert_ffn`` (from its
    one-hot, no host sync) equal ``np.bincount`` of the JAX routing,
    clamped at the capacity, and are int32 on x's device."""
    from repro_torch.models import moe as moe_mod
    jcfg, cfg = jget_config(ARCH).reduced(), get_config(ARCH).reduced()
    jp, port = moe_params["int8"]
    rng = np.random.default_rng(b * s)
    x = (rng.standard_normal((b, s, cfg.d_model))
         + rng.standard_normal(cfg.d_model)).astype(np.float32)
    seen = []
    ffn = moe_mod.expert_ffn

    def spy(ctx, experts, buf, counts=None):
        seen.append(counts)
        return ffn(ctx, experts, buf, counts)

    monkeypatch.setattr(moe_mod, "expert_ffn", spy)
    moe_apply(Ctx(), port, torch.from_numpy(x), cfg)
    (counts,) = seen
    cap = capacity(b * s, cfg)
    load = np.bincount(_jax_route(JCtx(fused="on"), jp, x, jcfg).reshape(-1),
                       minlength=cfg.n_routed)
    assert counts.dtype == torch.int32 and counts.device.type == "cpu"
    assert counts.tolist() == np.minimum(load, cap).tolist()
    if b * s == 128:
        assert load.max() > cap          # some queues overflow: drops


def test_route_replay_reproduces_and_overrides_the_routing(moe_params):
    """``Ctx.route_replay`` (how the card run compares two lowerings under
    one routing): replaying a logged routing gives the same output, a
    different one is taken as given."""
    cfg = get_config(ARCH).reduced()
    _, port = moe_params["int8"]
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, 128, cfg.d_model)).astype(np.float32))
    log = []
    want = moe_apply(Ctx(route_log=log), port, x, cfg)
    again = moe_apply(Ctx(route_replay=iter(log)), port, x, cfg)
    assert torch.equal(again, want)
    other, relog = [log[0].flip(-1).roll(1, dims=0)], []
    moved = moe_apply(Ctx(route_replay=iter(other), route_log=relog), port,
                      x, cfg)
    assert torch.equal(relog[0], other[0])
    assert not torch.allclose(moved, want)


def test_routing_ties_go_to_the_lower_index():
    cfg = get_config(ARCH).reduced()
    d, e = cfg.d_model, cfg.n_routed
    router = FpLinear(torch.zeros((d, e)))      # every probability equal
    port = MoE(router, None, None)
    idx, gate = route(Ctx(), port, torch.randn((5, d)), cfg.top_k)
    assert idx.tolist() == [[0, 1]] * 5
    assert torch.allclose(gate, torch.full((5, 2), 0.5))


# --------------------------------------------------------------------------
# the whole model, converted from a JAX-SRR-quantized tree
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def quantized(jax_models):
    jcfg, _, qparams = jax_models
    model = convert_params(_tree(qparams), get_config(ARCH).reduced(),
                           device="cpu")
    return jcfg, qparams, model


@pytest.mark.parametrize("fused", ["on", "off"])
def test_prefill_logits_with_drops_match_jax(quantized, fused):
    jcfg, qparams, model = quantized
    rng = np.random.default_rng(7)
    toks = rng.integers(0, jcfg.vocab, (1, 128)).astype(np.int32)
    n = np.array([117], np.int32)         # 11 pad tokens route after the rest
    jctx = JCtx(fused=fused)
    jctx.use_pallas = fused == "on"
    jl, _ = jax.jit(lambda p, t, c, ln: jprefill(jctx, p, {"tokens": t}, jcfg,
                                                 c, lengths=ln))(
        qparams, jnp.asarray(toks), jinit_cache(jcfg, 1, 160,
                                                dtype=jnp.float32),
        jnp.asarray(n))
    ctx = Ctx(fused="auto" if fused == "on" else "off", route_log=[])
    tl, _ = prefill(ctx, model, torch.from_numpy(toks).long(),
                    init_cache(model.cfg, 1, 160, torch.float32, "cpu"),
                    lengths=torch.from_numpy(n))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-4)
    (idx,) = ctx.route_log                 # one MoE layer after the dense one
    load = np.bincount(idx.numpy().reshape(-1), minlength=jcfg.n_routed)
    assert load.max() > capacity(128, model.cfg)


def _reqs(vocab, cls):
    rng = np.random.default_rng(11)
    head = rng.integers(0, vocab, 8)
    out = []
    for i, budget in enumerate([6, 3, 0, 5, 7]):
        tail = rng.integers(0, vocab, 3 + (5 * i) % 11)
        prompt = np.concatenate([head, tail]) if i % 2 else tail
        out.append(cls(uid=i, prompt=prompt.astype(np.int32),
                       max_new_tokens=budget))
    return out


@pytest.mark.parametrize("paged", [False, True], ids=["unpaged", "paged"])
def test_engine_greedy_tokens_identical_to_jax(quantized, paged):
    jcfg, qparams, model = quantized
    sc = dict(max_len=48, decode_batch=3, prefill_len=16, kv_dtype="bf16")
    if paged:
        sc.update(paged=True, page_size=8)
    want = JEngine(qparams, jcfg, JServeConfig(**sc)).generate(
        _reqs(jcfg.vocab, JRequest))
    eng = Engine(model, model.cfg, ServeConfig(**sc), device="cpu")
    got = eng.generate(_reqs(jcfg.vocab, Request))
    assert [r.uid for r in got] == [r.uid for r in want]
    for g, w in zip(got, want):
        assert g.tokens.tolist() == w.tokens.tolist(), g.uid
        assert g.finish_reason == w.finish_reason
    assert sum(len(r.tokens) for r in got) == 21
    if paged:
        assert eng.stats()["prefix_hit_tokens"] > 0


# --------------------------------------------------------------------------
# the converter
# --------------------------------------------------------------------------
def _port_buffers(mod):
    """{buffer name: tensor} of a linear module."""
    return {k: v for k, v in mod.named_buffers() if v is not None}


def test_convert_carries_the_moe_tree_over(quantized):
    jcfg, qparams, model = quantized
    tree = _tree(qparams)
    assert [type(b.mlp).__name__ for b in model.blocks] == ["MLP", "MoE"]
    # the dense lead-in layer
    for n in ("up", "gate", "down"):
        want = tree["prefix"][0]["mlp"][n]
        got = _port_buffers(getattr(model.blocks[0].mlp, n))
        assert set(want) <= set(got)
        for key in want:
            assert np.array_equal(got[key].numpy(), want[key]), (n, key)
    # the MoE block: leaves (G=1, E, ...) keep their expert axis
    moe, jm = model.blocks[1].mlp, tree["groups"]["p0"]["moe"]
    pairs = [(moe.router, jm["router"])]
    pairs += [(getattr(moe.experts, n), jm["experts"][n])
              for n in ("up", "gate", "down")]
    pairs += [(getattr(moe.shared, n), jm["shared"][n])
              for n in ("up", "gate", "down")]
    for mod, want in pairs:
        assert isinstance(mod, QLinear)
        got = _port_buffers(mod)
        assert set(want) == set(got)
        for key in want:
            assert np.array_equal(got[key].numpy(), want[key][0]), key
    assert moe.experts.up.codes.shape == (jcfg.n_routed, 64, jcfg.d_expert)
