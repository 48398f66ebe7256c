"""Port parity: internvl2-2b's vision prefix (``vision_proj`` of the
``vision`` stub's patch embeddings in front of the token embeddings, on
a GQA/SwiGLU/RMSNorm decoder) against the JAX package on the CPU.

The reduced config keeps the family's structure: 2 layers, d 64, 4 query
heads over 4 KV heads of 16, SwiGLU 128 wide, 4 vision tokens of 64,
vocabulary 256. Weights are JAX's ``init_lm`` tree filled from a numpy
seed, converted to the port; the quantized model is the port's SRR pass
(exact SVDs, identity scaling) written back into JAX's tree, so both
packages serve one container. Inputs from numpy seeds.

Tolerances: the vision stub, the converted ``vision_proj`` and greedy
tokens exact; logits 1e-4 with f32 KV and 2e-3 with bf16 KV (the dense
tests' rule: the two frameworks round the cache to bf16 separately, so a
1-ulp f32 difference at a rounding boundary moves a stored element by
2^-8 relative); ``lm_loss`` 1e-5 relative and its gradients 1e-4 of each
leaf's largest entry (``tests/test_torch_train.py``'s bounds); one QPEFT
step's trained adapters within 3e-3 · lr elementwise (the same file's
``PARAM_TOL``); calibration moments 1e-5 of their largest entry.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.data import data_config_for as jdata_config_for
from repro.data import host_batch as jhost_batch
from repro.models import Ctx as JCtx
from repro.models import decode_step as jdecode_step
from repro.models import init_cache as jinit_cache
from repro.models import init_lm as jinit_lm
from repro.models import lm_loss as jlm_loss
from repro.models import prefill as jprefill
from repro.models.quantize import split_qpeft as jsplit_qpeft
from repro.optim import AdamW as JAdamW
from repro.serve import Engine as JEngine
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro.train import StepConfig as JStepConfig
from repro.train import init_qpeft_state as jinit_qpeft_state
from repro.train import make_qpeft_step as jmake_qpeft_step
from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import convert_params, convert_qpeft_state
from repro_torch.core.api import PTQConfig
from repro_torch.data import capture_calibration, data_config_for, host_batch
from repro_torch.models import Ctx, decode_step, init_cache, init_lm, lm_loss
from repro_torch.models import prefill
from repro_torch.models.linear import FpLinear, QLinear
from repro_torch.models.quantize import quantize_model_params
from repro_torch.models.transformer import check_supported
from repro_torch.optim import AdamW
from repro_torch.serve import Engine, Request, ServeConfig
from repro_torch.serve.sanitizer import SanitizerError
from repro_torch.train import StepConfig, make_qpeft_step, trainable_params
from repro_torch.train.steps import _grads_of

ARCH = "internvl2-2b"
LOGIT_TOL = 1e-4
BF16_LOGIT_TOL = 2e-3
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
PARAM_TOL = 3e-3
MOMENT_TOL = 1e-5
LR = 1e-3
ATTENTION = ("wq", "wk", "wv", "wo")
SWIGLU = ("up", "gate", "down")


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    """Many small ops: two intra-op threads, as in
    ``tests/test_torch_train.py``; restored after the module."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _numpy_params(jcfg, seed):
    """JAX's ``init_lm`` tree for ``jcfg`` (traced, not run) filled from a
    numpy seed: each weight N(0, 1/m) for its m input rows, the embedding
    N(0, 0.02²), every RMSNorm gain 1 + N(0, 0.2²)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda k: jinit_lm(k, jcfg),
                            jax.random.PRNGKey(0))

    def fill(path, leaf):
        name = str(getattr(path[-1], "key", ""))
        if name == "g":
            a = 1 + 0.2 * rng.standard_normal(leaf.shape)
        elif str(getattr(path[0], "key", "")) == "embed":
            a = 0.02 * rng.standard_normal(leaf.shape)
        else:
            a = rng.standard_normal(leaf.shape) / np.sqrt(leaf.shape[-2])
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def fp_model():
    """(JAX config, JAX fp params, the converted model)."""
    jcfg, cfg = jget_config(ARCH).reduced(), get_config(ARCH).reduced()
    tree = _numpy_params(jcfg, 7)
    return jcfg, jax.tree_util.tree_map(jnp.asarray, tree), \
        convert_params(tree, cfg, device="cpu")


def _container(model, params):
    """JAX's tree with every projection of the scanned group replaced by
    the quantized port model's ``QLinear`` buffers, stacked over the
    layers; ``vision_proj``, the embedding and the norms kept."""
    grp = dict(params["groups"]["p0"])
    for owner, names in (("mixer", ATTENTION), ("mlp", SWIGLU)):
        sub = dict(grp[owner])
        for n in names:
            mods = [getattr(getattr(blk, owner), n) for blk in model.blocks]
            sub[n] = {k: jnp.stack([jnp.asarray(getattr(m, k).numpy())
                                    for m in mods])
                      for k, _ in mods[0].named_buffers()}
        grp[owner] = sub
    return dict(params, groups={"p0": grp})


@pytest.fixture(scope="module")
def quantized(fp_model):
    """(JAX config, JAX's tree of the container, the port's model): the
    port's SRR pass (rank 8, 3-bit MXINT, identity scaling, exact SVDs)
    over the converted fp model, written back into JAX's tree."""
    jcfg, params, model = fp_model
    qmodel, _ = quantize_model_params(
        convert_params(_tree(params), model.cfg, device="cpu"),
        PTQConfig(method="srr", scaling="identity", rank=8, exact_svd=True),
        device="cpu")
    return jcfg, _container(qmodel, params), qmodel


def _vision(b, cfg, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, cfg.n_vision_tokens, cfg.d_frontend)
                               ).astype(np.float32)


# ---------------------------------------------------------------------------
# the stub, the converter, the registry
# ---------------------------------------------------------------------------
def test_vision_stub_matches_jax():
    """``host_batch`` of a VLM draws JAX's vision stub bit for bit (host 1
    of 2, step 3) beside its tokens; the full config's stub is 256 ×
    1024."""
    jcfg, cfg = jget_config(ARCH).reduced(), get_config(ARCH).reduced()
    want = jhost_batch(jdata_config_for(jcfg, 16, 4, 5), 3, 1, 2)
    got = host_batch(data_config_for(cfg, 16, 4, 5), 3, 1, 2, device="cpu")
    assert sorted(got) == sorted(want) == ["labels", "tokens", "vision"]
    assert got["vision"].dtype == torch.float32
    assert got["vision"].shape == (2, 4, 64)
    for key in want:
        assert np.array_equal(got[key].numpy(), np.asarray(want[key])), key
    full = data_config_for(ARCHS[ARCH], 16, 4)
    assert full.vision == (256, 1024) and full.frames is None
    assert data_config_for(ARCHS["phi3-mini-3.8b"], 16, 4).vision is None


def test_registered_and_admitted():
    """The port's copy of the config equals JAX's field for field and is
    admitted; a reduced init has ``vision_proj`` 64 × 64, full
    precision."""
    cfg = ARCHS[ARCH]
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jget_config(ARCH))
    check_supported(cfg)
    model = init_lm(cfg.reduced(), 0, device="cpu")
    assert isinstance(model.vision_proj, FpLinear)
    assert model.vision_proj.w.shape == (64, 64)
    assert init_lm(get_config("phi3-mini-3.8b").reduced(), 0,
                   device="cpu").vision_proj is None


@pytest.mark.parametrize("kw", [
    dict(moe=True, n_routed=4, top_k=2, d_expert=32),
    dict(attn_kind="mla", kv_lora_rank=16, rope_head_dim=8),
    dict(block_pattern=("attn", "local")),
    dict(block_pattern=("mlstm", "slstm"), d_ff=0),
    dict(enc_layers=2, enc_seq=8, cross_attn=True, act="gelu",
         norm="layernorm")], ids=["moe", "mla", "hybrid", "xlstm", "encdec"])
def test_vision_prefix_elsewhere_refused(kw):
    """A vision prefix beside an MoE, MLA, a hybrid, an xLSTM stack or an
    encoder: JAX has no such model, and the port refuses it; the same
    configs without the prefix are admitted."""
    base = dataclasses.replace(ARCHS[ARCH], **kw)
    with pytest.raises(NotImplementedError):
        check_supported(base)
    check_supported(dataclasses.replace(base, n_vision_tokens=0))


@pytest.mark.parametrize("container", ["fp", "int8"])
def test_converter_takes_vision_proj(fp_model, quantized, container):
    """``vision_proj`` arrives bit for bit, full precision, beside the fp
    or the quantized projections."""
    tree = _tree(fp_model[1] if container == "fp" else quantized[1])
    model = convert_params(tree, fp_model[2].cfg, device="cpu")
    assert isinstance(model.vision_proj, FpLinear)
    assert np.array_equal(model.vision_proj.w.numpy(),
                          tree["vision_proj"]["w"])
    kind = FpLinear if container == "fp" else QLinear
    assert isinstance(model.blocks[1].mlp.down, kind)


# ---------------------------------------------------------------------------
# the model: logits, loss and gradients, calibration, the pass
# ---------------------------------------------------------------------------
LENGTHS, SLOTS = [12, 7, 10], 24


@pytest.mark.parametrize("kv,with_vision", [("f32", True), ("f32", False),
                                             ("bf16", True)])
def test_logits_match_jax(quantized, kv, with_vision):
    """Prompts of 12, 7 and 10 tokens (right-padded; ``lengths`` count
    the 4 vision rows in front), then two greedy decode steps, logits
    every step, through both of the port's lowerings against JAX's
    function; without vision the model is a plain decoder, as JAX's
    ``"vision" in batch`` has it. The cache's write position is vision +
    prompt + steps."""
    jcfg, params, model = quantized
    jdt, dt = {"f32": (jnp.float32, torch.float32),
               "bf16": (jnp.bfloat16, torch.bfloat16)}[kv]
    tol = LOGIT_TOL if kv == "f32" else BF16_LOGIT_TOL
    b, n_vis = len(LENGTHS), jcfg.n_vision_tokens if with_vision else 0
    rng = np.random.default_rng(3)
    toks = rng.integers(0, jcfg.vocab, (b, max(LENGTHS))).astype(np.int32)
    lens = np.asarray(LENGTHS, np.int32) + n_vis
    batch = {"tokens": jnp.asarray(toks)}
    vision = None
    if with_vision:
        vision = _vision(b, jcfg, 9)
        batch["vision"] = jnp.asarray(vision)
    jctx = JCtx(fused="off")
    jl, jc = jax.jit(lambda p, bt, c, n: jprefill(
        jctx, p, bt, jcfg, c, lengths=n))(
        params, batch, jinit_cache(jcfg, b, SLOTS, dtype=jdt),
        jnp.asarray(lens))
    jdec = jax.jit(lambda p, t, c: jdecode_step(jctx, p, t, c, jcfg))
    jlogits = [np.asarray(jl)]
    for _ in range(2):
        tok = np.argmax(jlogits[-1][:, -1], -1)[:, None].astype(np.int32)
        jl, jc = jdec(params, jnp.asarray(tok), jc)
        jlogits.append(np.asarray(jl))
    for fused in ("off", "auto"):
        ctx = Ctx(fused=fused)
        tl, tc = prefill(ctx, model, torch.from_numpy(toks).long(),
                         init_cache(model.cfg, b, SLOTS, dt, "cpu"),
                         lengths=torch.from_numpy(lens),
                         vision=(None if vision is None
                                 else torch.from_numpy(vision)))
        np.testing.assert_allclose(tl.numpy(), jlogits[0], rtol=0, atol=tol,
                                   err_msg=fused)
        for step in range(2):
            tok = np.argmax(jlogits[step][:, -1], -1)[:, None]
            tl, tc = decode_step(ctx, model, torch.from_numpy(tok).long(), tc)
            np.testing.assert_allclose(tl.numpy(), jlogits[step + 1], rtol=0,
                                       atol=tol, err_msg=f"{fused} {step}")
        assert tc[0]["pos"].tolist() == (lens + 2).tolist()


def test_lm_loss_and_gradients_match_jax(fp_model):
    """``lm_loss`` over a batch with the vision stub drops the 4 vision
    rows before the cross-entropy, as JAX's does: the loss and the
    gradient of every leaf, ``vision_proj`` and the embedding included,
    against ``jax.grad`` of JAX's."""
    jcfg, params, model = fp_model
    jb = jhost_batch(jdata_config_for(jcfg, 16, 4, 0), 0)
    b = host_batch(data_config_for(model.cfg, 16, 4, 0), 0, device="cpu")
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jlm_loss(JCtx(fused="off"), p, jb, jcfg)))(params)
    leaves = trainable_params(model)
    loss, grads = _grads_of(lambda bb: lm_loss(Ctx(fused="off"), model, bb),
                            leaves, b, 0)
    assert abs(float(loss) - float(jloss)) <= LOSS_TOL * abs(float(jloss))
    want = trainable_params(convert_params(_tree(jgrads), model.cfg,
                                           device="cpu"))
    assert sorted(grads) == sorted(want) and "vision_proj.w" in grads
    for name, g in grads.items():
        scale = float(want[name].abs().max())
        assert float((g - want[name]).abs().max()) <= GRAD_TOL * scale, name
    assert float(grads["vision_proj.w"].abs().max()) > 0
    text = {k: v for k, v in b.items() if k != "vision"}
    assert float(lm_loss(Ctx(), model, text)) != float(loss)


def test_qpeft_step_matches_jax(quantized):
    """One QPEFT step from one converted state: the loss and grad norm,
    the trained adapters against JAX's; ``vision_proj``, frozen in both
    splits, bit for bit unchanged."""
    jcfg, params, model = quantized
    jopt = JAdamW(learning_rate=LR, weight_decay=0.01)
    jstate = jinit_qpeft_state(*jsplit_qpeft(params), jopt)
    state = convert_qpeft_state(_tree(jstate), model.cfg, device="cpu")
    vis0 = state.frozen.vision_proj.w.clone()
    init = {f"{p}.{k}": v.clone() for p, d in state.trainable.items()
            for k, v in d.items()}
    jb = jhost_batch(jdata_config_for(jcfg, 16, 4, 0), 0)
    b = host_batch(data_config_for(model.cfg, 16, 4, 0), 0, device="cpu")
    jstate, jm = jax.jit(jmake_qpeft_step(
        jcfg, jopt, JStepConfig(compute_dtype=jnp.float32)))(jstate, jb)
    state, m = make_qpeft_step(model.cfg, AdamW(learning_rate=LR,
                                                weight_decay=0.01),
                               StepConfig(compute_dtype=torch.float32))(
        state, b)
    assert abs(float(m["loss"]) - float(jm["loss"])) <= \
        LOSS_TOL * abs(float(jm["loss"]))
    assert abs(float(m["grad_norm"]) - float(jm["grad_norm"])) <= \
        GRAD_TOL * float(jm["grad_norm"])
    want = convert_qpeft_state(_tree(jstate), model.cfg, device="cpu")
    for path, d in state.trainable.items():
        for k, v in d.items():
            w = want.trainable[path][k]
            assert float((v - w).abs().max()) <= PARAM_TOL * LR, (path, k)
            assert not torch.equal(v, init[f"{path}.{k}"]), (path, k)
    assert torch.equal(state.frozen.vision_proj.w, vis0)
    assert "vision_proj" not in {p.split(".")[0] for p in state.trainable}


def test_calibration_taps_match_jax(fp_model):
    """One calibration batch of 4 × 16 tokens and 4 × 4 vision rows:
    JAX's tap names in JAX's order, ``vision_proj``'s input first under
    the bare name ``""``, with JAX's counts and moments (JAX traced once
    under ``jit``); the port's pass then leaves ``""`` behind (no matrix
    reads it) and consumes every layer's entries."""
    jcfg, params, model = fp_model
    order = []

    def taps(p, batch):
        tap = {}
        jlm_loss(JCtx(tap=tap), p, batch, jcfg)
        order[:] = list(tap)
        return {k: (v.count, v.sum_abs, v.sum_sq, v.autocorr)
                for k, v in tap.items()}

    out = jax.jit(taps)(params, jhost_batch(jdata_config_for(jcfg, 16, 4, 0),
                                            0))
    stats = capture_calibration(model, data_config_for(model.cfg, 16, 4, 0),
                                lm_loss, n_batches=1, device="cpu")
    assert list(stats) == order and order[0] == ""
    assert stats[""].count == 4 * 4
    for key, st in stats.items():
        count, *moments = out[key]
        assert st.count == int(float(count)), key
        for mine, theirs in zip((st.sum_abs, st.sum_sq, st.autocorr),
                                moments):
            theirs = np.asarray(theirs)
            np.testing.assert_allclose(
                mine.numpy(), theirs, rtol=0,
                atol=MOMENT_TOL * float(np.abs(theirs).max()), err_msg=key)
    left = dict(stats)
    quantize_model_params(convert_params(_tree(params), model.cfg,
                                         device="cpu"),
                          PTQConfig(method="srr", rank=8, exact_svd=True,
                                    forced_k=3), stats=left, device="cpu")
    assert list(left) == [""]


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------
BUDGET = {0: 6, 1: 3, 2: 5, 3: 4}
COMMON = dict(max_len=48, decode_batch=2, prefill_len=16, max_new_tokens=6)


def _requests(req_cls, n=4):
    rng = np.random.default_rng(0)
    return [req_cls(uid=i, prompt=rng.integers(0, 256, size=5 + (i % 3))
                    .astype(np.int32), max_new_tokens=BUDGET[i])
            for i in range(n)]


def _bucket(req_cls):
    return [req_cls(uid=i, prompt=np.arange(6, dtype=np.int32) * (7 + i),
                    max_new_tokens=5) for i in range(2)]


@pytest.mark.parametrize("with_vision", [True, False],
                         ids=["vision", "none"])
@pytest.mark.parametrize("scheduler", ["continuous", "bucketed"])
def test_engine_tokens_identical_to_jax(quantized, scheduler, with_vision):
    """Greedy tokens equal the JAX engine's, with a seeded vision array
    through ``extra_inputs`` and with none (zeros, as JAX's
    ``_batch_for``): the continuous slots reused mid-flight, where every
    admission (a batch of one) takes ``vision[0]``, so the array cut to
    its first row gives the same tokens; the bucketed scheduler, whose
    lanes take ``vision[:2]``."""
    jcfg, qparams, model = quantized
    sc = dict(COMMON, kv_dtype="f32", scheduler=scheduler)
    vision = _vision(3, jcfg, 8)
    extra = {"vision": vision} if with_vision else None
    reqs = _requests if scheduler == "continuous" else _bucket
    want = JEngine(qparams, jcfg, JServeConfig(**sc),
                   extra_inputs=extra).generate(reqs(JRequest))

    def port(ex):
        eng = Engine(model, model.cfg, ServeConfig(**sc), device="cpu",
                     extra_inputs=ex)
        return [g.tokens.tolist() for g in eng.generate(reqs(Request))]

    got = port(extra)
    assert got == [w.tokens.tolist() for w in want]
    if scheduler == "continuous":
        assert [len(g) for g in got] == [6, 3, 5, 4]
    if with_vision and scheduler == "continuous":
        assert port({"vision": vision[:1]}) == got
    if not with_vision:
        assert port({"vision": np.zeros_like(vision)}) == got


@pytest.mark.parametrize("scheduler,plen,kw", [
    ("continuous", 13, dict(prefill_len=16)),
    ("continuous", 44, dict(prefill_len=48)),
    ("bucketed", 44, dict(prefill_len=16))],
    ids=["prefill_len", "max_len", "max_len-bucketed"])
def test_length_checks_count_the_prefix_like_jax(quantized, scheduler, plen,
                                                 kw):
    """A 13-token prompt fits ``prefill_len`` 16 alone but not with its 4
    vision rows; a 44-token one leaves no decode budget in 48 slots: the
    engine refuses both with JAX's message, and 12 and 43 tokens pass."""
    jcfg, qparams, model = quantized
    sc = dict(COMMON, scheduler=scheduler, **kw)
    req = dict(uid=5, prompt=np.ones((plen,), np.int32))
    jeng = JEngine(qparams, jcfg, JServeConfig(**sc))
    eng = Engine(model, model.cfg, ServeConfig(**sc), device="cpu")
    with pytest.raises(ValueError) as jerr:
        jeng._validate(JRequest(**req))
    with pytest.raises(ValueError) as err:
        eng._validate(Request(**req))
    assert str(err.value) == str(jerr.value)
    assert "vision" in str(err.value) or "prefill_len" in str(err.value)
    eng._validate(Request(uid=6, prompt=np.ones((plen - 1,), np.int32)))


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


def test_sanitizer_counts_the_prefix(quantized):
    """With the sanitizer on, the engine gives the bare engine's tokens
    (every lane's position is prompt + vision + generated − 1); a layer
    whose ``pos`` is off raises the ``pos`` verdict, naming the vision
    rows in its arithmetic."""
    _, _, model = quantized
    cfg = model.cfg
    sc = dict(COMMON, kv_dtype="bf16")
    extra = {"vision": _vision(1, cfg, 5)}
    want = [r.tokens.tolist() for r in Engine(
        model, cfg, ServeConfig(**sc), device="cpu",
        extra_inputs=extra).generate(_requests(Request))]
    eng = Engine(model, cfg, ServeConfig(**sc, sanitize=True), device="cpu",
                 extra_inputs=extra)
    assert [r.tokens.tolist() for r in eng.generate(_requests(Request))] \
        == want
    eng = Engine(model, cfg, ServeConfig(**sc, sanitize=True), device="cpu",
                 extra_inputs=extra)
    for r in _requests(Request)[:2]:
        eng.submit(r)
    eng.step()
    eng.step()
    eng.slots.cache[1]["pos"] = eng.slots.cache[1]["pos"] - 4
    with pytest.raises(SanitizerError, match=r"pos.*vision 4"):
        eng.step()


def test_check_supported_message_names_the_prefix():
    """The refusal names the prefix (``n_vision_tokens``)."""
    cfg = ModelConfig(**dict(dataclasses.asdict(ARCHS[ARCH]), moe=True,
                             n_routed=4, top_k=2, d_expert=32))
    with pytest.raises(NotImplementedError, match="n_vision_tokens=256"):
        check_supported(cfg)
