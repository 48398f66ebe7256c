"""Port parity: whisper-large-v3's encoder-decoder (a bidirectional
encoder over the ``frames`` stub, cross attention in every decoder
block, GELU, LayerNorm) against the JAX package on the CPU.

The reduced config keeps the family's structure: 2 encoder and 2 decoder
layers, d 64, 4 heads (MHA) of 16, GELU MLP 128 wide, enc_seq 8 frames
of 64, vocabulary 256. Weights are JAX's ``init_lm`` tree filled from a
numpy seed (every LayerNorm's gain and shift too, so that those paths
carry real values), fp or through JAX's SRR pass, converted to the port;
inputs from numpy seeds. JAX's Pallas kernels run in interpret
mode (``fused="on"``), as its own tests run them, against the port's
plain versions.

Tolerances: the frames stub, the converted containers and greedy tokens
exact; the encoder, the cross memory and the cross attention 1e-5 of
their largest magnitude (or absolute below 1; f32 sums in another order
than XLA's); logits 1e-4 with f32 KV and 2e-3 with bf16, int8 or int4
KV, whose cross memory is bf16: the two frameworks round it to bf16
separately, and a 1-ulp f32 difference at a rounding boundary moves a
stored element by 2^-8 relative (``test_torch_model.py``'s bf16 rule); a
bf16 cross cache one bf16 ulp (2^-8) of its scale, an f32 one 1e-5;
calibration moments 1e-5 of their largest entry.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core.api import PTQConfig as JPTQConfig
from repro.data import data_config_for as jdata_config_for
from repro.data import host_batch as jhost_batch
from repro.kernels.ops import flash_attention as jflash_attention
from repro.models import Ctx as JCtx
from repro.models import decode_step as jdecode_step
from repro.models import init_cache as jinit_cache
from repro.models import init_lm as jinit_lm
from repro.models import lm_loss as jlm_loss
from repro.models import prefill as jprefill
from repro.models.attention import cross_attention as jcross_attention
from repro.models.attention import cross_memory as jcross_memory
from repro.models.quantize import _stats_for as jstats_for
from repro.models.quantize import quantize_model_params as jquantize
from repro.models.transformer import encode as jencode
from repro.quant.base import QuantizerConfig
from repro.serve import Engine as JEngine
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro_torch.configs import ARCHS, get_config
from repro_torch.convert import convert_params
from repro_torch.core.api import PTQConfig
from repro_torch.data import capture_calibration, data_config_for, host_batch
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.models import (Ctx, decode_step, init_cache, init_lm,
                                lm_loss, prefill, prefill_chunk)
from repro_torch.models import quantize as port_quantize
from repro_torch.models.attention import (INT4, cross_attention,
                                          cross_memory, restore_step_writes,
                                          save_step_writes)
from repro_torch.models.layers import LayerNorm
from repro_torch.models.linear import FpLinear, QLinear
from repro_torch.models.quantize import quantize_model_params
from repro_torch.models.transformer import check_supported, encode
from repro_torch.serve import Engine, Request, ServeConfig
from repro_torch.serve.sanitizer import SanitizerError

ARCH = "whisper-large-v3"
LOGIT_TOL = 1e-4
ENC_TOL = 1e-5
MOMENT_TOL = 1e-5
KV_KINDS = {"f32": (jnp.float32, torch.float32),
            "bf16": (jnp.bfloat16, torch.bfloat16),
            "int8": (jnp.int8, torch.int8), "int4": ("int4", INT4)}
ATTENTION = ("wq", "wk", "wv", "wo")


def _t(a):
    a = np.asarray(a)
    return torch.from_numpy(a.astype(np.float32) if a.dtype == jnp.bfloat16
                            else a.copy())


def _tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _close(got, want, tol=ENC_TOL, what=""):
    """``got`` within ``tol`` of ``want``'s largest magnitude (or 1)."""
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(
        got.float().numpy(), want, rtol=0,
        atol=tol * max(1.0, float(np.abs(want).max())), err_msg=what)


def _numpy_params(jcfg, seed):
    """JAX's ``init_lm`` tree for ``jcfg`` (its structure and shapes,
    traced, not run) filled from a numpy seed: each weight N(0, 1/m) for
    its m input rows, the embedding N(0, 0.02²), every LayerNorm's gain
    1 + N(0, 0.2²) and shift N(0, 0.1²), so those paths carry real
    values."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda k: jinit_lm(k, jcfg),
                            jax.random.PRNGKey(0))

    def fill(path, leaf):
        name = str(getattr(path[-1], "key", ""))
        if name == "g":
            a = 1 + 0.2 * rng.standard_normal(leaf.shape)
        elif name == "b":
            a = 0.1 * rng.standard_normal(leaf.shape)
        elif str(getattr(path[0], "key", "")) == "embed":
            a = 0.02 * rng.standard_normal(leaf.shape)
        else:
            a = rng.standard_normal(leaf.shape) / np.sqrt(leaf.shape[-2])
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


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
    """(JAX config, the fp params, the converted model) of the reduced
    config."""
    jcfg, cfg = jget_config(ARCH).reduced(), get_config(ARCH).reduced()
    tree = _numpy_params(jcfg, 7)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    return jcfg, params, convert_params(tree, cfg, device="cpu")


@pytest.fixture(scope="module")
def quantized(fp_model):
    """(JAX config, JAX SRR-quantized params (int8), the converted
    model)."""
    jcfg, params, model = fp_model
    ptq = JPTQConfig(method="srr", rank=8, exact_svd=True, forced_k=3,
                     quantizer=QuantizerConfig(kind="mxint", bits=3,
                                               block_size=32))
    qparams, _ = jquantize(params, None, ptq)
    return jcfg, qparams, convert_params(_tree(qparams), model.cfg,
                                         device="cpu")


def _frames(b, cfg, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, cfg.enc_seq, cfg.d_frontend)
                               ).astype(np.float32)


def _dec(params, name):
    """The JAX decoder blocks' subtree ``name`` (stacked over layers)."""
    return params["groups"]["p0"][name]


# ---------------------------------------------------------------------------
# the frames stub, K4's non-causal plain version, the encoder
# ---------------------------------------------------------------------------
def test_frames_stub_matches_jax():
    """``host_batch`` of an encoder-decoder draws JAX's frames bit for
    bit (host 1 of 2, step 3) beside its tokens; the full config's stub is
    1500 × 1280."""
    jcfg, cfg = jget_config(ARCH).reduced(), get_config(ARCH).reduced()
    want = jhost_batch(jdata_config_for(jcfg, 16, 4, 5), 3, 1, 2)
    got = host_batch(data_config_for(cfg, 16, 4, 5), 3, 1, 2, device="cpu")
    assert sorted(got) == sorted(want) == ["frames", "labels", "tokens"]
    assert got["frames"].dtype == torch.float32
    assert got["frames"].shape == (2, 8, 64)
    for key in want:
        assert np.array_equal(got[key].numpy(), np.asarray(want[key])), key
    assert data_config_for(ARCHS[ARCH], 16, 4).frames == (1500, 1280)
    assert data_config_for(ARCHS["phi3-mini-3.8b"], 16, 4).frames is None


def test_flash_attention_noncausal_matches_jax_kernel():
    """K4's plain version with ``causal=False`` against JAX's Pallas
    flash kernel (interpret mode) through its wrapper, at head dim 64 and
    blocks of 8: 13 queries and 21 keys, which the wrapper pads to 16 and
    24 (k_pos = −1 on the pad)."""
    rng = np.random.default_rng(21)
    q = rng.standard_normal((2, 13, 3, 1, 64)).astype(np.float32)
    k, v = (rng.standard_normal((2, 21, 3, 64)).astype(np.float32)
            for _ in range(2))
    qp, kp = np.arange(13, dtype=np.int32), np.arange(21, dtype=np.int32)
    want = jflash_attention(*(jnp.asarray(a) for a in (q, k, v, qp, kp)),
                            causal=False, bq=8, bk=8)
    got = flash_attention_plain(*(_t(a) for a in (q, k, v, qp, kp)),
                                causal=False)
    _close(got, want)


def test_encode_matches_jax(fp_model):
    """Frames plus the sinusoid, two bidirectional blocks (RoPE inside
    each attention, as JAX's ``_qkv`` applies it) and the final
    LayerNorm."""
    jcfg, params, model = fp_model
    frames = _frames(2, jcfg, 4)
    want = jax.jit(lambda p, f: jencode(JCtx(fused="off"), p, f, jcfg))(
        params, jnp.asarray(frames))
    got = encode(Ctx(fused="off"), model, _t(frames))
    assert got.shape == (2, 8, 64)
    _close(got, want)


def test_cross_memory_and_attention_match_jax(fp_model):
    """Layer 1's cross K/V of an encoder output, the prefill form over
    the fresh f32 memory (K4's route, non-causal), and the decode form
    over a bf16 head-major copy of it (K3's route, every slot valid) in
    both lowerings, against JAX's ``cross_memory`` / ``cross_attention``
    (the decode form over the bf16 values in f32: JAX would round its
    probabilities to bf16, the deviation the next test shows)."""
    jcfg, params, model = fp_model
    cfg = model.cfg
    jp = jax.tree_util.tree_map(lambda a: a[1], _dec(params, "cross"))
    blk = model.blocks[1].cross
    rng = np.random.default_rng(5)
    memory = rng.standard_normal((2, 8, 64)).astype(np.float32)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    jctx = JCtx(fused="off")
    jattend = jax.jit(lambda p_, x_, k_, v_: jcross_attention(
        jctx, p_, x_, (k_, v_), jcfg))
    jk, jv = jax.jit(lambda p_, m_: jcross_memory(jctx, p_, m_, jcfg))(
        jp, jnp.asarray(memory))
    k, v = cross_memory(Ctx(), blk, _t(memory), cfg)
    assert k.shape == (2, 8, 4, 16)
    _close(k, jk)
    _close(v, jv)
    want = jattend(jp, jnp.asarray(x), jk, jv)
    for fused in ("off", "auto"):
        _close(cross_attention(Ctx(fused=fused), blk, _t(x), k, v, cfg),
               want, what=fused)
    jkb, jvb = (a.astype(jnp.bfloat16).astype(jnp.float32) for a in (jk, jv))
    want = jattend(jp, jnp.asarray(x[:, :1]), jkb, jvb)
    kb = k.transpose(1, 2).bfloat16().contiguous()
    vb = v.transpose(1, 2).bfloat16().contiguous()
    for fused in ("off", "auto"):
        got = cross_attention(Ctx(fused=fused), blk, _t(x[:, :1]), kb, vb,
                              cfg, head_major=True)
        _close(got, want, what=f"decode {fused}")


def test_jax_rounds_cross_probabilities_to_bf16(fp_model):
    """JAX's ``blockwise_attention`` casts the probabilities to V's dtype
    (``repro/models/attention.py:130``), so its decode cross attention
    over a bf16 memory rounds them to bf16; the port keeps them f32, as
    its self-attention decode and JAX's (``_cache_kv`` upcasts the cache
    first) do (ROADMAP §3). The two differ past the tolerance; the port's
    output is JAX's over the same bf16 values held in f32."""
    jcfg, params, model = fp_model
    jp = jax.tree_util.tree_map(lambda a: a[0], _dec(params, "cross"))
    rng = np.random.default_rng(6)
    kb, vb = (rng.standard_normal((2, 8, 4, 16)).astype(jnp.bfloat16)
              for _ in range(2))
    x = rng.standard_normal((2, 1, 64)).astype(np.float32)
    attend = jax.jit(lambda p_, x_, k_, v_: jcross_attention(
        JCtx(fused="off"), p_, x_, (k_, v_), jcfg))
    rounded = attend(jp, jnp.asarray(x), kb, vb)
    exact = attend(jp, jnp.asarray(x), kb.astype(np.float32),
                   vb.astype(np.float32))
    assert float(np.abs(np.asarray(rounded) - np.asarray(exact)).max()) > \
        10 * ENC_TOL
    got = cross_attention(Ctx(), model.blocks[0].cross, _t(x),
                          *(_t(a).bfloat16().transpose(1, 2).contiguous()
                            for a in (kb, vb)), model.cfg, head_major=True)
    _close(got, exact)


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------
LENGTHS, SLOTS = [20, 13, 18], 24


@pytest.mark.parametrize("kv", list(KV_KINDS))
def test_whisper_logits_match_jax(quantized, kv):
    """Prompts of 20, 13 and 18 tokens (right-padded, ``lengths``) over
    seeded frames, then three greedy decode steps, logits every step,
    over the SRR-quantized model, through both of the port's lowerings:
    ``fused="off"`` (dequantize-then-matmul, dense masked softmax) and the
    kernel route (the K1/K2, K3 and K4 wrappers, which run their plain
    versions on the CPU) against JAX's function; the cross cache after
    the prefill, transposed to JAX's (B, enc_seq, KV, hd), against JAX's,
    in the cache's float type (bf16 under int8/int4) and untouched by the
    decode steps. JAX decodes over its bf16 cross memory's values held in
    f32 (its own cache otherwise): the port keeps the cross probabilities
    f32 (the test above)."""
    jcfg, params, model = quantized
    jdt, dt = KV_KINDS[kv]
    tol = LOGIT_TOL if kv == "f32" else 2e-3
    b = len(LENGTHS)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, jcfg.vocab, (b, max(LENGTHS))).astype(np.int32)
    lens = np.asarray(LENGTHS, np.int32)
    frames = _frames(b, jcfg, 9)
    jctx = JCtx(fused="off")
    jl, jc = jax.jit(lambda p, t, f, c, n: jprefill(
        jctx, p, {"tokens": t, "frames": f}, jcfg, c, lengths=n))(
        params, jnp.asarray(toks), jnp.asarray(frames),
        jinit_cache(jcfg, b, SLOTS, dtype=jdt), jnp.asarray(lens))
    jdec = jax.jit(lambda p, t, c: jdecode_step(jctx, p, t, c, jcfg))
    fdt = torch.bfloat16 if kv in ("int8", "int4") else dt
    want = {key: jc["groups"]["p0"][key] for key in ("cross_k", "cross_v")}
    jc["groups"]["p0"] = dict(jc["groups"]["p0"], **{
        key: a.astype(jnp.float32) for key, a in want.items()})
    jlogits = [np.asarray(jl)]
    for _ in range(3):
        tok = np.argmax(jlogits[-1][:, -1], -1)[:, None].astype(np.int32)
        jl, jc = jdec(params, jnp.asarray(tok), jc)
        jlogits.append(np.asarray(jl))
    for fused in ("off", "auto"):
        ctx = Ctx(fused=fused)
        tl, tc = prefill(ctx, model, _t(toks).long(),
                         init_cache(model.cfg, b, SLOTS, dt, "cpu"),
                         lengths=_t(lens), frames=_t(frames))
        np.testing.assert_allclose(tl.numpy(), jlogits[0], rtol=0, atol=tol,
                                   err_msg=fused)
        ctol = 2 ** -8 if fdt == torch.bfloat16 else ENC_TOL
        for key, stacked in want.items():                # (L, B, Sm, KV, hd)
            for i, c in enumerate(tc):
                assert c[key].dtype == fdt and c[key].shape == (b, 4, 8, 16)
                _close(c[key].transpose(1, 2), stacked[i], ctol,
                       f"{fused} L{i} {key}")
        cross = [(c["cross_k"].clone(), c["cross_v"].clone()) for c in tc]
        for step in range(3):
            tok = np.argmax(jlogits[step][:, -1], -1)[:, None]
            tl, tc = decode_step(ctx, model, torch.from_numpy(tok).long(), tc)
            np.testing.assert_allclose(tl.numpy(), jlogits[step + 1], rtol=0,
                                       atol=tol, err_msg=f"{fused} {step}")
        assert all(torch.equal(c["cross_k"], k) and
                   torch.equal(c["cross_v"], v)
                   for c, (k, v) in zip(tc, cross))
        assert tc[0]["pos"].tolist() == [23, 16, 21]


# ---------------------------------------------------------------------------
# the converter, calibration, the PTQ pass and JAX's lookup
# ---------------------------------------------------------------------------
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


@pytest.mark.parametrize("container", ["fp", "int8", "packed4"])
def test_converter_takes_whisper(fp_model, quantized, container):
    """Every encoder projection, decoder self and cross projection and
    GELU MLP arrives bit for bit in its container (fp, int8 or packed4),
    with no ``gate``; the norms (encoder, ``norm_x``, final) as they are;
    no ``frontend_proj`` (d_frontend = d_model)."""
    tree = _tree(fp_model[1] if container == "fp" else quantized[1])
    if container == "packed4":
        tree = _packed4(tree)
    model = convert_params(tree, fp_model[2].cfg, device="cpu")
    assert model.frontend_proj is None and len(model.encoder) == 2
    kind = FpLinear if container == "fp" else QLinear
    sides = [(model.encoder, tree["encoder"]["blocks"], ("mixer", "mlp")),
             (model.blocks, tree["groups"]["p0"], ("mixer", "cross", "mlp"))]
    for blocks, jt, owners in sides:
        for i, blk in enumerate(blocks):
            for owner in owners:
                mod = getattr(blk, owner)
                names = ("up", "down") if owner == "mlp" else ATTENTION
                for n in names:
                    p = getattr(mod, n)
                    assert isinstance(p, kind), (owner, n)
                    for key, want in jt[owner][n].items():
                        assert np.array_equal(getattr(p, key).numpy(),
                                              want[i]), (i, owner, n, key)
                assert owner != "mlp" or mod.gate is None
            for norm in ("norm1", "norm2") + (("norm_x",) if blk.cross
                                              else ()):
                assert isinstance(getattr(blk, norm), LayerNorm)
                assert np.array_equal(getattr(blk, norm).b.numpy(),
                                      jt[norm]["b"][i])
    assert np.array_equal(model.enc_norm.g.numpy(),
                          tree["encoder"]["final_norm"]["g"])


@pytest.fixture(scope="module")
def calibrated(fp_model):
    """(JAX's taps, the port's) of one calibration batch of 4 × 16 tokens
    and 4 × 8 frames. JAX's side is what its ``capture_calibration`` runs
    for one batch — its ``Ctx`` tap through ``lm_loss`` over
    ``host_batch(step 0)`` — traced once under ``jit`` instead of op by
    op, the taps' insertion order read at trace time; each tap comes back
    as (count, Σ|x|, Σx², Σxxᵀ)."""
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
    jstats = {k: out[k] for k in order}
    stats = capture_calibration(model, data_config_for(model.cfg, 16, 4, 0),
                                lm_loss, n_batches=1, device="cpu")
    return jstats, stats


def test_calibration_taps_match_jax(calibrated):
    """JAX's 32 tap names, the encoder's first (``E<e>.attn.*``,
    ``E<e>..up``/``..down`` over the 4 × 8 frames), then the decoder's
    (``L<i>.attn.*``, ``L<i>.xattn.*``, ``L<i>..up``/``..down``), with
    JAX's counts and moments; the cross ``wk``/``wv`` share the memory's
    moments."""
    jstats, stats = calibrated
    assert list(stats) == list(jstats) and len(stats) == 32
    assert all(k.startswith("E") for k in list(stats)[:12])
    for i in (0, 1):
        assert stats[f"L{i}.xattn.wk"] is stats[f"L{i}.xattn.wv"]
        assert stats[f"E{i}.attn.wq"].count == 4 * 8
    for key, st in stats.items():
        count, *moments = jstats[key]
        assert st.count == int(float(count)), key
        for mine, theirs in zip((st.sum_abs, st.sum_sq, st.autocorr),
                                moments):
            theirs = np.asarray(theirs)
            np.testing.assert_allclose(
                mine.numpy(), theirs, rtol=0,
                atol=MOMENT_TOL * float(np.abs(theirs).max()), err_msg=key)


def test_pass_quantizes_each_projection_under_its_layer(calibrated,
                                                        monkeypatch):
    """The port's pass hands ``encoder.<e>.*`` the moments of ``E<e>.*``
    and the decoder's self, cross and MLP projections those of
    ``L<i>.attn.*``, ``L<i>.xattn.*`` and ``L<i>..*``: 32 matrices, the
    norms untouched."""
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
    assert len(reports) == 32
    want = {}
    for e in range(2):
        for n in ATTENTION:
            want[f"encoder.{e}.mixer.{n}"] = f"E{e}.attn.{n}"
        for n in ("up", "down"):
            want[f"encoder.{e}.mlp.{n}"] = f"E{e}..{n}"
    for i in range(2):
        for n in ATTENTION:
            want[f"blocks.{i}.mixer.{n}"] = f"L{i}.attn.{n}"
            want[f"blocks.{i}.cross.{n}"] = f"L{i}.xattn.{n}"
        for n in ("up", "down"):
            want[f"blocks.{i}.mlp.{n}"] = f"L{i}..{n}"
    assert sorted(seen) == sorted(want)
    for name, key in want.items():
        assert seen[name] is keep[key], name
    assert isinstance(model.blocks[1].cross.wk, QLinear)
    assert isinstance(model.blocks[1].norm_x, LayerNorm)


@pytest.mark.parametrize("path,key", [
    (["encoder", "blocks", "mixer", "wq"], "E0.attn.wq"),
    (["groups", "p0", "mixer", "wq"], "E0.attn.wq"),
    (["groups", "p0", "cross", "wq"], "E0.attn.wq"),
    (["groups", "p0", "cross", "wk"], "E0.attn.wk"),
    (["groups", "p0", "cross", "wo"], "E0.attn.wo"),
    (["groups", "p0", "mlp", "up"], "E0..up"),
    (["groups", "p0", "mlp", "down"], "E0..down")])
def test_jax_pass_reads_the_first_encoder_layer_stats(calibrated, path, key):
    """JAX's calibration records the encoder first, so its pass (empty
    layer hint, then the suffix match in insertion order) hands every
    whisper projection ``E0.``'s statistics: the decoder's self and
    cross attention and its MLP too, and the cross ``wk``/``wv`` (fed the
    encoder's normed output) the encoder's raw input's (ROADMAP §3). The
    port's pass takes each layer's own (the test above)."""
    jstats, _ = calibrated
    assert jstats_for(jstats, path + ["w"], "") is jstats[key]
    own = {"encoder": "E1.attn.", "mixer": "L1.attn.", "cross": "L1.xattn.",
           "mlp": "L1.."}[path[0] if path[0] == "encoder" else path[2]]
    assert jstats[own + path[-1]] is not jstats[key]


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


@pytest.mark.parametrize("scheduler", ["continuous", "bucketed"])
def test_engine_tokens_identical_to_jax(quantized, scheduler):
    """Greedy tokens over the SRR-quantized model, with seeded frames
    through ``extra_inputs``, equal the JAX engine's: the continuous slots
    reused mid-flight, and the bucketed scheduler, whose lanes take
    ``frames[:2]``. A continuous admission is a batch of one: every
    request takes ``frames[0]``, so the frames cut to their first row give
    the same tokens; no frames is zeros, as in JAX's ``_batch_for``; the
    prefill template is still all zeros, cross memory included. f32 KV:
    over a bf16 cross memory JAX rounds the decode's probabilities (the
    deviation above)."""
    jcfg, qparams, model = quantized
    sc = dict(COMMON, kv_dtype="f32", scheduler=scheduler)
    frames = _frames(3, jcfg, 8)
    if scheduler == "continuous":
        reqs = _requests
    else:     # one bucket: one prompt length
        def reqs(cls):
            return [cls(uid=i, prompt=np.arange(5, dtype=np.int32) * (7 + i),
                        max_new_tokens=5) for i in range(2)]
    want = JEngine(qparams, jcfg, JServeConfig(**sc),
                   extra_inputs={"frames": frames}).generate(reqs(JRequest))

    def port(extra):
        eng = Engine(model, model.cfg, ServeConfig(**sc), device="cpu",
                     extra_inputs=extra)
        return eng, [g.tokens.tolist() for g in eng.generate(reqs(Request))]

    eng, got = port({"frames": frames})
    assert got == [w.tokens.tolist() for w in want]
    if scheduler == "continuous":
        assert [len(g) for g in got] == [6, 3, 5, 4]
        for mine in eng.slots.prefill_cache:
            assert "cross_k" in mine
            assert all(not t.any() for k, t in mine.items() if k != "slot_pos")
        assert port({"frames": frames[:1]})[1] == got
    assert port(None)[1] == port({"frames": np.zeros_like(frames)})[1]


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


def test_no_chunked_prefill(fp_model):
    """A chunk has no encoder pass to write the cross memory from."""
    model = fp_model[2]
    cache = init_cache(model.cfg, 1, 16, torch.float32, "cpu")
    with pytest.raises(ValueError, match="chunked prefill has no encoder"):
        prefill_chunk(Ctx(), model, torch.zeros((1, 4), dtype=torch.long),
                      cache, 0, 0, 4)


def test_drift_probe_and_sanitizer_on_whisper(quantized):
    """At drift rate 1.0 with the sanitizer on, the engine gives the bare
    engine's tokens; one reference step over a live int4 cache leaves
    every tensor, the cross memory included, bit for bit; a decoder
    layer whose ``pos`` is off raises the sanitizer's ``pos`` verdict."""
    _, _, model = quantized
    cfg = model.cfg
    sc = dict(COMMON, kv_dtype="int4")
    want = [r.tokens.tolist() for r in Engine(
        model, cfg, ServeConfig(**sc), device="cpu").generate(
            _requests(Request))]
    eng = Engine(model, cfg, ServeConfig(**sc, sanitize=True,
                                         drift_monitor=True,
                                         drift_sample_rate=1.0),
                 device="cpu")
    assert [r.tokens.tolist() for r in eng.generate(_requests(Request))] \
        == want
    assert eng.stats()["drift_checks"] > 0
    assert eng.stats()["drift_nonfinite"] == 0

    toks = torch.from_numpy(np.random.default_rng(4).integers(0, 256, (2, 21)))
    _, cache = prefill(Ctx(), model, toks,
                       init_cache(cfg, 2, 32, INT4, "cpu"),
                       lengths=torch.tensor([21, 9], dtype=torch.int32),
                       frames=_t(_frames(2, cfg, 2)))
    tok = torch.tensor([[3], [7]])
    decode_step(Ctx(), model, tok, cache)
    before = [{k: v.clone() for k, v in c.items()} for c in cache]
    saved = [save_step_writes(c) for c in cache]
    decode_step(Ctx(fused="off"), model, tok, cache)
    assert not torch.equal(cache[0]["k"], before[0]["k"])
    for c, sv in zip(cache, saved):
        restore_step_writes(c, sv)
    for c, b in zip(cache, before):
        assert c.keys() == b.keys()
        assert all(torch.equal(c[k], b[k]) for k in c)

    eng = Engine(model, cfg, ServeConfig(**sc, sanitize=True), device="cpu")
    for r in _requests(Request)[:2]:
        eng.submit(r)
    eng.step()
    eng.step()
    eng.slots.cache[1]["pos"] = eng.slots.cache[1]["pos"] + 3
    with pytest.raises(SanitizerError, match="pos"):
        eng.step()


# ---------------------------------------------------------------------------
# registry and refusals
# ---------------------------------------------------------------------------
def test_registered_and_laid_out():
    """The port's copy of the config equals JAX's field for field and is
    admitted; a reduced init has 2 encoder blocks without cross
    attention, LayerNorms and gate-less GELU MLPs; at full width a lane's
    cross memory is 245,760,000 bytes in bf16 (32 layers × K and V × 20
    heads × 1500 × 64), the same under int8 KV, which leaves it bf16."""
    cfg = ARCHS[ARCH]
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jget_config(ARCH))
    check_supported(cfg)
    model = init_lm(cfg.reduced(), 0, device="cpu")
    assert len(model.encoder) == 2
    assert all(blk.cross is None for blk in model.encoder)
    assert all(isinstance(blk.norm_x, LayerNorm) for blk in model.blocks)
    assert model.blocks[0].mlp.gate is None
    assert model.blocks[0].mlp.up.w.shape == (64, 128)
    for kv in (torch.bfloat16, torch.int8):
        full = init_cache(cfg, 1, 8, kv, "meta")
        assert sum(c[k].numel() * c[k].element_size() for c in full
                   for k in ("cross_k", "cross_v")) == 245_760_000
        assert {c["cross_k"].dtype for c in full} == {torch.bfloat16}


@pytest.mark.parametrize("kw", [dict(n_vision_tokens=4), dict(act="swiglu"),
                                dict(norm="rmsnorm"), dict(rope_kind="half"),
                                dict(moe=True, n_routed=4, top_k=2,
                                     d_expert=32),
                                dict(block_pattern=("attn", "local"))])
def test_other_encoder_decoders_stay_refused(kw):
    """A vision prefix beside the encoder, a SwiGLU or RMSNorm
    encoder-decoder, half RoPE, an MoE or a local layer are refused (the
    VLM config itself, a decoder, is admitted: ``tests/test_torch_vlm.py``)."""
    with pytest.raises(NotImplementedError):
        check_supported(dataclasses.replace(ARCHS[ARCH], **kw))
