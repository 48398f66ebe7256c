"""Port parity: the decode-attention (K3) and flash-attention (K4) plain
versions — what the CPU runs — against the JAX Pallas kernels (interpret
mode) and the jnp oracles.

Tolerance: f32 math on both sides; 2e-5 absolute on outputs of
magnitude ~1 covers softmax/summation-order noise (bf16 outputs: one
bf16 ulp at 1, 2^-8).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.ref import decode_attention_ref
from repro.models.attention import kv_quantize as jkv_quantize
from repro.quant.mxint import pack_codes_4bit
from repro_torch.kernels.decode_attention import decode_attention_op
from repro_torch.kernels.flash_attention import flash_attention


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _decode_case(kind, b=3, kvh=2, g=1, s=50, hd=24, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, kvh, g, hd)).astype(np.float32)
    k = rng.standard_normal((b, kvh, s, hd)).astype(np.float32)
    v = rng.standard_normal((b, kvh, s, hd)).astype(np.float32)
    q_pos = np.array([s - 1, 17, 0][:b], np.int32)
    k_pos = np.tile(np.arange(s, dtype=np.int32), (b, 1))
    k_pos[1, 30:] = -1                                # a partly empty row
    k_pos[2, :] = -1                                  # an empty row → zeros
    ks = vs = None
    if kind in ("int8", "int4"):
        qmax = 127 if kind == "int8" else 7
        kc, ks = jkv_quantize(jnp.asarray(k.transpose(0, 2, 1, 3)), qmax)
        vc, vs = jkv_quantize(jnp.asarray(v.transpose(0, 2, 1, 3)), qmax)
        k = np.asarray(kc).transpose(0, 2, 1, 3)
        v = np.asarray(vc).transpose(0, 2, 1, 3)
        ks = np.asarray(ks).transpose(0, 2, 1)
        vs = np.asarray(vs).transpose(0, 2, 1)
        if kind == "int4":
            k = np.asarray(pack_codes_4bit(jnp.asarray(k)))
            v = np.asarray(pack_codes_4bit(jnp.asarray(v)))
    elif kind == "bf16":
        k = np.asarray(jnp.asarray(k, jnp.bfloat16))
        v = np.asarray(jnp.asarray(v, jnp.bfloat16))
    return q, k, v, q_pos, k_pos, ks, vs


def _kv_torch(a):
    if a.dtype == jnp.bfloat16:
        return _t(a.astype(np.float32)).to(torch.bfloat16)
    return _t(a)


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8", "int4"])
@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("window", [0, 9])
def test_decode_plain_matches_jax(kind, g, window):
    q, k, v, q_pos, k_pos, ks, vs = _decode_case(kind, g=g, seed=g + window)
    jargs = dict(k_scale=None if ks is None else jnp.asarray(ks),
                 v_scale=None if vs is None else jnp.asarray(vs),
                 window=window)
    want = np.asarray(jops.decode_attention_op(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(q_pos),
        jnp.asarray(k_pos), kernel=True, **jargs))
    ref = np.asarray(decode_attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(q_pos),
        jnp.asarray(k_pos), jargs["k_scale"], jargs["v_scale"], window=window))
    got = decode_attention_op(
        _t(q), _kv_torch(k), _kv_torch(v), _t(q_pos), _t(k_pos),
        k_scale=None if ks is None else _t(ks),
        v_scale=None if vs is None else _t(vs), window=window).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5)
    assert np.all(got[2] == 0.0)                      # empty row


def test_decode_plain_score_scale_override():
    q, k, v, q_pos, k_pos, _, _ = _decode_case("f32")
    want = np.asarray(jops.decode_attention_op(
        *(jnp.asarray(a) for a in (q, k, v, q_pos, k_pos)), scale=0.125,
        kernel=True))
    got = decode_attention_op(*(_t(a) for a in (q, k, v, q_pos, k_pos)),
                              scale=0.125).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


@pytest.mark.parametrize("g,window,sk", [(1, 0, 40), (2, 0, 40), (2, 7, 40),
                                         (1, 0, 24)])
def test_flash_plain_matches_jax(g, window, sk):
    rng = np.random.default_rng(g * 10 + window)
    b, sq, kvh, hd = 2, 40, 2, 24
    q = rng.standard_normal((b, sq, kvh, g, hd)).astype(np.float32)
    k = rng.standard_normal((b, sk, kvh, hd)).astype(np.float32)
    v = rng.standard_normal((b, sk, kvh, hd)).astype(np.float32)
    q_pos = np.arange(sq, dtype=np.int32)
    k_pos = np.arange(sk, dtype=np.int32)
    k_pos[-3:] = -1                                   # invalid key slots
    want = np.asarray(jops.flash_attention(
        *(jnp.asarray(a) for a in (q, k, v, q_pos, k_pos)), causal=True,
        window=window, bq=16, bk=16))                 # padded Sq/Sk tiles
    got = flash_attention(*(_t(a) for a in (q, k, v, q_pos, k_pos)),
                          causal=True, window=window).numpy()
    # rows whose every key is masked are undefined in the TPU kernel
    valid = (q_pos[:, None] >= np.where(k_pos >= 0, k_pos, 1 << 30)[None, :])
    if window:
        valid &= q_pos[:, None] - k_pos[None, :] < window
    rows = valid.any(-1)
    np.testing.assert_allclose(got[:, rows], want[:, rows], rtol=0, atol=2e-5)
