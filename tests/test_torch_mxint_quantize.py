"""Port parity for K7, MXINT block quantization: the plain version
``mxint_quantize_plain`` (what the wrapper runs for a CPU tensor, and
what the CUDA kernel is held to bit for bit on the card) against the
JAX package's ``ops.mxint_quantize`` (the Pallas kernel in interpret
mode) and ``ref.mxint_quantize_ref``. Integer results: bit-exact.

The recorded exception (ROADMAP §3): where amax / qmax is a power of two
or a few ulps above one, the reference's rounded ``log2`` puts the
exponent one off in either direction; the port keeps the exact
``ceil(log2(·))`` there, checked against float64 arithmetic below.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import mxint_quantize as kq
from repro_torch.quant.mxint import MXIntQuantizer


def _weights(seed, m=96, n=300):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((m, n)) * 0.05).astype(np.float32)
    w[:32, :7] = 0.0                          # all-zero blocks
    w[32:64, 11] *= 1e4                       # a wide-range column
    w[64:, 12] *= 1e-30                       # tiny blocks, exponents < -100
    return w


@pytest.mark.parametrize("bits", [2, 3, 4, 5, 6, 7, 8])
def test_plain_bit_exact_against_jax_kernel_and_ref(bits):
    w = _weights(bits)
    codes, exps = kq.mxint_quantize_plain(torch.from_numpy(w), bits)
    assert codes.dtype == exps.dtype == torch.int8
    assert codes.shape == w.shape and exps.shape == (w.shape[0] // 32, w.shape[1])
    want_c, want_e = jref.mxint_quantize_ref(jnp.asarray(w), bits=bits)
    assert np.array_equal(codes.numpy(), np.asarray(want_c))
    assert np.array_equal(exps.numpy(), np.asarray(want_e))
    kern_c, kern_e = jops.mxint_quantize(jnp.asarray(w), bits=bits)
    assert np.array_equal(codes.numpy(), np.asarray(kern_c))
    assert np.array_equal(exps.numpy(), np.asarray(kern_e))
    # the zero blocks: zero codes, the reference's exponent of 1 / qmax
    assert not codes.numpy()[:32, :7].any()


def _exact_exponent(q):
    """ceil(log2(q)) of positive f32 values in float64 arithmetic, where
    log2 of an f32 is exact to far below the distance to an integer."""
    e = np.ceil(np.log2(q.astype(np.float64)))
    exact_pow = np.ldexp(1.0, e.astype(np.int64) - 1) == q
    return (e - exact_pow).astype(np.int64)      # guard log2 of 2^k itself


@pytest.mark.parametrize("bits", [3, 8])
def test_exponent_exact_at_and_just_above_powers_of_two(bits):
    qmax = 2 ** (bits - 1) - 1
    k = np.arange(-100, 101)
    base = np.ldexp(np.float32(1), k).astype(np.float32)
    q = np.stack([base, np.nextafter(base, np.float32(np.inf)),
                  np.nextafter(np.nextafter(base, np.float32(np.inf)),
                               np.float32(np.inf)),
                  np.nextafter(base, np.float32(0))]).reshape(-1)
    amax = (q.astype(np.float64) * qmax).astype(np.float32)
    # keep the amaxes whose f32 quotient by qmax is the q we meant
    amax = amax[(amax / np.float32(qmax)).astype(np.float32) == q]
    w = np.zeros((32, amax.size), np.float32)
    w[7] = amax
    w[20] = -amax / 3
    codes, exps = kq.mxint_quantize_plain(torch.from_numpy(w), bits)
    quot = (amax / np.float32(qmax)).astype(np.float32)
    assert np.array_equal(exps.numpy()[0], _exact_exponent(quot))
    scale = np.ldexp(np.float32(1), exps.numpy()[0].astype(np.int64))
    want = np.clip(np.round(w / scale), -qmax - 1, qmax)
    assert np.array_equal(codes.numpy(), want.astype(np.int8))


def test_ceil_log2_matches_float64_over_the_f32_range():
    rng = np.random.default_rng(0)
    bits = rng.integers(1, 0x7F7FFFFF, 200_000, dtype=np.uint32)
    q = bits.view(np.float32)                      # every binade, subnormals
    q = q[np.isfinite(q) & (q > 0)]
    got = kq.ceil_log2(torch.from_numpy(q)).numpy()
    assert np.array_equal(got, _exact_exponent(q))


def test_quantizer_pads_rows_and_runs_the_wrapper():
    w = _weights(9, m=70, n=40)
    q = MXIntQuantizer(bits=3).quantize(torch.from_numpy(w))
    padded = np.zeros((96, 40), np.float32)
    padded[:70] = w
    codes, exps = kq.mxint_quantize(torch.from_numpy(padded), 3)
    assert q.orig_rows == 70
    assert torch.equal(q.codes, codes) and torch.equal(q.exponents, exps)


def test_wrapper_refuses_unpadded_rows():
    with pytest.raises(ValueError, match="pad"):
        kq.mxint_quantize(torch.zeros((40, 8)), 3)
