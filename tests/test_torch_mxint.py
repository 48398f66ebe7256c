"""Port parity: MXINT quantization and the packed4 container are
bit-exact against ``repro.quant.mxint``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.quant import mxint as jmx
from repro_torch.quant import mxint as tmx


def test_unpack_all_256_bytes_bit_exact():
    packed = np.arange(256, dtype=np.uint8).reshape(1, 256)
    want = np.asarray(jmx.unpack_codes_4bit(jnp.asarray(packed)))
    got = tmx.unpack_codes_4bit(torch.from_numpy(packed)).numpy()
    assert got.dtype == np.int8 and np.array_equal(got, want)


def test_pack_roundtrip_all_code_pairs_bit_exact():
    lo, hi = np.meshgrid(np.arange(-8, 8), np.arange(-8, 8), indexing="ij")
    codes = np.stack([lo.ravel(), hi.ravel()]).astype(np.int8)   # (2, 256)
    codes = np.concatenate([codes, codes[::-1]])                  # (4, 256)
    want = np.asarray(jmx.pack_codes_4bit(jnp.asarray(codes)))
    got = tmx.pack_codes_4bit(torch.from_numpy(codes))
    assert got.dtype == torch.uint8 and np.array_equal(got.numpy(), want)
    assert np.array_equal(tmx.unpack_codes_4bit(got).numpy(), codes)


@pytest.mark.parametrize("bits", [3, 4, 8])
@pytest.mark.parametrize("m", [64, 70])          # 70: MXINT padding rows
def test_quantize_codes_and_exponents_bit_exact(bits, m):
    rng = np.random.default_rng(bits * 100 + m)
    w = (rng.standard_normal((m, 48)) * 0.05).astype(np.float32)
    w[:32, :5] = 0.0                              # all-zero blocks
    w[32:, 7] *= 1e4                              # a wide-range column
    jq = jmx.MXIntQuantizer(bits=bits).quantize(jnp.asarray(w))
    tq = tmx.MXIntQuantizer(bits=bits).quantize(torch.from_numpy(w))
    assert tq.codes.shape == (-(-m // 32) * 32, 48) and tq.orig_rows == m
    assert np.array_equal(tq.codes.numpy(), np.asarray(jq.codes))
    assert np.array_equal(tq.exponents.numpy(), np.asarray(jq.exponents))
    assert np.array_equal(
        tmx.MXIntQuantizer(bits=bits).fake_quant(torch.from_numpy(w)).numpy(),
        np.asarray(jmx.MXIntQuantizer(bits=bits).fake_quant(jnp.asarray(w))))


def test_quantize_exponent_exact_at_powers_of_two():
    """amax / qmax = 2^k gives exponent k exactly (the reference's
    XLA:CPU log2 overshoots at some of these, see ROADMAP §3)."""
    k = np.arange(-120, 121, dtype=np.float32)
    w = np.zeros((32, k.size), np.float32)
    w[5] = 3.0 * np.exp2(k)                      # bits=3: qmax = 3
    q = tmx.MXIntQuantizer(bits=3).quantize(torch.from_numpy(w))
    assert np.array_equal(q.exponents.numpy()[0], k.astype(np.int8))
    assert np.all(q.codes.numpy()[5] == 3)
