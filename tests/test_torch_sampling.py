"""Port parity for per-request sampling (``repro_torch.serve.prng`` and
``repro_torch.serve.sampling``) against ``jax.random`` and
``repro.serve.sampling``:

* the threefry stream — ``PRNGKey``, ``fold_in``, random bits and
  uniforms — bit for bit, for seeds 0 … 2³¹−1, token indices up to 10⁶
  and rows of the reduced vocabulary (256) and phi3's (32,064);
* the Gumbel transform: each of its two f32 ``log``s within 1 ulp of
  XLA's on the same input, the composed value within 4 ulp of max(1, |g|);
* ``sample_tokens`` token-identical over greedy, temperature, top-k,
  top-p and mixed lanes, and the all-greedy batch decided on the host;
* ``SamplingParams.validate`` and ``lane_seed`` equal to JAX's;
* the three JAX flags the oracle rests on, so that it cannot change
  under the port without a test noticing.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serve import sampling as jsampling
from repro_torch.serve import prng, sampling

SEEDS = [0, 1, 12345, 2 ** 31 - 1]
INDICES = [0, 1, 999, 10 ** 6]
VOCABS = [256, 32064]


def test_jax_stream_flags():
    assert jax.config.jax_threefry_partitionable is True
    assert jax.config.jax_default_prng_impl == "threefry2x32"
    assert jax.config.jax_high_dynamic_range_gumbel is False


def _jax_keys(seeds, idxs):
    return [jax.random.fold_in(jax.random.PRNGKey(s), i)
            for s in seeds for i in idxs]


def _port_keys(seeds, idxs):
    s = torch.tensor([s for s in seeds for _ in idxs], dtype=torch.int32)
    i = torch.tensor([i for _ in seeds for i in idxs])
    return prng.fold_in(prng.prng_key(s), i)


def _bits32(x):
    return np.asarray(x, np.float32).view(np.int32).astype(np.int64)


def test_prng_key_and_fold_in_bit_exact():
    for s in SEEDS:
        want = np.asarray(jax.random.PRNGKey(s)).astype(np.int64)
        got = prng.prng_key(torch.tensor(s, dtype=torch.int32)).numpy()
        np.testing.assert_array_equal(got, want)
    want = np.stack([np.asarray(k) for k in _jax_keys(SEEDS, INDICES)])
    np.testing.assert_array_equal(_port_keys(SEEDS, INDICES).numpy(),
                                  want.astype(np.int64))


@pytest.mark.parametrize("vocab", VOCABS)
def test_bits_and_uniforms_bit_exact(vocab):
    keys = _port_keys(SEEDS, INDICES)                    # one row a key
    bits = prng.random_bits(keys, vocab).numpy()
    unif = prng.uniform(keys, vocab).numpy()
    for row, jk in enumerate(_jax_keys(SEEDS, INDICES)):
        np.testing.assert_array_equal(
            bits[row], np.asarray(jax.random.bits(jk, (vocab,), jnp.uint32))
            .astype(np.int64))
        np.testing.assert_array_equal(
            _bits32(unif[row]), _bits32(jax.random.uniform(jk, (vocab,))))


@pytest.mark.parametrize("vocab", VOCABS)
def test_gumbel_within_an_ulp_of_jax(vocab):
    keys = _port_keys(SEEDS, INDICES)
    u = prng.uniform(keys, vocab, prng.F32_TINY, 1.0)
    inner = torch.log(u)
    # each f32 log within 1 ulp of XLA's on the same input
    for x, got in ((u, inner), (-inner, torch.log(-inner))):
        want = np.asarray(jnp.log(jnp.asarray(x.numpy())))
        assert np.abs(_bits32(got.numpy()) - _bits32(want)).max() <= 1
    g = prng.gumbel(keys, vocab).numpy()
    jg = np.stack([np.asarray(jax.random.gumbel(k, (vocab,), mode="low"))
                   for k in _jax_keys(SEEDS, INDICES)])
    ulp = np.float32(2.0 ** -23)
    assert np.all(np.abs(g - jg) <= 4 * ulp * np.maximum(1.0, np.abs(jg)))


@pytest.mark.parametrize("vocab", VOCABS)
def test_categorical_matches_jax(vocab):
    rng = np.random.default_rng(vocab)
    logits = (rng.standard_normal((len(SEEDS) * len(INDICES), vocab)) * 2
              ).astype(np.float32)
    got = prng.categorical(_port_keys(SEEDS, INDICES),
                           torch.from_numpy(logits)).numpy()
    want = [int(jax.random.categorical(k, jnp.asarray(row)))
            for k, row in zip(_jax_keys(SEEDS, INDICES), logits)]
    assert got.tolist() == want


# lane mixes: (temperature, top_p, top_k) for 8 lanes
LANES = {
    "greedy": [(0.0, 1.0, 0)] * 8,
    "temperature": [(t, 1.0, 0) for t in (0.3, 0.7, 1.0, 1.5) * 2],
    "top_k": [(0.9, 1.0, k) for k in (1, 2, 5, 11, 40, 0, 3, 200)],
    "top_p": [(1.1, p, 0) for p in (0.1, 0.5, 0.8, 0.9, 0.95, 0.99, 1.0,
                                    0.3)],
    "mixed": [(0.0, 1.0, 0), (0.7, 0.9, 40), (1.0, 0.9, 0), (0.0, 0.5, 5),
              (1.3, 1.0, 11), (0.5, 0.8, 3), (0.0, 1.0, 0), (2.0, 0.95, 0)],
}


@pytest.mark.parametrize("vocab", VOCABS)
@pytest.mark.parametrize("lanes", sorted(LANES))
def test_sample_tokens_identical_to_jax(vocab, lanes):
    rng = np.random.default_rng(len(lanes) + vocab)
    temps, top_ps, top_ks = (np.array(c, dt) for c, dt in zip(
        zip(*LANES[lanes]), (np.float32, np.float32, np.int32)))
    seeds = rng.integers(0, 2 ** 31 - 1, 8).astype(np.int32)
    idxs = rng.integers(0, 10 ** 6, 8).astype(np.int32)
    jfn = jax.jit(jsampling.sample_tokens)
    for trial in range(3):
        logits = (rng.standard_normal((8, vocab)) * (1 + trial)
                  ).astype(np.float32)
        want = np.asarray(jfn(jnp.asarray(logits), jnp.asarray(temps),
                              jnp.asarray(top_ps), jnp.asarray(top_ks),
                              jnp.asarray(seeds), jnp.asarray(idxs)))
        got = sampling.sample_tokens(torch.from_numpy(logits), temps, top_ps,
                                     top_ks, seeds, idxs)
        assert got.dtype == torch.int64
        assert got.tolist() == want.tolist(), (lanes, trial)


def test_all_greedy_batch_is_decided_on_the_host(monkeypatch):
    """Every lane at temperature 0: the argmax, and the lane arrays never
    leave the host (no copy, so nothing waits for the device)."""
    def no_copy(*a):
        raise AssertionError("lanes copied for an all-greedy batch")

    monkeypatch.setattr(sampling, "lanes_to", no_copy)
    logits = torch.randn((4, 256), generator=torch.Generator().manual_seed(0))
    got = sampling.sample_tokens(logits, np.zeros(4, np.float32),
                                 np.full(4, 0.5, np.float32),
                                 np.full(4, 3, np.int32), np.arange(4),
                                 np.arange(4))
    assert got.tolist() == logits.argmax(-1).tolist()


PARAMS = [dict(), dict(temperature=-1.0), dict(temperature=0.0),
          dict(top_p=0.0), dict(top_p=1.5), dict(top_p=1.0), dict(top_k=-2),
          dict(max_new_tokens=-1), dict(max_new_tokens=0), dict(logprobs=6),
          dict(logprobs=-1), dict(logprobs=5), dict(logprobs=0)]


@pytest.mark.parametrize("kw", PARAMS, ids=str)
def test_validate_matches_jax(kw):
    def outcome(sp):
        try:
            sp.validate()
        except ValueError as e:
            return str(e)
        return None

    assert outcome(sampling.SamplingParams(**kw)) \
        == outcome(jsampling.SamplingParams(**kw))
    assert sampling.TOP_LOGPROBS == jsampling.TOP_LOGPROBS


def test_lane_seed_matches_jax():
    for seed in (None, 0, 7, 2 ** 31 - 1, 2 ** 31, -5, 2 ** 40 + 3):
        for base in (0, 9, 123456789):
            for uid in (0, 1, 17, 10 ** 6):
                assert sampling.lane_seed(seed, base, uid) \
                    == jsampling.lane_seed(seed, base, uid)
