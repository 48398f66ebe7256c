import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import jax
import jax.numpy as jnp
import numpy as np
import pytest

jax.config.update("jax_enable_x64", False)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (the port's kernel tests); "
                   "skips without one")


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


def planted_lowrank(key, m, n, rank_sig=8, sig=6.0, noise=0.02):
    """Weight with dominant low-rank structure + dense noise — the regime
    the paper targets (Fig. 1: quantization corrupts dominant dirs)."""
    k1, k2, k3 = jax.random.split(key, 3)
    u = jax.random.normal(k1, (m, rank_sig))
    v = jax.random.normal(k2, (rank_sig, n))
    base = jax.random.normal(k3, (m, n)) * noise
    return base + (u @ v) * (sig / (m * n) ** 0.5)


@pytest.fixture(scope="session")
def calib_x():
    return jax.random.normal(jax.random.PRNGKey(7), (1024, 256))
