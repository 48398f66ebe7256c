"""Port parity: the SRR pass (identity scaling) against ``repro.core``
and ``repro.models.quantize``.

With exact SVDs and a forced split the decomposition is deterministic,
so ``q + l @ r`` agrees to f32 noise (tolerance 1e-5 · max|w|: SVD and
subtraction round-off, well below one MXINT code step of 2^-2·max|w|);
at k = 0 the backbone is plain MXINT of W and its codes are bit-exact.
The randomized sketches draw from different generators in the two
packages, so the model-level test compares structure only.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core.api import PTQConfig as JPTQConfig
from repro.core.rank_alloc import rho_prefix as jrho_prefix
from repro.core.scaling import identity_scaling
from repro.core.srr import srr_decompose as jsrr
from repro.models import init_lm as jinit_lm
from repro.models.quantize import quantize_model_params as jquantize
from repro.quant import MXIntQuantizer as JMX
from repro.quant.base import QuantizerConfig
from repro_torch.configs import get_config
from repro_torch.convert import convert_params
from repro_torch.core.api import PTQConfig
from repro_torch.core.rank_alloc import rho_prefix
from repro_torch.core.srr import srr_decompose
from repro_torch.models import init_lm
from repro_torch.models.quantize import quantize_model_params
from repro_torch.quant.mxint import MXIntQuantizer


def _planted(m=64, n=96, seed=0):
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((m, 6))
    v = rng.standard_normal((6, n))
    return (u @ v * 0.2 + rng.standard_normal((m, n)) * 0.02).astype(np.float32)


@pytest.mark.parametrize("k", [0, 3, 8])
def test_srr_forced_k_exact_matches_jax(k):
    w = _planted(seed=k)
    jd = jsrr(jnp.asarray(w), identity_scaling(), JMX(bits=3), 8,
              jax.random.PRNGKey(0), k=k, exact=True).decomposition
    td = srr_decompose(torch.from_numpy(w), MXIntQuantizer(bits=3), 8, None,
                       k=k, exact=True)
    assert td.k == jd.k == k and td.l.shape == jd.l.shape
    np.testing.assert_allclose(td.reconstruct().numpy(),
                               np.asarray(jd.reconstruct()), rtol=0,
                               atol=1e-5 * float(np.abs(w).max()))
    if k == 0:
        jc = JMX(bits=3).quantize(jd.q)
        tc = MXIntQuantizer(bits=3).quantize(td.q)
        assert np.array_equal(tc.codes.numpy(), np.asarray(jc.codes))
        assert np.array_equal(tc.exponents.numpy(), np.asarray(jc.exponents))


def test_rho_prefix_matches_jax():
    sv = np.sort(np.random.default_rng(1).random(12).astype(np.float32))[::-1]
    frob = np.float32((sv ** 2).sum() * 1.3)
    for r in (0, 5, 12):
        want = np.asarray(jrho_prefix(jnp.asarray(sv.copy()), jnp.asarray(frob), r))
        got = rho_prefix(torch.from_numpy(sv.copy()), torch.tensor(frob), r)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("container", ["int8", "packed4"])
def test_quantize_model_params_tree_matches_jax(container):
    jcfg = jget_config("phi3-mini-3.8b").reduced()
    ptq = JPTQConfig(method="srr", rank=8, exact_svd=True, forced_k=3,
                     quantizer=QuantizerConfig(kind="mxint", bits=3,
                                               block_size=32))
    jq, _ = jquantize(jinit_lm(jax.random.PRNGKey(0), jcfg), None, ptq,
                      container=container)
    want = convert_params(jax.tree_util.tree_map(np.asarray, jq),
                          get_config("phi3-mini-3.8b").reduced(),
                          device="cpu").state_dict()
    model, reports = quantize_model_params(
        init_lm(get_config("phi3-mini-3.8b").reduced(), 0, device="cpu"),
        PTQConfig(rank=8), container=container, device="cpu")
    got = model.state_dict()
    assert len(reports) == 7 * jcfg.n_layers
    assert sorted(got) == sorted(want)
    for key in want:
        assert (got[key].shape, got[key].dtype) == (want[key].shape,
                                                    want[key].dtype), key
