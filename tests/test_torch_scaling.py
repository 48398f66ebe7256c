"""Port parity: the activation-aware scalings (``core/scaling.py``) and
the streaming calibration moments (``core/api.py`` ``CalibStats``).

The same numpy-seeded activations go through the JAX package and the
port on the CPU. Tolerances: Σ|x|, Σx² and the diagonal kinds are f32
reductions summed in another order — rtol 1e-6; Σxxᵀ the same over
rows — atol 1e-6 of its largest entry; qera-exact goes through an f32
eigendecomposition in each framework (XLA's and LAPACK's), whose
differences S⁻¹ scales up by 1/√λ over the small eigenvalues, so S and
S⁻¹ are held to 1e-4 of their largest entry (observed: S ≤ 1.1e-6,
S⁻¹ ≤ 2.2e-5).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.api import CalibStats as JCalibStats
from repro.core.scaling import autocorr_scaling_from_moments as jautocorr
from repro.core.scaling import make_scaling as jmake_scaling
from repro_torch.core.api import CalibStats
from repro_torch.core.scaling import (IDENTITY, SCALING_KINDS,
                                      autocorr_scaling_from_moments,
                                      make_scaling)

S_TOL = 1e-4


def _acts(n=300, m=48, seed=0):
    """Activations with uneven channel scales (an outlier channel, as
    LLM inputs have) and correlated channels."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, m)) @ (np.eye(m) + 0.3 * rng.standard_normal(
        (m, m)) / np.sqrt(m))
    x *= np.exp(rng.standard_normal(m) * 0.5)
    x[:, 3] *= 8.0
    return x.astype(np.float32)


def _close_scaling(got, want, tol):
    if want.dense is not None:
        for a, b in ((got.dense, want.dense), (got.dense_inv, want.dense_inv)):
            b = np.asarray(b)
            np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                       atol=tol * np.abs(b).max())
    elif want.diag is not None:
        np.testing.assert_allclose(got.diag.numpy(), np.asarray(want.diag),
                                   rtol=1e-6, atol=0)
    else:
        assert got.is_identity


@pytest.mark.parametrize("kind", SCALING_KINDS)
def test_make_scaling_matches_jax(kind):
    x = _acts()
    want = jmake_scaling(kind, jnp.asarray(x))
    got = make_scaling(kind, torch.from_numpy(x))
    assert got.is_identity == want.is_identity
    _close_scaling(got, want, S_TOL)
    w = np.random.default_rng(1).standard_normal((48, 20)).astype(np.float32)
    for fn in ("apply", "apply_inv"):
        a = getattr(got, fn)(torch.from_numpy(w)).numpy()
        b = np.asarray(getattr(want, fn)(jnp.asarray(w)))
        np.testing.assert_allclose(a, b, rtol=0, atol=S_TOL * np.abs(b).max())


@pytest.mark.parametrize("kind", SCALING_KINDS)
def test_calib_stats_update_and_scaling_match_jax(kind):
    """Three batches of different leading shapes, accumulated in both
    packages; the counts equal, the moments and each kind's S agree."""
    m = 48
    jst, st = JCalibStats.init(m), CalibStats.init(m)
    for i, shape in enumerate(((2, 40, m), (75, m), (3, 5, 7, m))):
        x = _acts(int(np.prod(shape[:-1])), m, seed=i).reshape(shape)
        jst = jst.update(jnp.asarray(x))
        assert st.update(torch.from_numpy(x)) is st
    assert st.count == float(jst.count) == 80 + 75 + 105
    for a, b in ((st.sum_abs, jst.sum_abs), (st.sum_sq, jst.sum_sq)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    ac = np.asarray(jst.autocorr)
    np.testing.assert_allclose(st.autocorr.numpy(), ac, rtol=0,
                               atol=1e-6 * np.abs(ac).max())
    _close_scaling(st.scaling(kind), jst.scaling(kind), S_TOL)


def test_autocorr_floor_matches_jax():
    """Fewer samples than channels: R is rank-deficient, the floor at
    1e-4·λ_max sets most eigenvalues, and S stays invertible."""
    x = _acts(n=20, m=48, seed=3)
    r = x.T @ x / x.shape[0]
    want = jautocorr(jnp.asarray(r))
    got = autocorr_scaling_from_moments(torch.from_numpy(r))
    _close_scaling(got, want, S_TOL)
    eye = (got.dense @ got.dense_inv).numpy()
    np.testing.assert_allclose(eye, np.eye(48), rtol=0, atol=1e-3)


def test_calib_stats_keeps_scalings_until_the_next_update():
    st = CalibStats.init(48)
    st.update(torch.from_numpy(_acts()))
    s = st.scaling("qera-exact")
    assert st.scaling("qera-exact") is s and st.scaling("identity") is IDENTITY
    st.update(torch.from_numpy(_acts(seed=5)))
    assert st.scaling("qera-exact") is not s


def test_calib_stats_rejects_what_it_cannot_build():
    st = CalibStats.init(8, need_autocorr=False)
    st.update(torch.ones((4, 8)))
    assert st.autocorr is None and st.scaling("lqer").diag is not None
    with pytest.raises(ValueError, match="autocorrelation"):
        st.scaling("qera-exact")
    with pytest.raises(ValueError, match="unknown scaling"):
        st.scaling("awq")
    with pytest.raises(ValueError, match="needs calibration"):
        make_scaling("lqer")
