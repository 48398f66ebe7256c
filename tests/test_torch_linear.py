"""Port parity: the Q + LR matmul dispatch (K1/K2's plain version on the
CPU) and ``linear`` against the JAX package.

Tolerance: f32 throughout; each output row depends on one input row, so
the bound is ``1e-5 · max_m ‖x_m‖`` — summation-order noise of a
K ≤ 160 dot product, far below one MXINT code step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.ref import mxint_lowrank_matmul_ref
from repro.models.linear import Ctx as JCtx, linear as jlinear
from repro.quant.mxint import MXIntQuantizer, pack_codes_4bit
from repro_torch.convert import _linear as convert_linear
from repro_torch.kernels.mxint_matmul import qlr_matmul
from repro_torch.models.linear import Ctx, fused_mode, linear


def _case(m, k, n, r, seed=0, kpad=None):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32)
    q = MXIntQuantizer(bits=3).quantize(jnp.asarray(w))
    codes = np.array(q.codes)
    scale = np.exp2(np.array(q.exponents, np.float32))
    l = (rng.standard_normal((k, r)) * 0.1).astype(np.float32)
    rr = (rng.standard_normal((r, n)) * 0.1).astype(np.float32)
    return x, codes, scale, l, rr


def _atol(x):
    return 1e-5 * float(np.linalg.norm(x.reshape(-1, x.shape[-1]), axis=-1).max())


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("m,r", [(8, 8), (8, 0), (160, 8), (160, 0)])
def test_qlr_matmul_matches_jax_kernels_and_ref(packed, m, r):
    x, codes, scale, l, rr = _case(m, 128, 96, r, seed=m + r)
    c = np.array(pack_codes_4bit(jnp.asarray(codes))) if packed else codes
    got = qlr_matmul(*(torch.from_numpy(a) for a in (x, c, scale, l, rr))).numpy()
    ref = np.asarray(mxint_lowrank_matmul_ref(*(jnp.asarray(a) for a in
                                                (x, codes, scale, l, rr))))
    np.testing.assert_allclose(got, ref, rtol=0, atol=_atol(x))
    for fuse in (True, False):
        jk = np.asarray(jops.mxint_lowrank_matmul(
            *(jnp.asarray(a) for a in (x, c, scale, l, rr)), fuse_sliver=fuse))
        np.testing.assert_allclose(got, jk, rtol=0, atol=_atol(x))


def _linear_params(schema, k=48, n=64, r=8, seed=3):
    """JAX linear params dict; k=48 leaves 16 MXINT padding rows."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((k, n)).astype(np.float32)
    b = rng.standard_normal((n,)).astype(np.float32)
    if schema == "fp":
        return {"w": w, "b": b}
    q = MXIntQuantizer(bits=3).quantize(jnp.asarray(w))
    p = {"scale": np.exp2(np.asarray(q.exponents, np.float32)),
         "l": (rng.standard_normal((k, r)) * 0.1).astype(np.float32),
         "r": (rng.standard_normal((r, n)) * 0.1).astype(np.float32),
         "gscale": np.ones((r,), np.float32), "b": b}
    if schema == "packed4":
        p["packed"] = np.asarray(pack_codes_4bit(q.codes))
    else:
        p["codes"] = np.asarray(q.codes)
    return p


@pytest.mark.parametrize("schema", ["fp", "quant", "packed4"])
@pytest.mark.parametrize("fused", ["auto", "on", "off"])
def test_linear_matches_jax(schema, fused):
    p = _linear_params(schema)
    x = np.random.default_rng(7).standard_normal((2, 5, 48)).astype(np.float32)
    want = np.asarray(jlinear(JCtx(fused=fused),
                                  jax.tree_util.tree_map(jnp.asarray, p),
                                  jnp.asarray(x)))
    layer = convert_linear(p, torch.device("cpu"))
    if schema != "fp":
        assert (layer.codes if layer.packed is None else layer.packed).shape[0] \
            * (2 if schema == "packed4" else 1) == 64      # padding kept
    got = linear(Ctx(fused=fused), layer, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=_atol(x))


def test_fused_mode_rejects_unknown():
    with pytest.raises(ValueError):
        fused_mode(Ctx(fused="maybe"))
