"""Port parity: the dense decoder — converted from JAX SRR-quantized
params — gives the JAX package's prefill and decode logits.

Both packages run f32 compute on the CPU: JAX ``fused="on"`` runs the
Pallas kernels in interpret mode and ``"auto"`` its XLA lowerings; the
port runs its kernels' plain versions for both. Tolerance: 1e-4 on
logits of magnitude ~3 with an f32 or int8/int4 KV cache, whose values
agree to f32 noise unless a rounding flips; 2e-3 with bf16 KV, since the
two frameworks round K/V to bf16 separately and a 1-ulp f32 difference
at a bf16 rounding boundary moves a stored element by 2^-8 relative.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core.api import PTQConfig as JPTQConfig
from repro.models import Ctx as JCtx
from repro.models import decode_step as jdecode_step
from repro.models import init_cache as jinit_cache
from repro.models import init_lm as jinit_lm
from repro.models import prefill as jprefill
from repro.models.quantize import quantize_model_params as jquantize
from repro.quant.base import QuantizerConfig
from repro_torch.configs import get_config
from repro_torch.convert import convert_params
from repro_torch.models import Ctx, decode_step, init_cache, prefill

KV = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16),
      "int8": (jnp.int8, torch.int8), "int4": ("int4", "int4")}


def _configs(kv_heads):
    j = jget_config("phi3-mini-3.8b").reduced()
    t = get_config("phi3-mini-3.8b").reduced()
    if kv_heads != j.n_kv_heads:
        j = dataclasses.replace(j, n_kv_heads=kv_heads)
        t = dataclasses.replace(t, n_kv_heads=kv_heads)
    return j, t


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    """Many small ops: two intra-op threads, as in
    ``tests/test_torch_train.py``; restored after the module."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module", params=[4, 2], ids=["mha", "gqa2"])
def models(request):
    jcfg, tcfg = _configs(request.param)
    params = jinit_lm(jax.random.PRNGKey(1), jcfg)
    ptq = JPTQConfig(method="srr", rank=8, seed=0, exact_svd=True, forced_k=3,
                     quantizer=QuantizerConfig(kind="mxint", bits=3,
                                               block_size=32))
    qparams, _ = jquantize(params, None, ptq)
    tree = jax.tree_util.tree_map(np.asarray, qparams)
    return jcfg, qparams, convert_params(tree, tcfg, device="cpu")


@pytest.mark.parametrize("fused", ["on", "auto"])
@pytest.mark.parametrize("kv", ["f32", "bf16", "int8", "int4"])
def test_prefill_and_decode_logits_match_jax(models, fused, kv):
    jcfg, qparams, model = models
    jdt, tdt = KV[kv]
    tol = 2e-3 if kv == "bf16" else 1e-4
    rng = np.random.default_rng(3)
    toks = rng.integers(0, jcfg.vocab, (2, 16)).astype(np.int32)
    lengths = np.array([16, 9], np.int32)
    jctx = JCtx(fused=fused)
    jctx.use_pallas = fused == "on"
    jpre = jax.jit(lambda p, t, c, n: jprefill(jctx, p, {"tokens": t}, jcfg,
                                               c, lengths=n))
    jdec = jax.jit(lambda p, t, c: jdecode_step(jctx, p, t, c, jcfg))
    jl, jc = jpre(qparams, jnp.asarray(toks),
                  jinit_cache(jcfg, 2, 24, dtype=jdt), jnp.asarray(lengths))
    ctx = Ctx(fused=fused)
    tl, tc = prefill(ctx, model, torch.from_numpy(toks).long(),
                     init_cache(model.cfg, 2, 24, tdt, "cpu"),
                     lengths=torch.from_numpy(lengths))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=tol)
    for _ in range(4):
        tok = np.argmax(np.asarray(jl)[:, -1], -1)[:, None].astype(np.int32)
        jl, jc = jdec(qparams, jnp.asarray(tok), jc)
        tl, tc = decode_step(ctx, model, torch.from_numpy(tok).long(), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=tol)
