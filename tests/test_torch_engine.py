"""Port parity: greedy tokens from the port's continuous engine on the
CPU are identical to JAX ``Engine.generate`` on the same JAX-SRR-
quantized, converted params — more requests than lanes, mixed prompt
lengths and budgets, including ``max_new_tokens=0``."""
import jax
import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.core.api import PTQConfig as JPTQConfig
from repro.models import init_lm as jinit_lm
from repro.models.quantize import quantize_model_params as jquantize
from repro.quant.base import QuantizerConfig
from repro.serve import Engine as JEngine
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro_torch.configs import get_config
from repro_torch.convert import convert_params
from repro_torch.serve import Engine, Request, SamplingParams, ServeConfig

BUDGETS = [6, 0, 3, 8, 5, 2, 7]


@pytest.fixture(scope="module")
def quantized():
    jcfg = jget_config("phi3-mini-3.8b").reduced()
    ptq = JPTQConfig(method="srr", rank=8, exact_svd=True, forced_k=3,
                     quantizer=QuantizerConfig(kind="mxint", bits=3,
                                               block_size=32))
    qparams, _ = jquantize(jinit_lm(jax.random.PRNGKey(2), jcfg), None, ptq)
    model = convert_params(jax.tree_util.tree_map(np.asarray, qparams),
                           get_config("phi3-mini-3.8b").reduced(), device="cpu")
    return jcfg, qparams, model


def _prompts(vocab):
    rng = np.random.default_rng(5)
    return [rng.integers(0, vocab, size=4 + (3 * i) % 9).astype(np.int32)
            for i in range(len(BUDGETS))]


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_engine_greedy_tokens_identical_to_jax(quantized, kv):
    jcfg, qparams, model = quantized
    prompts = _prompts(jcfg.vocab)
    common = dict(max_len=32, decode_batch=3, prefill_len=16, kv_dtype=kv)
    want = JEngine(qparams, jcfg, JServeConfig(**common)).generate(
        [JRequest(uid=i, prompt=p, max_new_tokens=b)
         for i, (p, b) in enumerate(zip(prompts, BUDGETS))])
    eng = Engine(model, model.cfg, ServeConfig(**common), device="cpu")
    got = eng.generate([Request(uid=i, prompt=p, max_new_tokens=b)
                        for i, (p, b) in enumerate(zip(prompts, BUDGETS))])
    assert [r.uid for r in got] == [r.uid for r in want]
    for g, w in zip(got, want):
        assert g.tokens.tolist() == w.tokens.tolist(), g.uid
        assert g.finish_reason == w.finish_reason
    assert len(got[1].tokens) == 0 and got[1].ttft_s is None
    st = eng.stats()
    assert st["admitted"] == st["retired"] == len(BUDGETS)


def test_engine_rejects_sampling_and_bad_requests(quantized):
    """Invalid sampling parameters raise JAX's validation errors, naming
    the request; a prompt past the prefill width raises as before."""
    _, _, model = quantized
    eng = Engine(model, model.cfg, ServeConfig(max_len=32, prefill_len=16),
                 device="cpu")
    for sp, msg in ((SamplingParams(temperature=-1.0), "temperature"),
                    (SamplingParams(top_p=0.0), "top_p"),
                    (SamplingParams(logprobs=6), "logprobs")):
        with pytest.raises(ValueError, match=f"request 0: {msg}"):
            eng.submit(Request(uid=0, prompt=np.ones(4, np.int32), params=sp))
    with pytest.raises(ValueError, match="prefill_len"):
        eng.submit(Request(uid=1, prompt=np.ones(20, np.int32)))
