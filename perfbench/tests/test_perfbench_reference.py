"""The plain reference agrees with the port's ``fused="off"`` path (its
dequantize-then-matmul baseline) at a tiny size on the CPU: a prompt
prefilled at the cell's padded width, then decoded a token at a time
through the bf16 KV cache, dense and MoE (the MoE's prefill dispatch at
the configuration's capacity factor, which drops nothing)."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from perfbench import registry
from perfbench.reference import decoder as ref
from perfbench.tests import tiny
from repro_torch.models.linear import Ctx
from repro_torch.models.transformer import decode_step, init_cache, prefill


@pytest.mark.parametrize("cell,plen", [("phi3-chat-batch", 70),
                                       ("dsmoe-chat-batch", 96)])
def test_reference_matches_fused_off(tmp_path, cell, plen):
    bj = tiny.setup(tmp_path)
    b = registry.resolve(cell, 2**31 + 41, 1.0, False, torch.device("cpu"),
                         bj, tmp_path)
    cfg, eng = b.config, b.traffic["engine"]
    fam = registry.family(cfg)
    raw = fam.draw(cfg, b.seed, "cpu")
    model = fam.build(raw, cfg)
    prompt = np.random.default_rng(1).integers(0, cfg["model"]["vocab"], plen)
    width = eng["prefill_len"]
    ctx = Ctx(fused="off")
    cache = init_cache(model.cfg, 1, eng["max_len"], torch.bfloat16, "cpu")
    toks = torch.zeros((1, width), dtype=torch.int64)
    toks[0, :plen] = torch.as_tensor(prompt)
    lg, cache = prefill(ctx, model, toks, cache,
                        lengths=torch.tensor([plen], dtype=torch.int32))
    outs, served = [], []
    for _ in range(24):
        lsm = torch.log_softmax(lg[0, -1].float(), -1)
        outs.append(lsm)
        served.append(int(lsm.argmax()))
        lg, cache = decode_step(ctx, model, torch.tensor([[served[-1]]]),
                                cache)
    port = torch.stack(outs)
    v = cfg["model"]["vocab"]
    got = ref.score(raw, cfg, [(prompt, np.asarray(served))], chunk=width,
                    ids=[torch.arange(v).expand(len(served), v)])[0]
    err = (got["at_ids"] - port).abs()
    assert float(err.max()) < 5e-3         # a K/V element's bf16 rounding
    assert float(err.median()) < 1e-4      # may fall on the other side
    assert bool((got["at_ids"].argmax(-1) == torch.as_tensor(served)).all())
