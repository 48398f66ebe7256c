"""The traffic generators: the same work for every seed, lengths from
their strata, and inputs that repeat for a seed and differ across seeds."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from perfbench import registry, serving
from perfbench.generators import closed_backlog, open_poisson
from perfbench.tests import tiny


def test_lognormal_strata():
    xs = serving.lognormal_strata(384, 0.6, 64, 1024, 16)
    assert len(xs) == 16 and xs == sorted(xs)
    assert 64 <= xs[0] and xs[-1] <= 1024
    assert xs[7] <= 384 <= xs[8]
    assert serving.uniform_strata(16, 64, 4) == [22, 34, 46, 58]


def test_closed_sizes_are_one_mix_in_blocks():
    tr = registry.traffic_file("chat-batch")
    it = closed_backlog._sizes(tr)
    first = [next(it) for _ in range(2 * tr["strata"])]
    n = tr["strata"]
    for block in (first[:n], first[n:]):
        assert sorted(p for p, _ in block) == serving.lengths(tr["prompt"], n)
        assert sorted(o for _, o in block) == serving.lengths(tr["output"], n)
    assert first[:n] != first[n:]
    again = closed_backlog._sizes(tr)
    assert [next(again) for _ in range(2 * n)] == first


def test_open_schedule_offers_the_rate():
    tr = dict(tiny.OPEN, rate=2.4,
              prompt=dict(median=1024, sigma=0.4, min=512, max=2048),
              output=dict(min=16, max=64))
    plan = open_poisson.schedule(tr, 51.0)
    assert plan == open_poisson.schedule(tr, 51.0)
    offs = [t for t, _, _ in plan]
    assert offs == sorted(offs) and offs[-1] < 51.0
    assert abs(len(plan) / 51.0 - tr["rate"]) < 0.1 * tr["rate"]
    assert all(tr["prompt"]["min"] <= p <= tr["prompt"]["max"]
               and tr["output"]["min"] <= o <= tr["output"]["max"]
               for _, p, o in plan)


@pytest.mark.parametrize("cell", ["phi3-chat-batch", "dsmoe-chat-batch"])
def test_weights_and_prompts_follow_the_seed(tmp_path, cell):
    bj = tiny.setup(tmp_path)
    cpu = torch.device("cpu")

    def draw(seed):
        b = registry.resolve(cell, seed, 1.0, False, cpu, bj, tmp_path)
        raw = registry.family(b.config).draw(b.config, seed, cpu)
        rng = np.random.default_rng(seed)
        return raw, rng.integers(0, b.config["model"]["vocab"], 16)

    (a, pa), (b, pb), (c, pc) = draw(2**31 + 5), draw(2**31 + 5), draw(7)
    for name in a["mats"]:
        assert torch.equal(a["mats"][name].codes, b["mats"][name].codes)
        assert torch.equal(a["mats"][name].l, b["mats"][name].l)
    assert (pa == pb).all() and not (pa == pc).all()
    assert not torch.equal(a["embed"], c["embed"])
    m = a["mats"]["L0.wq"]
    assert m.codes.dtype == torch.int8 and m.codes.min() >= -4 \
        and m.codes.max() <= 3
    assert torch.equal(torch.exp2(torch.log2(m.scale).round()), m.scale)
