"""The correctness check fails a run whose timed path is broken: a run of
a tiny cell on the CPU, the look for a card skipped, with the port
broken underneath. Of the faults a cell can have, a serving cell can
have two: a token altered where it is produced (every token, or only the
first, which the admission prefill produces), and a decode step that
leaves its state (the KV cache) unchanged; the pass cell two: codes
altered where K7 produces them, and an SRR that leaves the residual
unreconstructed. A batch split over half the lanes and a missing
exchange between chips are training's and four chips' faults; no cell
here has them."""
from __future__ import annotations

import time

import pytest
import torch

from perfbench import bench
from perfbench.tests import tiny
from repro_torch.core import srr
from repro_torch.models import attention
from repro_torch.quant import mxint
from repro_torch.serve.engine import Engine


def _run(tmp_path, cell):
    bj = tiny.setup(tmp_path)
    return bench.execute(bj, cell, 2**31 + 21, tiny.SECONDS, False,
                         torch.device("cpu"), time.perf_counter(), tmp_path)


def _failed(line, name):
    assert line["correct"] is False
    assert line["checks"][name]["value"] > line["checks"][name]["limit"]


@pytest.mark.parametrize("cell", ["phi3-chat-batch", "phi3-longprompt-open"])
def test_an_altered_token_fails(tmp_path, monkeypatch, cell):
    sample = Engine._sample

    def altered(logits, lanes, want_lp):
        tok, lp = sample(logits, lanes, want_lp)
        return (tok + 1) % logits.shape[-1], lp

    monkeypatch.setattr(Engine, "_sample", staticmethod(altered))
    _failed(_run(tmp_path, cell), "logprob_err_p99")


@pytest.mark.parametrize("cell", ["phi3-chat-batch", "dsmoe-chat-batch",
                                  "phi3-longprompt-open"])
def test_an_altered_first_token_fails(tmp_path, monkeypatch, cell):
    """Only the token each admission's prefill produces is altered; the
    decode steps after it are sound."""
    read_first = Engine._read_first
    vocab = tiny.DENSE["vocab"]

    def altered(tok, lpd):
        first, lp = read_first(tok, lpd)
        return (first + 1) % vocab, lp

    monkeypatch.setattr(Engine, "_read_first", staticmethod(altered))
    _failed(_run(tmp_path, cell), "first_logprob_err_max")


@pytest.mark.parametrize("cell", ["phi3-chat-batch", "dsmoe-chat-batch"])
def test_a_step_that_keeps_its_state_fails(tmp_path, monkeypatch, cell):
    step = attention.attention_step

    def unchanged(ctx, p, x, cache, cfg, local=False):
        saved = {k: v.clone() for k, v in cache.items()}
        y, _ = step(ctx, p, x, cache, cfg, local)
        for k, v in saved.items():
            cache[k].copy_(v)
        return y, cache

    monkeypatch.setattr(attention, "attention_step", unchanged)
    _failed(_run(tmp_path, cell), "logprob_err_p99")


def test_altered_codes_fail(tmp_path, monkeypatch):
    quantize = mxint.MXIntQuantizer.quantize

    def altered(self, w):
        p = quantize(self, w)
        return p._replace(codes=torch.where(p.codes > -4, p.codes - 1,
                                            p.codes))

    monkeypatch.setattr(mxint.MXIntQuantizer, "quantize", altered)
    _failed(_run(tmp_path, "phi3-srr-pass"), "code_mismatch_pct")


def test_an_unreconstructed_residual_fails(tmp_path, monkeypatch):
    factors = srr._svd_factors
    calls = []

    def first_only(a, rank, gen, exact):
        calls.append(rank)
        l, r = factors(a, rank, gen, exact)
        return (l, r) if len(calls) % 2 else (l * 0, r * 0)

    monkeypatch.setattr(srr, "_svd_factors", first_only)
    _failed(_run(tmp_path, "phi3-srr-pass"), "lr_rel_err")
