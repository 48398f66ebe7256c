"""PTQ → serve: quantize a whole model with SRR and serve it continuously
(port of ``examples/ptq_serve.py``).

    python -m repro_torch.examples.ptq_serve [--arch minitron-4b]
        [--full] [--layers N] [--device cpu]

The paper's deployment scenario: calibrate on a handful of batches,
decompose every projection into Q + LR (per-matrix k*), then serve
requests through the continuous-batching engine — int8 KV cache on,
requests streamed in via ``submit()``/``step()`` so late arrivals join
mid-flight — and compare against the w-only and QER baselines.

A fourth act serves the production traffic shape: many requests sharing
one system prompt through the **paged** engine (``--arch`` permitting —
paged needs a pure-attention stack, so this act runs on phi3-mini
otherwise), where the radix-tree prefix cache maps the shared blocks
into each new request's block table and the printed prefix-hit rate
shows how much prefill the cache deleted. It runs with telemetry on, so
it also prints the step-phase p50 breakdown (budget / admission /
prefill / decode / transfer) from the engine's metrics registry, and
under the token-budget step scheduler (``max_step_tokens``).

The last act turns on **self-speculative decoding**: the quantized base
Q alone drafts tokens (the low-rank sliver skipped) and the full Q + LR
model verifies k at a time in one chunked dispatch; it prints the
acceptance rate and tok/s next to the plain per-token engine.

The model is the arch's ``.reduced()`` config, or its published widths
with ``--full``; ``--layers N`` keeps its first N layers. Every act is a
function of this module, called by :func:`main` in order.
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core.api import PTQConfig
from repro_torch.data import capture_calibration, data_config_for, host_batch
from repro_torch.device import resolve_device
from repro_torch.models import Ctx, init_lm, lm_loss
from repro_torch.models.quantize import quantize_model_params
from repro_torch.quant import QuantizerConfig
from repro_torch.serve import Engine, Request, SamplingParams, ServeConfig

METHODS = ("w-only", "qer", "srr")


def model_config(arch: str, full: bool, layers: Optional[int]) -> ModelConfig:
    cfg = get_config(arch)
    if not full:
        cfg = cfg.reduced()
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    return cfg


def pagable(cfg: ModelConfig) -> bool:
    """Whether the paged engine serves ``cfg``: a pure attention stack."""
    return set(cfg.block_pattern) == {"attn"} and cfg.attn_kind != "mla" \
        and not cfg.is_encoder_decoder and not cfg.n_vision_tokens


def act_quantize(model, cfg: ModelConfig, dev, rank: int) -> tuple:
    """[1/5] calibrate, [2/5] quantize by each method; returns the SRR
    model and each method's eval loss, mean k* and seconds."""
    dcfg = data_config_for(cfg, seq_len=32, global_batch=4)
    print("[1/5] calibrating …")
    stats = capture_calibration(model, dcfg, lm_loss, n_batches=2,
                                device=dev)

    print("[2/5] quantizing (3-bit MXINT + SRR rank allocation) …")
    out, srr = {}, None
    for method in METHODS:
        ptq = PTQConfig(method=method,
                        scaling="identity" if method == "w-only"
                        else "qera-exact",
                        rank=rank, quantizer=QuantizerConfig("mxint", 3, 32))
        t0 = time.perf_counter()
        qp, reports = quantize_model_params(copy.deepcopy(model), ptq,
                                            stats=dict(stats), device=dev)
        dt = time.perf_counter() - t0
        with torch.no_grad():
            loss = float(lm_loss(Ctx(), qp, host_batch(dcfg, 999,
                                                       device=dev)))
        kbar = sum(r.k_star for r in reports) / max(len(reports), 1)
        out[method] = dict(loss=loss, mean_k=kbar, seconds=dt)
        if method == "srr":
            srr = qp
        print(f"   {method:7s}: eval loss {loss:.4f}  mean k*={kbar:4.1f}  "
              f"({dt:.1f}s)")
    return srr, out


def act_continuous(model, cfg: ModelConfig, dev,
                   rng: np.random.Generator) -> dict:
    """[3/5] 4 requests up front and 4 more mid-decode, greedy lanes
    beside temperature/top-p ones, int8 KV."""
    print("[3/5] serving the SRR model (continuous batching, int8 KV) …")
    eng = Engine(model, cfg,
                 ServeConfig(max_len=96, decode_batch=4, max_new_tokens=12,
                             kv_dtype="int8", scheduler="continuous",
                             prefill_len=16 + (cfg.n_vision_tokens or 0)),
                 device=dev)
    reqs = [Request(uid=i, prompt=rng.integers(
        0, cfg.vocab, size=int(rng.integers(6, 14))).astype(np.int32),
        params=SamplingParams(
            max_new_tokens=int(rng.integers(6, 13)),
            temperature=0.0 if i % 2 == 0 else 0.8,
            top_p=1.0 if i % 2 == 0 else 0.9,
            seed=i)) for i in range(8)]
    out = []
    for r in reqs[:4]:
        eng.submit(r)
    for _ in range(4):                       # a few steps before the rest
        out.extend(eng.step())
    for r in reqs[4:]:                       # late arrivals join mid-flight
        eng.submit(r)
    out.extend(eng.drain())
    out.sort(key=lambda r: r.uid)
    for r in out[:3]:
        kind = "greedy" if r.uid % 2 == 0 else "sampled"
        print(f"   req {r.uid} ({kind}, {r.finish_reason}): "
              f"{r.tokens.tolist()}")
    toks = sum(len(r.tokens) for r in out)
    st = eng.stats()
    print(f"   {len(out)} requests, {toks} new tokens, "
          f"lane occupancy {st['occupancy']:.2f}")
    return dict(submitted=len(reqs), finished=len(out), tokens=toks,
                finish_reasons=[r.finish_reason for r in out],
                occupancy=st["occupancy"])


def act_paged(model, cfg: ModelConfig, dev, rng: np.random.Generator
              ) -> dict:
    """[4/5] 10 requests sharing a 24-token system prompt through the
    paged engine with prefix reuse and a step budget."""
    print("[4/5] paged serving: one system prompt, many users "
          "(prefix-cache reuse) …")
    # max_step_tokens arms the token-budget step scheduler: per step,
    # chunked-prefill dispatches + decode lanes stay under the cap, so
    # the burst of 10 admissions cannot stall lanes already decoding
    eng = Engine(model, cfg, ServeConfig(
        max_len=96, decode_batch=4, max_new_tokens=8, kv_dtype="int8",
        prefill_len=16, paged=True, page_size=8, telemetry=True,
        max_step_tokens=16 + 4), device=dev)
    system_prompt = rng.integers(0, cfg.vocab, size=24).astype(np.int32)
    reqs = [Request(
        uid=i, prompt=np.concatenate(
            [system_prompt,
             rng.integers(0, cfg.vocab, size=6).astype(np.int32)]),
        max_new_tokens=8) for i in range(10)]
    res = eng.generate(reqs)
    st = eng.stats()
    print(f"   {len(res)} requests over a shared 24-token system prompt: "
          f"prefix hit rate {st['prefix_hit_rate']:.2f}, "
          f"{st['prefill_tokens_computed']}/{st['prompt_tokens_total']} "
          f"prompt tokens computed, {st['prefill_chunks']} chunks, "
          f"{st['evictions']} evictions, "
          f"{st['budget_deferred_admissions']:.0f} admissions deferred "
          f"by the step budget")
    phases = " ".join(
        f"{ph} {st[f'step_{ph}_seconds']['p50'] * 1e3:.2f}ms"
        for ph in ("budget", "admission", "prefill", "decode", "transfer"))
    print(f"   step-phase p50: {phases}  "
          f"(ttft p50 {st['ttft_seconds']['p50'] * 1e3:.0f}ms, "
          f"{st['compiled_shapes_decode']} decode shape(s) compiled)")
    return dict(submitted=len(reqs), finished=len(res),
                prefix_hit_rate=st["prefix_hit_rate"],
                prefill_tokens_computed=st["prefill_tokens_computed"],
                prompt_tokens_total=st["prompt_tokens_total"])


def act_speculative(model, cfg: ModelConfig, dev,
                    rng: np.random.Generator) -> dict:
    """[5/5] 4 greedy requests of 24 tokens on one lane, plain and
    self-speculative (k = 6): the tokens must be identical."""
    print("[5/5] self-speculative decoding: Q-only draft, Q+LR verify …")
    prompts = [rng.integers(0, cfg.vocab, size=8 + i % 4).astype(np.int32)
               for i in range(4)]
    lanes = {}
    for label, spec in (("plain", False), ("speculative", True)):
        eng = Engine(model, cfg, ServeConfig(
            max_len=96, decode_batch=1, max_new_tokens=24,
            kv_dtype="int8", prefill_len=16, paged=True, page_size=8,
            speculative=spec, spec_k=6), device=dev)
        eng.warmup()
        t0 = time.perf_counter()
        res = eng.generate([Request(uid=i, prompt=pr.copy(),
                                    max_new_tokens=24)
                            for i, pr in enumerate(prompts)])
        wall = time.perf_counter() - t0
        lanes[label] = (sum(len(r.tokens) for r in res) / wall,
                        eng.stats(), sorted(res, key=lambda r: r.uid))
    tps_p, _, res_p = lanes["plain"]
    tps_s, st, res_s = lanes["speculative"]
    for a, b in zip(res_p, res_s):
        assert np.array_equal(a.tokens, b.tokens), \
            "speculation must not change greedy output"
    print(f"   plain {tps_p:6.1f} tok/s | speculative {tps_s:6.1f} tok/s "
          f"({tps_s / tps_p:.2f}x) — {st['spec_rounds']} rounds, "
          f"acceptance rate {st['spec_acceptance_rate']:.3f} "
          f"({st['spec_accepted_tokens']}/{st['spec_draft_tokens']} "
          f"drafts), tokens identical")
    print("   (the SRR draft skips the LR correction, so acceptance — "
          "and the payoff — tracks how well Q alone matches Q+LR)")
    return dict(requests=len(res_s), identical=True, plain_tok_s=tps_p,
                spec_tok_s=tps_s, rounds=st["spec_rounds"],
                acceptance_rate=st["spec_acceptance_rate"])


def main(argv: Optional[List[str]] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--arch", default="minitron-4b", choices=sorted(ARCHS))
    p.add_argument("--rank", type=int, default=16)
    p.add_argument("--full", action="store_true",
                   help="published widths instead of .reduced()")
    p.add_argument("--layers", type=int, default=None,
                   help="keep the first N layers (a depth cut)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = model_config(args.arch, args.full, args.layers)
    fp = init_lm(cfg, 0, device=dev)
    model, quant = act_quantize(fp, cfg, dev, args.rank)
    del fp
    rng = np.random.default_rng(0)
    cont = act_continuous(model, cfg, dev, rng)

    # paged needs a pure-attention stack; run the last two acts on
    # phi3-mini (the fp model, cut as the flags say) if the arch isn't
    pcfg, pmodel = cfg, model
    if not pagable(cfg):
        pcfg = model_config("phi3-mini-3.8b", args.full, args.layers)
        pmodel = init_lm(pcfg, 0, device=dev)
        print(f"   ({args.arch} has non-attention mixers; paged act runs "
              f"on phi3-mini-3.8b instead)")
    paged = act_paged(pmodel, pcfg, dev, rng)
    spec = act_speculative(pmodel, pcfg, dev, rng)
    return {"arch": cfg.name, "paged_arch": pcfg.name,
            "methods": quant, "continuous": cont, "paged": paged,
            "speculative": spec}


if __name__ == "__main__":
    main()
