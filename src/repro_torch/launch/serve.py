"""Serving CLI: ``python -m repro_torch.launch.serve [--full] [...]``.

Init a model from a seed → calibrate it on synthetic batches → quantize
it under the qera-exact scaling (SRR by default; ``--method qer`` or
``w-only`` for the baselines) into the Q + LR container → serve requests
through the continuous-batching engine, as ``repro.launch.serve`` does,
on the card by default (``--device cuda``; ``--device cpu`` runs the
kernels' plain versions).
``--arch`` picks a registered architecture (``phi3-mini-3.8b``, dense,
or ``deepseek-moe-16b``, MoE); ``--full`` serves it at its published
size instead of its ``.reduced()`` smoke-test size. ``--paged`` serves from the paged KV
cache with prefix reuse and chunked prefill; ``--scheduler bucketed``
through the bucketed baseline. ``--temperature``/``--top-p``/``--top-k``
set every request's ``SamplingParams``; ``--spec-k K`` decodes greedy
lanes self-speculatively (a Q-only draft of K - 1 tokens, one Q + LR
verify chunk a lane).
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core.api import PTQConfig
from repro_torch.data import capture_calibration, data_config_for
from repro_torch.models.transformer import LM, init_lm, lm_loss
from repro_torch.models.quantize import quantize_model_params
from repro_torch.serve import Engine, Request, SamplingParams, ServeConfig


def build_quantized_model(args) -> tuple[LM, ModelConfig]:
    """Init the model per the model flags and, unless ``--method none``,
    run the paper's pipeline with the JAX CLI's defaults: calibrate on two
    synthetic batches of 4 × 32 tokens, then quantize under qera-exact;
    returns ``(model, cfg)``."""
    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    model = init_lm(cfg, args.seed, device=args.device)
    if args.method != "none":
        dcfg = data_config_for(cfg, seq_len=32, global_batch=4,
                               seed=args.seed)
        stats = capture_calibration(model, dcfg, lm_loss, n_batches=2,
                                    device=args.device)
        ptq = PTQConfig(method=args.method, scaling="qera-exact",
                        rank=args.rank, bits=args.bits, seed=args.seed)
        t0 = time.perf_counter()
        model, reports = quantize_model_params(model, ptq, stats=stats,
                                               device=args.device)
        print(f"[serve] {args.method} quantized {len(reports)} matrices in "
              f"{time.perf_counter() - t0:.1f}s")
    return model, cfg


def make_requests(cfg: ModelConfig, n: int, seed: int,
                  lengths: Optional[Sequence[int]] = None) -> List[Request]:
    """``n`` requests with random prompts; lengths default to the JAX
    CLI's ``8 + 4·(i % 3)``."""
    rng = np.random.default_rng(seed)
    if lengths is None:
        lengths = [8 + 4 * (i % 3) for i in range(n)]
    return [Request(uid=i, prompt=rng.integers(0, cfg.vocab, size=lengths[i])
                    .astype(np.int32)) for i in range(n)]


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--arch", default="phi3-mini-3.8b", choices=sorted(ARCHS))
    p.add_argument("--method", default="srr",
                   choices=["srr", "qer", "w-only", "none"])
    p.add_argument("--rank", type=int, default=16)
    p.add_argument("--bits", type=int, default=3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--kv", default="f32", choices=["f32", "bf16", "int8", "int4"])
    p.add_argument("--requests", type=int, default=8)
    p.add_argument("--new-tokens", type=int, default=16)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--scheduler", default="continuous",
                   choices=["continuous", "bucketed"])
    p.add_argument("--temperature", type=float, default=0.0,
                   help="per-request sampling temperature (0 = greedy); "
                        "applied through SamplingParams on every request")
    p.add_argument("--top-p", type=float, default=1.0,
                   help="nucleus sampling mass (1.0 = off)")
    p.add_argument("--top-k", type=int, default=0,
                   help="top-k logit filter (0 = off)")
    p.add_argument("--spec-k", type=int, default=0,
                   help="self-speculative decoding: draft up to K-1 tokens a "
                        "round through the Q-only base (the low-rank "
                        "correction skipped), verify them in one Q+LR chunk "
                        "a lane, rewind any rejected tail (0 = off; "
                        "continuous scheduler, greedy lanes only: sampled "
                        "lanes fall back to per-token decode)")
    p.add_argument("--prefill-len", type=int, default=32,
                   help="prompt pad width (with --paged: the chunk width)")
    p.add_argument("--paged", action="store_true",
                   help="paged KV cache: block-granular page pool + per-slot "
                        "block tables, radix-tree prefix reuse and chunked "
                        "prefill (prompts longer than --prefill-len stream "
                        "in chunks interleaved with decode)")
    p.add_argument("--page-size", type=int, default=16,
                   help="logical KV slots per page (even; paged only)")
    p.add_argument("--n-pages", type=int, default=None,
                   help="physical page-pool size (paged only; default: every "
                        "slot can hold a full row, plus prefix headroom)")
    p.add_argument("--no-prefix-cache", action="store_true",
                   help="disable radix-tree prefix reuse (paged only)")
    p.add_argument("--max-step-tokens", type=int, default=None,
                   help="token-budget step scheduler: per-step cap on "
                        "prefill dispatch width + decode lanes")
    p.add_argument("--fused", default="auto", choices=["auto", "on", "off"],
                   help="auto/on: the CUDA kernels on the card, their plain "
                        "versions on the CPU; off: dequantize-then-matmul "
                        "and dequantize-the-cache baselines")
    p.add_argument("--compute-dtype", default="f32", choices=["f32", "bf16"])
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--full", action="store_true",
                   help="published size instead of .reduced()")
    return p


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    model, cfg = build_quantized_model(args)
    max_len = max(128, args.prefill_len + args.new_tokens)
    eng = Engine(model, cfg, ServeConfig(
        max_len=max_len, decode_batch=args.batch,
        max_new_tokens=args.new_tokens, kv_dtype=args.kv,
        prefill_len=args.prefill_len, fused=args.fused,
        compute_dtype=args.compute_dtype, paged=args.paged,
        page_size=args.page_size, n_pages=args.n_pages,
        prefix_cache=not args.no_prefix_cache,
        max_step_tokens=args.max_step_tokens, scheduler=args.scheduler,
        temperature=args.temperature, seed=args.seed,
        speculative=args.spec_k > 0,
        spec_k=args.spec_k if args.spec_k > 0 else 4), device=args.device)
    reqs = make_requests(cfg, args.requests, args.seed)
    sp = SamplingParams(temperature=args.temperature, top_p=args.top_p,
                        top_k=args.top_k)
    for r in reqs:
        r.params = sp
    t0 = time.perf_counter()
    results = eng.generate(reqs)
    dt = time.perf_counter() - t0
    toks = sum(len(r.tokens) for r in results)
    print(f"[serve] {len(results)} requests, {toks} tokens in {dt:.2f}s "
          f"({toks / dt:.1f} tok/s, device={args.device}, "
          f"scheduler={args.scheduler})")
    st = eng.stats()
    if args.spec_k > 0:
        print(f"[serve] speculative: {st['spec_rounds']} rounds, "
              f"{st['spec_accepted_tokens']}/{st['spec_draft_tokens']} "
              f"drafts accepted (rate {st['spec_acceptance_rate']:.3f})")
    if args.paged:
        print(f"[serve] paged: {st['prefill_chunks']} prefill chunks, "
              f"{st['prefill_tokens_computed']}/{st['prompt_tokens_total']} "
              f"prompt tokens computed (prefix hit rate "
              f"{st['prefix_hit_rate']:.2f}), {st['evictions']} evictions, "
              f"{st['pages_hot']}/{st['pages_total']} pages hot")
    for r in results[:3]:
        print(f"  req {r.uid} [{r.finish_reason}]: {r.tokens[:10].tolist()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
