"""Serving CLI: ``python -m repro_torch.launch.serve [--full] [...]``.

Draw a model from a seed, calibrate it on synthetic batches and quantize
it under the qera-exact scaling (SRR by default; ``--method qer`` or
``w-only`` for the baselines) into the Q + LR container, one block at a
time, so the f32 model is never whole on the device → serve requests
through the continuous-batching engine, as ``repro.launch.serve`` does,
on the card by default (``--device cuda``; ``--device cpu`` runs the
kernels' plain versions).
``--arch`` picks a registered architecture (``phi3-mini-3.8b``,
``chatglm3-6b``, ``minitron-4b`` and ``qwen1.5-32b``, dense,
``deepseek-moe-16b``, MoE, ``deepseek-v2-lite-16b``, MLA over MoE,
``recurrentgemma-9b``, RG-LRU blocks and sliding-window attention,
``xlstm-125m``, mLSTM and sLSTM blocks, or ``whisper-large-v3``, the
encoder-decoder, whose calibration draws the synthetic ``frames`` stub
and whose requests are served over zero frames, as the JAX CLI serves
them; the last four take neither ``--paged`` nor ``--spec-k``);
``--full`` serves it at its published
size instead of its ``.reduced()`` smoke-test size. ``--paged`` serves from the paged KV
cache with prefix reuse and chunked prefill; ``--scheduler bucketed``
through the bucketed baseline. ``--temperature``/``--top-p``/``--top-k``
set every request's ``SamplingParams``; ``--spec-k K`` decodes greedy
lanes self-speculatively (a Q-only draft of K - 1 tokens, one Q + LR
verify chunk a lane). The observability flags are the JAX CLI's:
``--quant-report``, ``--sanitize``, ``--drift-monitor``, ``--telemetry``,
``--metrics-json``, ``--tokens-json``, ``--trace`` and ``--profile-dir``
(a ``torch.profiler`` Chrome trace of the first ``--profile-steps``
engine steps).
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core.api import PTQConfig
from repro_torch.data import data_config_for
from repro_torch.models.build import DrawnBlocks, build_quantized_lm
from repro_torch.models.transformer import LM, init_lm
from repro_torch.quant import QuantizerConfig
from repro_torch.serve import Engine, Request, SamplingParams, ServeConfig
from repro_torch.serve.telemetry import percentile


def add_model_args(p: argparse.ArgumentParser) -> None:
    """Model, quantization and device flags shared by the batch driver
    here and the HTTP server (``repro_torch.launch.server``)."""
    p.add_argument("--arch", default="phi3-mini-3.8b", choices=sorted(ARCHS))
    p.add_argument("--method", default="srr",
                   choices=["srr", "qer", "w-only", "none"])
    p.add_argument("--rank", type=int, default=16)
    p.add_argument("--bits", type=int, default=3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--quant-report", metavar="PATH", default=None,
                   help="write the per-matrix quantization-quality report "
                        "(singular-spectrum head, preserved/exposed "
                        "energy, residual norms, container bytes) as JSON "
                        "to PATH, plus a Chrome trace of the quantizer "
                        "passes to PATH with a .trace.json extension; "
                        "render with python -m tools.quant_report PATH")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--full", action="store_true",
                   help="published size instead of .reduced()")


def build_quantized_model(args, tag: str = "serve", *, progress=None
                          ) -> tuple[LM, ModelConfig]:
    """Build the model per the model flags and, unless ``--method none``,
    run the paper's pipeline with the JAX CLI's defaults: calibrate on two
    synthetic batches of 4 × 32 tokens, then quantize under qera-exact;
    returns ``(model, cfg)``. The quantized model is built a block at a
    time (``models.build``: each block drawn, calibrated and quantized
    before the next is drawn), so a model whose f32 weights would not fit
    on the card is served once its container fits; it equals ``init_lm``
    → ``capture_calibration`` → ``quantize_model_params`` bit for bit.
    ``--method none`` draws the whole fp model with ``init_lm``.
    ``progress`` goes to :func:`~repro_torch.models.build.
    build_quantized_lm`.

    ``--quant-report PATH`` threads a :class:`repro_torch.obs.QuantRecorder`
    through the pass and writes its report (always: ``--method none``
    writes one with no layers)."""
    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    recorder = None
    report_path = getattr(args, "quant_report", None)
    if report_path:
        from repro_torch.obs import QuantRecorder
        recorder = QuantRecorder()
    if args.method == "none":
        model = init_lm(cfg, args.seed, device=args.device)
    else:
        dcfg = data_config_for(cfg, seq_len=32, global_batch=4,
                               seed=args.seed)
        ptq = PTQConfig(method=args.method, scaling="qera-exact",
                        quantizer=QuantizerConfig(kind="mxint",
                                                  bits=args.bits,
                                                  block_size=32),
                        rank=args.rank, seed=args.seed)
        t0 = time.perf_counter()
        model, reports = build_quantized_lm(
            DrawnBlocks(cfg, args.seed, device=args.device), ptq, dcfg, 2,
            progress=progress, recorder=recorder, device=args.device)
        print(f"[{tag}] {args.method} quantized {len(reports)} matrices in "
              f"{time.perf_counter() - t0:.1f}s (drawn, calibrated and "
              f"quantized a block at a time, {cfg.n_layers} layers)")
    if recorder is not None:
        recorder.write(report_path)
        print(f"[{tag}] quant report -> {report_path}")
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
    add_model_args(p)
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
    p.add_argument("--sanitize", action="store_true",
                   help="audit serve-state invariants after every engine "
                        "step (page refcount conservation, block-table "
                        "validity, pos monotonicity, int4 nibble "
                        "alignment); token-identical but host-syncing — "
                        "a debug mode, not a production default")
    p.add_argument("--drift-monitor", action="store_true",
                   help="sampled shadow comparison of the serving logits "
                        "against a reference lowering of the same "
                        "quantized model (KL / top-1 agreement / "
                        "max-|Δlogit| histograms + NaN/inf guard counters "
                        "in the metrics snapshot); token- and "
                        "cache-identical, one extra decode pass per "
                        "sampled step")
    p.add_argument("--drift-sample-rate", type=float, default=0.05,
                   help="fraction of decode steps the drift monitor "
                        "compares (deterministic in the step counter; "
                        "1.0 = every step)")
    p.add_argument("--drift-ref-fused", default="off",
                   choices=["auto", "on", "off"],
                   help="fused mode of the drift monitor's reference "
                        "lowering; the default 'off' is the dequantize-"
                        "then-matmul path")
    p.add_argument("--telemetry", action="store_true",
                   help="serve telemetry: request-lifecycle + step-phase "
                        "tracing, latency histograms, per-entry dispatch "
                        "accounting (implied by --trace/--profile-dir)")
    p.add_argument("--metrics-json", metavar="PATH", default=None,
                   help="write the final metrics snapshot as JSON to PATH, "
                        "plus the Prometheus text exposition to PATH with "
                        "a .prom extension")
    p.add_argument("--tokens-json", metavar="PATH", default=None,
                   help="write {uid: generated tokens} as JSON to PATH")
    p.add_argument("--trace", metavar="PATH", default=None,
                   help="write the Chrome trace-event JSON (Perfetto-"
                        "loadable) to PATH, plus the JSONL event stream to "
                        "PATH with a .jsonl extension")
    p.add_argument("--trace-sync", action="store_true",
                   help="fence device dispatches (torch.cuda.synchronize) "
                        "so traced phase timings show device time where it "
                        "was launched, not in the next host transfer")
    p.add_argument("--profile-dir", metavar="DIR", default=None,
                   help="capture a torch.profiler Chrome trace of the first "
                        "--profile-steps engine steps into DIR")
    p.add_argument("--profile-steps", type=int, default=20,
                   help="engine steps to capture under --profile-dir")
    return p


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    model, cfg = build_quantized_model(args)
    max_len = max(128, args.prefill_len + args.new_tokens)
    telemetry = bool(args.telemetry or args.trace or args.profile_dir)
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
        spec_k=args.spec_k if args.spec_k > 0 else 4,
        sanitize=args.sanitize, drift_monitor=args.drift_monitor,
        drift_sample_rate=args.drift_sample_rate,
        drift_ref_fused=args.drift_ref_fused,
        telemetry=telemetry, trace_sync=args.trace_sync,
        profile_dir=args.profile_dir, profile_steps=args.profile_steps),
        device=args.device)
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
    lats = [r.latency_s for r in results if r.latency_s is not None]
    if args.scheduler == "continuous" and lats:
        print(f"[serve] latency p50 {percentile(lats, 0.50) * 1e3:.0f}ms "
              f"p95 {percentile(lats, 0.95) * 1e3:.0f}ms occupancy "
              f"{st['occupancy']:.2f} eos_retired {st['eos_retired']}")
    if args.spec_k > 0:
        print(f"[serve] speculative: {st['spec_rounds']} rounds, "
              f"{st['spec_accepted_tokens']}/{st['spec_draft_tokens']} "
              f"drafts accepted (rate {st['spec_acceptance_rate']:.3f})")
    if args.drift_monitor:
        print(f"[serve] drift: {st['drift_checks']} checks, top-1 "
              f"agreement {st['drift_top1_agreement_rate']:.3f}, "
              f"{st['drift_nonfinite']} non-finite, "
              f"{st['guard_token_oob']} OOB tokens")
    if args.paged:
        print(f"[serve] paged: {st['prefill_chunks']} prefill chunks, "
              f"{st['prefill_tokens_computed']}/{st['prompt_tokens_total']} "
              f"prompt tokens computed (prefix hit rate "
              f"{st['prefix_hit_rate']:.2f}), {st['evictions']} evictions, "
              f"{st['pages_hot']}/{st['pages_total']} pages hot")
    for r in results[:3]:
        print(f"  req {r.uid} [{r.finish_reason}]: {r.tokens[:10].tolist()}")
    if args.tokens_json:
        with open(args.tokens_json, "w") as f:
            json.dump({int(r.uid): [int(t) for t in r.tokens]
                       for r in results}, f, sort_keys=True)
            f.write("\n")
        print(f"[serve] tokens -> {args.tokens_json}")
    if args.metrics_json:
        with open(args.metrics_json, "w") as f:
            json.dump(st, f, indent=2, sort_keys=True)
            f.write("\n")
        prom = os.path.splitext(args.metrics_json)[0] + ".prom"
        with open(prom, "w") as f:
            f.write(eng.prometheus())
        print(f"[serve] metrics -> {args.metrics_json} (+ {prom})")
    if args.trace:
        jsonl = os.path.splitext(args.trace)[0] + ".jsonl"
        eng.write_trace(args.trace, jsonl_path=jsonl)
        print(f"[serve] trace -> {args.trace} (+ {jsonl})")
    if args.profile_dir:
        eng.tel.stop_profiler()
        print(f"[serve] torch.profiler trace -> {args.profile_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
