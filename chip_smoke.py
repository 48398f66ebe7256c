#!/usr/bin/env python3
"""Drive the PyTorch port's serving main path on one CUDA card.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero):

1. the device: ``torch.cuda.get_device_name`` and nvidia-smi's name and
   power limit;
2. the kernel build: one ``nvcc`` per CUDA source, all started together;
3. every kernel of the path (K1, K2, K3, K4) against its plain PyTorch
   version at phi3-mini-3.8b's full-width shapes: max error against a
   stated tolerance, kernel / plain / library-yardstick times (CUDA
   events, inputs rotated through more than the 50 MB L2 cache, as a
   decode step over 32 layers finds them cold) and the bound;
4. the main path at full width, through the entry points a user calls:
   ``init_lm`` (seed 0) → SRR ``quantize_model_params`` (rank 16, 3-bit
   MXINT, int8 container) → ``Engine`` (8 lanes, bf16 KV, fused auto)
   answering 8 requests of 32 new tokens with 150–250-token prompts,
   with every kernel's launch count read around that run; then the same
   model's prefill logits through the kernels against the
   dequantize-then-matmul baseline;
5. a reduced-depth (2-layer, full-width) model in the packed4 container
   served with int4 and int8 KV, and its prefill logits on the card
   (kernels) against the CPU (plain versions).

The last lines are the nvidia-smi line, one JSON object with a record
per kernel, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import copy
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "build")

# H100 SXM data-sheet peaks (dense): HBM bandwidth, f32 outside the tensor
# cores, bf16 tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12}
L2_BYTES = 50e6


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def time_ms(fn, arg_sets, reps: int = 20) -> tuple[float, float]:
    """(device ms, host ms) per call of ``fn(*args)`` over ``reps`` calls,
    cycling through ``arg_sets`` so consecutive calls read different
    memory. The card first runs a sleep kernel long enough for the host
    to enqueue every call behind it, so the CUDA-event interval holds the
    device's work alone, back to back, and not the host's launch cost
    (reported separately as host ms)."""
    import torch
    for args in arg_sets[:3]:
        fn(*args)
    torch.cuda.synchronize()
    sleep_cycles = 100_000_000                  # ~50 ms at 1.98 GHz
    for _ in range(4):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep_cycles)
        t0 = time.perf_counter()
        start.record()
        for i in range(reps):
            fn(*arg_sets[i % len(arg_sets)])
        end.record()
        host_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        if host_s < 0.4 * sleep_cycles / 2e9:   # enqueued well inside the sleep
            break
        sleep_cycles *= 4
    return start.elapsed_time(end) / reps, 1e3 * host_s / reps


def copies_for(nbytes: int) -> int:
    """Copies of an input set that together exceed twice the L2 cache."""
    return max(2, math.ceil(2 * L2_BYTES / max(nbytes, 1)))


def bound_ms(nbytes: float, ops: float, dtype: str) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def tensor_bytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------
def check_qlr(dev, m: int, k: int, n: int, rank: int, packed: bool) -> dict:
    import torch
    from repro_torch.kernels import mxint_matmul as mk
    from repro_torch.quant.mxint import MXIntQuantizer, pack_codes_4bit

    gen = torch.Generator(device=dev).manual_seed(k + n + rank)
    x = torch.randn((m, k), generator=gen, device=dev)
    qz = MXIntQuantizer(bits=3).quantize(
        torch.randn((k, n), generator=gen, device=dev) * k ** -0.5)
    codes = pack_codes_4bit(qz.codes) if packed else qz.codes
    scale = torch.exp2(qz.exponents.float()).contiguous()
    l = torch.randn((k, rank), generator=gen, device=dev) * 0.05
    r = torch.randn((rank, n), generator=gen, device=dev) * 0.05
    fused = m <= 128
    kernel = mk.qlr_fused_matmul if fused else \
        (lambda x_, c_, s_, l_, r_: mk.qlr_xl_matmul(x_, c_, s_, x_ @ l_, r_))
    got = kernel(x, codes, scale, l, r)
    want = mk.qlr_matmul_plain(x, codes, scale, l, r)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    tol = 1e-4 * max(1.0, float(want.abs().max()))
    w_dense = mk.dequant_blockwise(qz.codes, scale, torch.float32) + l @ r
    per_copy = tensor_bytes(codes, scale, l, r, w_dense)
    sets = [(x, codes.clone(), scale.clone(), l.clone(), r.clone())
            for _ in range(copies_for(per_copy))]
    dense = [(x, w_dense.clone()) for _ in range(len(sets))]
    t_kernel, host = time_ms(kernel, sets)
    t_plain, _ = time_ms(mk.qlr_matmul_plain, sets)
    t_lib, _ = time_ms(torch.matmul, dense)
    nbytes = tensor_bytes(x, codes, scale, r) + m * n * 4 \
        + (k * rank * 4 if fused else m * rank * 4)
    ops = 2 * m * k * n + 2 * m * k * rank + 2 * m * rank * n
    b_ms, b_by = bound_ms(nbytes, ops, "float32")
    return dict(name="K1 qlr_fused_matmul" if fused else "K2 qlr_xl_matmul",
                shape=f"M={m} K={k} N={n} r={rank} "
                      f"{'packed4' if packed else 'int8'}",
                max_abs_err=err, tol=tol, ms=t_kernel, host_ms=host,
                plain_ms=t_plain, library_ms=t_lib, bound_ms=b_ms,
                bound_by=b_by)


def check_decode(dev, kind: str, b=8, kvh=32, s=512, hd=96) -> dict:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as dk
    from repro_torch.quant.mxint import pack_codes_4bit, unpack_codes_4bit

    gen = torch.Generator(device=dev).manual_seed(s)
    q = torch.randn((b, kvh, 1, hd), generator=gen, device=dev)
    kf = torch.randn((b, kvh, s, hd), generator=gen, device=dev)
    vf = torch.randn((b, kvh, s, hd), generator=gen, device=dev)
    ks = vs = None
    if kind == "bf16":
        k, v = kf.bfloat16(), vf.bfloat16()
    else:
        qmax = 127 if kind == "int8" else 7
        ks = kf.abs().amax(-1).clamp_min(1e-8) / qmax
        vs = vf.abs().amax(-1).clamp_min(1e-8) / qmax
        k = torch.round(kf / ks[..., None]).clamp(-qmax, qmax).to(torch.int8)
        v = torch.round(vf / vs[..., None]).clamp(-qmax, qmax).to(torch.int8)
        if kind == "int4":
            k, v = pack_codes_4bit(k), pack_codes_4bit(v)
    q_pos = torch.full((b,), s - 1, dtype=torch.int32, device=dev)
    k_pos = torch.arange(s, dtype=torch.int32, device=dev).repeat(b, 1)

    def kernel(q_, k_, v_, ks_, vs_):
        return dk.flash_decode(q_, k_, v_, q_pos, k_pos, ks_, vs_)

    def plain(q_, k_, v_, ks_, vs_):
        return dk.decode_attention_plain(q_, k_, v_, q_pos, k_pos, ks_, vs_)

    got, want = kernel(q, k, v, ks, vs), plain(q, k, v, ks, vs)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    tol = 1e-4 * max(1.0, float(want.abs().max()))
    # the yardstick: SDPA on the dense (dequantized) cache
    if kind == "bf16":
        kd, vd, qd = k, v, q.bfloat16()
    else:
        kc, vc = (unpack_codes_4bit(k), unpack_codes_4bit(v)) \
            if kind == "int4" else (k, v)
        kd, vd, qd = kc.float() * ks[..., None], vc.float() * vs[..., None], q
    per_copy = tensor_bytes(k, v, ks, vs)
    n_copies = copies_for(per_copy)
    sets = [(q, k.clone(), v.clone(), None if ks is None else ks.clone(),
             None if vs is None else vs.clone()) for _ in range(n_copies)]
    dense = [(qd, kd.clone(), vd.clone()) for _ in range(n_copies)]
    t_kernel, host = time_ms(kernel, sets)
    t_plain, _ = time_ms(plain, sets)
    t_lib, _ = time_ms(F.scaled_dot_product_attention, dense)
    nbytes = tensor_bytes(q, k, v, ks, vs, q_pos, k_pos) + q.numel() * 4
    ops = 2 * 2 * b * kvh * s * hd
    b_ms, b_by = bound_ms(nbytes, ops, "float32")
    return dict(name="K3 flash_decode", shape=f"B={b} KV={kvh} G=1 S={s} "
                f"hd={hd} {kind}", max_abs_err=err, tol=tol, ms=t_kernel,
                host_ms=host, plain_ms=t_plain, library_ms=t_lib, bound_ms=b_ms,
                bound_by=b_by)


def check_flash(dev, h=32, s=256, hd=96) -> dict:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fk

    gen = torch.Generator(device=dev).manual_seed(hd)
    q = torch.randn((1, s, h, 1, hd), generator=gen, device=dev)
    k = torch.randn((1, s, h, hd), generator=gen, device=dev)
    v = torch.randn((1, s, h, hd), generator=gen, device=dev)
    pos = torch.arange(s, dtype=torch.int32, device=dev)

    def kernel(q_, k_, v_):
        return fk.flash_attention_cuda(q_, k_, v_, pos, pos)

    def plain(q_, k_, v_):
        return fk.flash_attention_plain(q_, k_, v_, pos, pos)

    got, want = kernel(q, k, v), plain(q, k, v)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    tol = 1e-4 * max(1.0, float(want.abs().max()))
    n_copies = copies_for(tensor_bytes(q, k, v))
    sets = [(q.clone(), k.clone(), v.clone()) for _ in range(n_copies)]
    heads = [tuple(t.reshape(1, s, h, hd).transpose(1, 2).contiguous()
                   for t in st) for st in sets]
    t_kernel, host = time_ms(kernel, sets)
    t_plain, _ = time_ms(plain, sets)
    t_lib, _ = time_ms(lambda a, b_, c: F.scaled_dot_product_attention(
        a, b_, c, is_causal=True), heads)
    nbytes = 4 * tensor_bytes(q) + 2 * s * 4
    pairs = s * (s + 1) // 2                  # causal: keys at or before
    ops = 2 * 2 * h * pairs * hd
    b_ms, b_by = bound_ms(nbytes, ops, "float32")
    return dict(name="K4 flash_attention", shape=f"H={h} S={s} hd={hd} "
                f"causal f32", max_abs_err=err, tol=tol, ms=t_kernel,
                host_ms=host, plain_ms=t_plain, library_ms=t_lib, bound_ms=b_ms,
                bound_by=b_by)


def phase_kernels(dev) -> list:
    rows = []
    for m in (8, 256):                         # decode lanes → K1; prefill → K2
        for k, n in ((3072, 3072), (3072, 8192), (8192, 3072)):
            for packed in (False, True):
                for rank in (16, 0):
                    rows.append(check_qlr(dev, m, k, n, rank, packed))
    for kind in ("bf16", "int8", "int4"):
        rows.append(check_decode(dev, kind))
    rows.append(check_flash(dev))
    for r in rows:
        log("kernels", f"{r['name']:22s} {r['shape']:34s} err {r['max_abs_err']:.3e} "
            f"(tol {r['tol']:.1e}) kernel {r['ms']:.4f} ms (host "
            f"{r['host_ms']:.4f} ms/call) plain "
            f"{r['plain_ms']:.4f} ms library {r['library_ms']:.4f} ms bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
    bad = [r for r in rows if not r["max_abs_err"] <= r["tol"]]
    require(not bad, f"kernels disagree with their plain versions: {bad}")
    return rows


# ---------------------------------------------------------------------------
# phases 4 and 5: the serving path
# ---------------------------------------------------------------------------
def launch_counts() -> dict:
    from repro_torch.kernels import decode_attention, flash_attention, \
        mxint_matmul
    return {"K1": mxint_matmul.LAUNCHES["qlr_fused"],
            "K2": mxint_matmul.LAUNCHES["qlr"],
            "K3": decode_attention.LAUNCHES["flash_decode"],
            "K4": flash_attention.LAUNCHES["flash_attention"]}


def reset_counts() -> None:
    from repro_torch.kernels import decode_attention, flash_attention, \
        mxint_matmul
    for mod in (mxint_matmul, decode_attention, flash_attention):
        for key in mod.LAUNCHES:
            mod.LAUNCHES[key] = 0


def serve(eng, reqs) -> tuple[list, list, float]:
    """Submit every request and step the engine to the end; returns
    (results, seconds of the steps that only decoded, wall seconds)."""
    t0 = time.perf_counter()
    for r in reqs:
        r.t_submit = t0
        eng.submit(r)
    results, decode_steps = [], []
    while eng.sched.has_work:
        admitted = eng.sched.stats.admitted
        ts = time.perf_counter()
        results.extend(eng.step())          # ends in a device → host copy
        if eng.sched.stats.admitted == admitted:
            decode_steps.append(time.perf_counter() - ts)
    return sorted(results, key=lambda r: r.uid), decode_steps, \
        time.perf_counter() - t0


def profile_decode(eng, cfg, reqs, n_steps: int = 4) -> None:
    """torch.profiler over decode-only engine steps: wall per step, the
    device's busy share, and the kernels that take the device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for r in reqs:
        eng.submit(r)
    eng.step()                                  # the 8 admissions + a decode
    eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    while eng.sched.has_work:
        eng.step()
    # kernel (and memcpy/memset) events only: an aten op's row repeats
    # the device time of the kernels it launched
    dev_us = {e.key: e.self_device_time_total for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0}
    busy = sum(dev_us.values()) / (wall * 1e6)
    log("profile", f"{n_steps} decode steps under torch.profiler: "
        f"{1e3 * wall / n_steps:.2f} ms/step wall, device busy "
        f"{sum(dev_us.values()) / n_steps / 1e3:.2f} ms/step "
        f"({100 * busy:.1f}% busy, {100 * (1 - busy):.1f}% idle)")
    for key, us in sorted(dev_us.items(), key=lambda kv: -kv[1])[:10]:
        log("profile", f"  {us / n_steps / 1e3:8.3f} ms/step  {key[:90]}")


def phase_main_path(dev, cfg) -> dict:
    import torch
    from repro_torch.core.api import PTQConfig
    from repro_torch.launch.serve import make_requests
    from repro_torch.models import Ctx, init_cache, init_lm, prefill
    from repro_torch.models.quantize import quantize_model_params
    from repro_torch.serve import Engine, ServeConfig

    t0 = time.perf_counter()
    model = init_lm(cfg, 0, device=dev)
    torch.cuda.synchronize()
    log("main", f"init_lm {cfg.name}: {cfg.n_layers} layers d_model "
        f"{cfg.d_model} heads {cfg.n_heads} head_dim {cfg.head_dim_} d_ff "
        f"{cfg.d_ff} vocab {cfg.vocab} in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    model, reports = quantize_model_params(
        model, PTQConfig(method="srr", rank=16, bits=3, seed=0),
        container="int8", device=dev)
    torch.cuda.synchronize()
    t_quant = time.perf_counter() - t0
    mean_k = sum(r.k_star for r in reports) / len(reports)
    log("main", f"SRR quantized {len(reports)} matrices in {t_quant:.2f} s "
        f"(rank 16, 3-bit MXINT b32, mean k* {mean_k:.2f})")

    sc = ServeConfig(max_len=512, decode_batch=8, prefill_len=256,
                     kv_dtype="bf16", fused="auto", max_new_tokens=32)
    eng = Engine(model, cfg, sc, device=dev)
    lengths = [150 + (100 * i) // 7 for i in range(8)]
    serve(eng, make_requests(cfg, 2, seed=1, lengths=[40, 60]))  # warm-up
    eng = Engine(model, cfg, sc, device=dev)
    reqs = make_requests(cfg, 8, seed=0, lengths=lengths)
    reset_counts()
    results, steps, wall = serve(eng, reqs)
    counts = launch_counts()
    n_tok = sum(len(r.tokens) for r in results)
    ttft = [r.ttft_s for r in results]
    step_ms = 1e3 * sum(steps) / len(steps)
    log("main", f"served {len(results)} requests, {n_tok} tokens in "
        f"{wall:.3f} s: {n_tok / wall:.1f} tok/s; TTFT first "
        f"{1e3 * min(ttft):.1f} ms mean {1e3 * sum(ttft) / len(ttft):.1f} ms "
        f"max {1e3 * max(ttft):.1f} ms; decode step {step_ms:.2f} ms over "
        f"{len(steps)} decode-only steps ({8 / step_ms * 1e3:.1f} tok/s at 8 "
        f"lanes)")
    log("main", f"kernel launches in the run: {counts}")
    require(len(results) == 8 and all(len(r.tokens) == 32 for r in results),
            f"expected 8 requests × 32 tokens, got "
            f"{[len(r.tokens) for r in results]}")
    require(all(0 <= t < cfg.vocab for r in results for t in r.tokens),
            "a token outside the vocabulary")
    require(all(c > 0 for c in counts.values()),
            f"a kernel of the path never launched: {counts}")

    profile_decode(eng, cfg, make_requests(cfg, 8, seed=4, lengths=lengths))

    # kernels vs the dequantize-then-matmul baseline, same model, same input
    tokens = torch.from_numpy(reqs[0].prompt).long()[None].to(dev)
    n = torch.tensor([tokens.shape[1]], dtype=torch.int32, device=dev)
    logit = {}
    for fused in ("auto", "off"):
        cache = init_cache(cfg, 1, 512, torch.bfloat16, dev)
        logit[fused] = prefill(Ctx(fused=fused), model, tokens, cache,
                               lengths=n)[0].float()
    scale = float(logit["off"].abs().max())
    err = float((logit["auto"] - logit["off"]).abs().max())
    require(bool(torch.isfinite(logit["auto"]).all()), "non-finite logits")
    log("main", f"prefill logits, kernels vs dequantize-then-matmul "
        f"baseline: max |Δ| {err:.3e} (max |logit| {scale:.3f}, tol "
        f"{1e-3 * scale:.3e})")
    require(err <= 1e-3 * max(1.0, scale), "kernel path disagrees with the "
            "dequantize-then-matmul baseline")
    del eng, model
    torch.cuda.empty_cache()
    return dict(counts=counts, quantize_s=t_quant, tok_s=n_tok / wall,
                step_ms=step_ms, ttft_ms=[1e3 * t for t in ttft])


def phase_reduced(dev, cfg) -> None:
    import torch
    from repro_torch.core.api import PTQConfig
    from repro_torch.launch.serve import make_requests
    from repro_torch.models import Ctx, init_cache, init_lm, prefill
    from repro_torch.models.quantize import quantize_model_params
    from repro_torch.serve import Engine, ServeConfig

    model, _ = quantize_model_params(init_lm(cfg, 1, device=dev),
                                     PTQConfig(rank=16, bits=3, seed=1),
                                     container="packed4", device=dev)
    for kv in ("int4", "int8"):
        eng = Engine(model, cfg, ServeConfig(
            max_len=320, decode_batch=4, prefill_len=256, kv_dtype=kv,
            max_new_tokens=8), device=dev)
        reset_counts()
        results, _, wall = serve(eng, make_requests(cfg, 6, seed=2,
                                                    lengths=[40, 90, 200, 17,
                                                             255, 128]))
        counts = launch_counts()
        log("reduced", f"packed4 weights, kv {kv}: {len(results)} requests "
            f"in {wall:.3f} s, launches {counts}")
        require(len(results) == 6 and all(len(r.tokens) == 8
                                          for r in results),
                "reduced run did not finish its requests")
        require(all(c > 0 for c in counts.values()),
                f"a kernel never launched with kv {kv}: {counts}")

    prompt = make_requests(cfg, 1, seed=3, lengths=[200])[0].prompt
    cpu_model = copy.deepcopy(model).to("cpu")
    logit = {}
    for name, m, d in (("card", model, dev), ("cpu", cpu_model,
                                              torch.device("cpu"))):
        tokens = torch.zeros((1, 256), dtype=torch.int64)
        tokens[0, :200] = torch.from_numpy(prompt)
        logit[name] = prefill(Ctx(), m, tokens.to(d),
                              init_cache(cfg, 1, 320, "int4", d),
                              lengths=torch.tensor([200], dtype=torch.int32,
                                                   device=d))[0].float().cpu()
    scale = float(logit["cpu"].abs().max())
    err = float((logit["card"] - logit["cpu"]).abs().max())
    log("reduced", f"prefill logits card (kernels) vs CPU (plain versions): "
        f"max |Δ| {err:.3e} (max |logit| {scale:.3f}, tol "
        f"{1e-3 * max(1.0, scale):.3e})")
    require(err <= 1e-3 * max(1.0, scale), "card and CPU logits disagree")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False   # full-f32 references
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log("device", f"{name}; torch {torch.__version__} CUDA "
        f"{torch.version.cuda}; nvidia-smi: {smi}")

    t0 = time.perf_counter()
    took = _build.build()
    log("build", f"nvcc sm_90a, {len(took)} sources in parallel: "
        + ", ".join(f"{k} {v:.1f} s" for k, v in took.items())
        + f"; wall {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    rows = phase_kernels(dev)
    log("kernels", f"phase took {time.perf_counter() - t0:.1f} s")
    from repro_torch.configs import get_config
    cfg = get_config("phi3-mini-3.8b")
    t0 = time.perf_counter()
    main_run = phase_main_path(dev, cfg)
    log("main", f"phase took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_reduced(dev, dataclasses.replace(cfg, n_layers=2))
    log("reduced", f"phase took {time.perf_counter() - t0:.1f} s")

    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as fh:
        json.dump({"device": name, "nvidia_smi": smi, "cases": rows,
                   "main_path": main_run}, fh, indent=1)

    picks = {"K1": ("K1 qlr_fused_matmul", "M=8 K=3072 N=8192 r=16 int8",
                    "src/repro_torch/kernels/csrc/mxint_matmul.cu",
                    "src/repro/kernels/mxint_matmul.py:199"),
             "K2": ("K2 qlr_xl_matmul", "M=256 K=3072 N=8192 r=16 int8",
                    "src/repro_torch/kernels/csrc/mxint_matmul.cu",
                    "src/repro/kernels/mxint_matmul.py:127"),
             "K3": ("K3 flash_decode", "B=8 KV=32 G=1 S=512 hd=96 bf16",
                    "src/repro_torch/kernels/csrc/decode_attention.cu",
                    "src/repro/kernels/decode_attention.py:121"),
             "K4": ("K4 flash_attention", "H=32 S=256 hd=96 causal f32",
                    "src/repro_torch/kernels/csrc/flash_attention.cu",
                    "src/repro/kernels/flash_attention.py:78")}
    kernels = []
    for key, (kname, shape, source, replaces) in picks.items():
        row = next(r for r in rows if r["name"] == kname
                   and r["shape"] == shape)
        kernels.append({"name": f"{kname} ({shape})", "route": "cuda",
                        "source": source, "replaces": replaces,
                        "launches": main_run["counts"][key],
                        "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                        "plain_ms": row["plain_ms"],
                        "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"],
                        "library_ms": row["library_ms"]})
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
