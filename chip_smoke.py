#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one CUDA card.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero):

1. the device: ``torch.cuda.get_device_name`` and nvidia-smi's name and
   power limit;
2. the kernel build: one ``nvcc`` per CUDA source, all started together;
3. every kernel of the paths (K1–K7) against its plain PyTorch version
   at the full-width shapes of phi3-mini-3.8b and deepseek-moe-16b (K4
   also at the chunked-prefill shape and at the speculative verify chunk's
   4 queries over a 512-slot context, K5 on a shuffled block table; K1 at
   the verify chunk's 4 rows, the MoE router's 64 columns and the dense
   lead-in layer's 10944; K3
   and K4 at head_dim 128, K3 also at phase 4's occupancy, rows of
   150–282 valid slots of 512; K6 over the 64-expert stacks at decode and
   prefill rows, and at decode with the counts of a seeded top-6 routing
   (rows past a count must come out exactly 0); K7 bit for bit at every
   matrix shape of both SRR passes, an N below a multiple of 128 and an
   N % 4 != 0, with an f32 → int8 ``copy_`` of the same bytes timed
   beside it); for phase "dense", K3 and K5 at chatglm3-6b's group (KV 2,
   G 16, bf16 and int8 KV) and minitron-4b's (KV 8, G 3), head_dim 128,
   K1 at 4096×256 and 13696×4096 and K7 at 13696×4096, and for phase
   "depth" K1 at 5120×27392 and K7 at 27392×5120; for phase "mla", K3's
   latent instance at B=8, one KV head, G 16, head_dim 576 with V the
   first 512 columns of K's rows, bf16 and f32, scale 1/√192 (yardstick: masked SDPA with ``scale=``, the KV head
   expanded); for phase "hybrid", K3 at head_dim 256 (B=8, one KV head, G
   16) in bf16 at the serving rows, f32, int8 and int4, K3 on a wrapped
   2048-slot ring (positions 952–2999 out of slot order, window 2048), K4
   at head_dim 256 (16 heads over one KV head: S 256 f32 and bf16, S 2100
   under the 2048 window), K1/K2 at 4096×4096, 4096×12288, 12288×4096 and
   K7 at those and 4096×256; for phase "xlstm", K1/K2 at xlstm-125m's
   eight projection shapes (``w_if`` 1536×8 at rank 4) and at the reduced
   sLSTM FFN's N = 85 (widened to 88 by the launchers), K7 at 768×1536,
   1536×1536, 1536×8 and 1024×768; for phase "whisper", K4 at head dim
   64 over 20 heads non-causal at 1500 × 1500 and 256 × 1500 and causal
   at 256 (f32), K3 at hd 64, KV 20, G 1 over 512 slots (bf16, int8) and
   over the 1500-slot cross memory, every slot valid (bf16, f32), K1/K2
   at 1280×1280, 1280×5120 and 5120×1280 with 8, 256 and 1500 rows, K7
   at those; for phase "vlm", K1/K2 at internvl2-2b's 2048×2048,
   2048×1024, 2048×8192 and 8192×2048 with 8 and 512 rows, K3 at KV 8,
   G 2, hd 128 over 576 slots at its serving rows (406–538 valid), K4 at
   16 heads over 8 at its 512-row prefill (f32), K7 at those shapes:
   max error against a stated tolerance,
   kernel / plain / library-yardstick times (CUDA events, inputs rotated
   through more than the 50 MB L2 cache, as a decode step over all the
   layers finds them cold) and the bound (K1/K2/K6: the function's
   operations at the bf16 peak, which the tensor cores reach within the
   gate since the MXINT weight is exact in bf16 and an f32 x enters as a
   bf16 pair, beside the f32 CUDA-core figure earlier runs used; K2 also
   the time of the ``x·L`` GEMM it includes; K6 at serving occupancy
   counts only the experts and rows that hold a token);
4. the unpaged main path at full width, through the entry points a user
   calls: ``init_lm`` (seed 0) → ``capture_calibration`` through
   ``lm_loss`` (4 batches of 8 × 256 synthetic tokens, seed 0; its
   seconds, then the ``eigh`` of every distinct moment set timed apart)
   → qera-exact SRR ``quantize_model_params`` (rank 16, 3-bit MXINT, int8
   container; its seconds, mean k* and the peak memory) → ``Engine`` (8
   lanes, bf16 KV, fused auto) answering 8 requests of 32 new tokens with
   150–250-token prompts, with every kernel's launch count read around
   that run; then the same model's prefill logits through the kernels
   against the dequantize-then-matmul baseline;
4b. the paged main path with the same quantized model:
   ``ServeConfig(paged=True)`` (pages of 16, chunks of 256, a 520-token
   step budget) answering 16 requests that share a 256-token prefix,
   with the launch counts read around that run (K3 must stay at 0: paged
   decode goes through K5); then a 300-token prompt's logits through two
   paged chunks against the unpaged one-shot prefill and against
   ``fused="off"``; then, after serving, where phase 4's SRR pass goes
   (``profile_srr``, over its first two layers' 14
   matrices);
4c. "surface", with phase 4's quantized model: (a) ``sample_tokens`` on
   the card against the CPU over the logits (8, 32,064) of one decode
   step, lanes greedy / temperature 0.7 / top-p 0.9 / top-k 40 and
   combinations (tokens identical), and the threefry bits and uniforms
   of 8 seeds × 4 indices × 32,064 bit for bit across the two devices,
   with the sampler's device and host ms; (b) 8 requests × 32 tokens
   under those ``SamplingParams``, ``logprobs=5`` on half and a stop id
   on a greedy one, served twice (identical tokens, every chosen logprob
   ≤ 0 and ≤ its top-1, ``finish_reason="stop"``), the sampled decode
   step beside phase 4's greedy one; then 9 requests in 8 lanes, one
   aborted after its 8th token (8 tokens, ``"abort"``) and the queued one
   taking its slot; (c) phase 4's serving with ``speculative=True,
   spec_k=4`` (Q-only drafts through K1 at rank 0, one verify chunk a
   lane through K1 at 4 rows and K4 over the unpaged slots) on phase 4's
   prompts: tokens equal phase 4's request by request (a divergence
   prints its position and the spec-off top-2 logit gap there, and
   fails), K1/K3/K4 launched, round ms, acceptance and tok/s; then 1 lane
   with speculation off and on; (d) phase 4b's paged serving with
   ``speculative=True`` over the first 8 of its 16 prompts
   (``SPEC_PAGED_REQUESTS``): tokens equal phase 4b's, K5 launched, page
   refcounts back to the parked pages after the drain;
4d. "frontend", with phase 4's quantized model: the drift probe's
   reference pass over a live cache changes no cache tensor; (a)
   ``serve_http`` on an ephemeral port over phase 4's config, first bare
   (the frontend's own cost: client TTFT and tok/s beside phase 4's),
   then with telemetry, the sanitizer and the drift monitor at rate 1.0:
   phase 4's prompts streamed concurrently as token-id lists through
   ``http.client`` (tokens equal phase 4's request by request), a chat
   stream, a non-stream completion with logprobs, a client that vanishes
   after 8 tokens (aborted, its slot reused), ``/metrics.json`` against
   ``tools/metrics_schema.json`` (the paged-only keys exempt), no
   non-finite logit or out-of-range token, the largest |Δlogit| within
   1e-3 · max|logit|, every uid in ``write_trace``; the drift probe's and
   the sanitizer's ms a step; decode step ms with telemetry off and on,
   in turns; (b) the same over phase 4b's paged config (K5 launched, K3
   not, the full schema); (c) the quant report of phase "ptq"'s
   two-layer model (``QuantRecorder`` through the SRR pass: the report
   validates, ``tools.quant_report`` renders it, the containers are
   bit-identical to a pass without the recorder);
4e. "lowering", with phase 4's quantized model: (a) ``python -m
   repro_torch.launch.dryrun --arch phi3-mini-3.8b --shape decode_32k
   --mesh both`` in a subprocess started beside the kernels' build, read
   here (2 ok: the abstract cells distributed over fake 256- and 512-chip
   worlds and counted); (b) one decode step
   over phase 4's 8-lane cache, its prompts prefilled, is counted by
   ``launch.cost.count`` at ``fused="auto"`` and ``"off"`` (the same
   FLOPs; the recorded K1/K3 calls equal the launches: 7 and 1 a layer;
   each one's formula equals ``flop_counter``'s FLOPs of the
   ``fused="off"`` ops that compute it),
   its roofline terms printed beside its measured device time; (c)
   ``ef_compressed_psum`` over the model's 224 adapter ``l``/``r`` pairs
   (gradients and a residual from a seed) in an NCCL group of one (a
   ``FileStore`` under ``build/``) against a gloo group of one on the CPU,
   bit for bit, ``synced + ef' = g + ef`` within f32 rounding, one sync's
   time; (d) the container distributed over ``make_host_mesh()`` (1×1),
   every ``to_local()`` equal to its tensor;
5. a reduced-depth (2-layer, full-width) model in the packed4 container
   served with int4 and int8 KV, unpaged and paged (chunks of 64, so the
   packed4 chunk writes and nibble read-modify-writes run on the card),
   and its prefill logits on the card (kernels) against the CPU (plain
   versions);
5b. "ptq": phi3 at full width and 1 layer calibrated on the card and on
   the CPU from the same batches (tap names and counts equal, moments
   within ``MOMENT_TOL``), then quantized by w-only, qer, srr and
   srr-joint under qera-exact with exact SVDs, gated per matrix on
   scaled_err(qer) ≤ scaled_err(w-only) and scaled_err(srr-joint) ≤
   scaled_err(srr) (each · (1 + 1e-5)); the held-out ``lm_loss`` of the fp
   model and of each method through the kernels and ``fused="off"``;
   then the uniform and GPTQ quantizers (``make_quantizer``) on layer 0's
   wq (3072²), up (3072×8192) and down (8192×3072): uniform codes,
   scales and zeros on the card bit for bit the CPU's (symmetric and
   asymmetric, 3 bits, groups of 32), and GPTQ bound to the matrix's
   calibration Hessian below uniform round-to-nearest in the proxy error
   tr((W − Q)ᵀ H (W − Q));
6. the MoE main path at full width: ``init_lm`` of deepseek-moe-16b (its
   first ``MOE_LAYERS`` = 2 of 28 layers, the dense lead-in and one MoE
   layer, seed 0; cut so that phases "dense" and "train" fit the
   script's time) →
   calibration as in phase 4 → qera-exact SRR
   ``quantize_model_params`` (routed experts under the identity; each
   layer's statistics released once it is quantized; rank 16, 3-bit
   MXINT, int8 container; K7 quantizes every matrix, its launches read
   around the pass, with the pass's seconds and peak memory) → ``Engine``
   (8 lanes, bf16 KV, fused auto) answering 8 requests of 32 new tokens
   with 150–250-token prompts, with every launch count read around that
   run and profiled decode steps (K6's device time a step logged; no K6
   finishing kernel and no ``aten::bmm`` may appear); then a prompt's
   prefill logits
   through the kernels against ``fused="off"``, with the tokens and
   layers whose top-k expert sets differ between the two runs counted
   (a routing flip), and the logits held to the tolerance under one
   routing (the ``fused="off"`` run replays the kernel run's choices when
   any flipped). Where an SRR pass's time goes is read in phase 4b
   (``profile_srr``); reading phase 6's 207-matrix pass under
   ``torch.profiler`` took about 95 s and gated nothing;
7. "dense": chatglm3-6b (half RoPE, QKV bias, G = 16) and minitron-4b (G =
   3, vocabulary 256,000) at full width and 8 of their 28 and 32 layers
   (``DENSE_RUNS``; at full depth the phase took a quarter of the
   script): ``init_lm`` (seed 0; ``init_lm`` makes the QKV biases zero,
   so they are filled from a seeded generator first, and the bias path
   carries real values) → calibration as in phase 4 → qera-exact SRR (K7's
   launches read around the pass; chatglm's scalings built inside the
   pass, minitron's ahead and timed apart) → phase 4's unpaged serving
   (K1–K4 launched, K5 not; profiled decode steps) and phase 4b's paged
   serving (K5 launched, K3 not); minitron's sampler on the card against
   the CPU at V = 256,000 bit for bit; a 150-token prompt's prefill
   logits through the kernels against ``fused="off"`` and against the
   model moved to the CPU (plain versions), each within 1e-3 ·
   max|logit|;
7b. "depth": qwen1.5-32b (QKV bias, θ = 10⁶, MHA of 40 heads, d_ff
   27,392; 131 GiB in f32 at its 64 layers) built a block at a time
   (``models/build.py``): (a) at full width and 2 layers, the
   whole-model build (``init_lm``, QKV biases from seed 11, phase 4's
   calibration, ``quantize_model_params``) and the block-at-a-time one
   from the same draws, every buffer equal bit for bit, the seconds and
   peak GiB of each stage logged; (b) all 64 layers built by the serve
   CLI's ``build_quantized_model`` on its own arguments (``--arch
   qwen1.5-32b --full``), never more than one block in full precision,
   its peak below 80 GiB, K7 at least twice a matrix → phase 4's unpaged
   serving (K1 448 and K3 64 a decode step, K5 never; profiled decode
   steps) → a 150-token prompt's prefill logits through the kernels
   against ``fused="off"`` within 1e-3 · max|logit| (no CPU leg: the
   container is 44 GB);
8. "mla": deepseek-v2-lite-16b (MLA over the MoE) at full width and 8 of
   its 27 layers (``MLA_LAYERS``): ``init_lm`` (seed 0) → calibration as
   in phase 4 → the scalings built ahead (timed) → qera-exact SRR (K7's
   launches read around the pass) → phase 4's unpaged serving with bf16
   latents (K3 launched exactly decode steps × layers times at the
   576-wide latent head, K4 and K5 never: MLA prefill is plain masked
   softmax attention), profiled decode steps, the int8-KV engine (JAX's float
   rule: bf16 latents, the same tokens), and a 150-token prompt's prefill
   logits and one decode step's logits over 8 lanes (K3 on the path)
   through the kernels against ``fused="off"`` under one routing, each
   within 1e-3 · max|logit|;
9. "hybrid": recurrentgemma-9b (RG-LRU blocks and sliding-window
   attention) at full width and 8 of its 38 layers (``HYBRID_LAYERS``:
   two (rglru, rglru, local) periods and the (rglru, rglru) remainder):
   ``init_lm`` (seed 0) → calibration as in phase 4 → the scalings built
   ahead (timed) → qera-exact SRR → (a) phase 4's unpaged serving with
   bf16 KV (the 512-slot ring does not wrap; every launch count exactly
   as the layout gives it: K1 a projection a decode step, K2 a projection
   a prefill, K3 a local layer a step, K4 a local layer a prefill, K5 and
   K6 never), profiled decode steps; (c) the same with int8 KV (the same
   tokens); the drift probe leaving the hybrid cache bit for bit;
   ``paged``/``speculative`` refused; (b) prompts of 2100 and 2080
   tokens in a 2304-slot cache (the 2048-slot ring wraps, K4 under the
   live window); the prefill logits of (a) and (b) and one decode step's
   logits after the wrap through the kernels against ``fused="off"``,
   each within 1e-3 · max|logit|;
10. "xlstm": xlstm-125m (mLSTM and sLSTM blocks, LayerNorm, no RoPE) at
   full width and all 12 layers: ``init_lm`` (seed 0; the ``w_if`` and
   ``w_gates`` biases filled from seed 13) → calibration as in phase 4 →
   the scalings built ahead (timed) → qera-exact SRR (66 matrices, K7's
   launches read around the pass) → (a) phase 4's unpaged serving with
   bf16 KV (K1 exactly 66 × decode steps, K2 66 × prefills, K3–K6
   never), profiled decode steps; (c) int8 KV (the states f32 either
   way: the same tokens); the drift probe leaving every state tensor bit
   for bit; ``paged``/``speculative`` refused; (b) prompts of 2048 and
   2000 tokens with ``max_len`` 2304 (the parallel form over 8 chunks),
   a lane's state bytes equal to (a)'s (14,266,512); the prefill logits
   of (a) and (b) and one decode step's logits after (b)'s prefill
   through the kernels against ``fused="off"``, each within 1e-3 ·
   max|logit|;
11. "whisper": whisper-large-v3 (the encoder-decoder: a bidirectional
   encoder over the 1500-frame stub, cross attention in every decoder
   block, GELU, LayerNorm, 20 heads of 64) at full width and all 32 + 32
   layers: ``init_lm`` (seed 0) → calibration as in phase 4, over the
   synthetic frames too → the scalings built ahead (timed) → qera-exact
   SRR (512 matrices, K7's launches read around the pass) → (a) phase
   4's unpaged serving with bf16 KV and seeded frames through
   ``extra_inputs`` (every launch count exactly as the layout gives it:
   K1 256 and K3 64 a decode step, K2 512 and K4 96 an admission, K5 and
   K6 never; a lane's cross memory 245,760,000 bytes), profiled decode
   steps; (b) the same with int8 KV (the cross memory stays bf16; tokens
   equal (a)'s except after a first token, at a near-tie within twice
   the |Δlogit| int8 makes); the drift probe leaving the cache bit for
   bit; ``paged``/``speculative`` refused; the prefill logits and one
   decode step's logits over the 8 lanes through the kernels against
   ``fused="off"``, each within 1e-3 · max|logit|;
12. "vlm": internvl2-2b (an InternLM2-1.8B decoder, 16 query heads over 8
   KV heads, with 256 vision rows of 1024 projected by the full-precision
   ``vision_proj`` in front of every prompt) at full width and all 24
   layers: ``init_lm`` (seed 0) → calibration as in phase 4, over the
   synthetic vision stub too → the scalings built ahead (timed) →
   qera-exact SRR (168 matrices, K7 twice each, by shape) → (a) phase 4's
   unpaged serving in a 576-slot cache with 512-row prefills, bf16 KV,
   seeded vision rows through ``extra_inputs`` (every launch count
   exactly as the layout gives it: K1 168 and K3 24 a decode step, K2 168
   and K4 24 an admission, K5 and K6 never), profiled decode steps; (b)
   the same with the sanitizer on (no fault, (a)'s tokens); the first
   prompt's prefill logits with the vision rows against zeros in their
   place (the prefix moves them past the kernels' tolerance);
   ``paged``/``speculative`` refused; the prefill logits and one decode
   step's logits over the 8 lanes through the kernels against
   ``fused="off"``, each within 1e-3 · max|logit|;
13. "train": training and QPEFT through ``repro_torch.launch.train``'s
   ``build`` (the CLI's own set-up) at phi3-mini-3.8b's full width: (a)
   ``--mode qpeft --full-size --batch 8 --seq 64 --rank 16 --bits 3``,
   all 32 layers: init (seed 0) → calibration over 2 batches → the
   qera-exact SRR pass through K7 (its launches read around the build) →
   split; every one of the 224 adapters' ``l`` and ``r`` with a finite,
   nonzero gradient at step 1; 20 timed bf16 steps and 2 under
   ``torch.profiler`` (step ms, trained tokens/s, busy share, peak
   memory), every loss finite, the held-out loss (batch 999) lower after
   than before, the frozen tensors bit-identical by checksum; (d) the
   trained adapters merged and served by phase 4's engine (K1–K4
   launched, a projection's served ``l`` the trained one and not the
   pass's, the prefill logits within 1e-3 · max|logit| of ``fused="off"``);
   (b) ``--mode full --remat full --batch 32 --seq 128 --lr 6e-4`` at all
   32 layers: 10 timed steps and 2 profiled, finite losses, the last
   below the first, the held-out loss (batch 999) lower after than
   before; (c) reduced phi3 in
   f32, one state on the card and on the CPU, three QPEFT and three full
   steps each: losses within 1e-5 relative, the trained tensors within
   1e-2 of their update's norm.

In a directory that holds this script and nothing else of the
repository it exits 1, without a card 2. The last lines are the nvidia-smi line, one JSON object with a record
per kernel, and ``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py --compare PARENT_ROOT

times phase 3's Q+LR cases (K1 at its main, router and dense lead-in
shapes, K2 at both M = 256 shapes, K1/K2 at the MLA projections, K6 at
all five), its K3, K4 and K5 cases (K5 also at deepseek-moe's KV 16, hd
128; with the dense variants' G = 16 and G = 3, K3's latent rows and
the head-dim-256 K3/K4 rows and K1/K2 at xlstm-125m's shapes where the
tree has them) and K7's at every SRR pass shape,
of the tree at PARENT_ROOT
(an unpacked ``git
archive``) and of this one on one card, in the order parent, change,
change, parent, and prints one line per case
(``build/compare_kernels.json`` holds them); then each turn serves
phase 4's requests (``phase_main_path``) over phi3 with a seeded int8
rank-16 container and prints its decode step ms, tok/s and device busy
ms.
"""
from __future__ import annotations

import atexit
import bisect
import contextlib
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

L2_BYTES = 50e6


T_START = time.perf_counter()


def log(phase: str, msg: str) -> None:
    """One line, after the seconds since the script started (where the
    script's time goes, line by line)."""
    print(f"[{time.perf_counter() - T_START:7.1f} s] [{phase}] {msg}",
          flush=True)


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


def hbm_ms(nbytes: float) -> float:
    """Milliseconds to move ``nbytes`` at the H100's HBM rate
    (``repro_torch.launch.roofline``, the data sheet's peaks)."""
    from repro_torch.launch.roofline import HBM_BW
    return nbytes / HBM_BW * 1e3


def bound_ms(nbytes: float, ops: float, dtype: str) -> tuple[float, str]:
    """The larger of the bytes' time at the HBM rate and the operations'
    at the dense peak for ``dtype`` (bf16 tensor cores, f32 outside them)."""
    from repro_torch.launch.roofline import PEAK_FLOPS_BY_DTYPE
    t_bytes = hbm_ms(nbytes)
    t_ops = ops / PEAK_FLOPS_BY_DTYPE[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bound_of(work, dtype: str) -> tuple[float, str]:
    """``bound_ms`` of a kernel function's ``launch.cost.Work``."""
    return bound_ms(work.bytes, work.flops, dtype)


def tensor_bytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------
def check_qlr(dev, m: int, k: int, n: int, rank: int, packed: bool) -> dict:
    import torch
    from repro_torch.kernels import mxint_matmul as mk
    from repro_torch.launch import cost
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
    work = cost.qlr_work(m, k, n, rank, x_itemsize=x.element_size(),
                         packed=packed)
    b_ms, b_by = bound_of(work, "bfloat16")
    row = dict(name="K1 qlr_fused_matmul" if fused else "K2 qlr_xl_matmul",
               shape=f"M={m} K={k} N={n} r={rank} "
                     f"{'packed4' if packed else 'int8'}",
               max_abs_err=err, tol=tol, ms=t_kernel, host_ms=host,
               plain_ms=t_plain, library_ms=t_lib, bound_ms=b_ms,
               bound_by=b_by, f32_bound_ms=bound_of(work, "float32")[0])
    if not fused:     # K2's time includes the x·L GEMM before its launch
        row["xl_ms"] = time_ms(lambda x_, c_, s_, l_, r_: x_ @ l_, sets)[0]
    return row


def check_decode(dev, kind: str, b=8, kvh=32, s=512, hd=96,
                 ragged: bool = False, g: int = 1, ring: int = 0,
                 first: int = 150) -> dict:
    """K3 over a full cache (every row valid up to slot s - 1) or, with
    ``ragged``, at phase 4's serving occupancy: row i holds first +
    132·i/7 valid slots (150–282; phase "vlm": 406–538, its 256 vision
    rows in front) and the slots past them carry k_pos = -1. ``g``
    query heads a KV head; the yardstick is SDPA over the KV heads
    expanded to the query heads (expanded before it is timed). ``ring``:
    a local layer's wrapped ring of s slots under a window of s, every
    row at q_pos ``ring`` − 1, slot j holding the position p ≡ j (mod s)
    in ``ring`` − s .. ``ring`` − 1 (not in slot order)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as dk
    from repro_torch.launch import cost
    from repro_torch.quant.mxint import pack_codes_4bit, unpack_codes_4bit

    gen = torch.Generator(device=dev).manual_seed(s)
    q = torch.randn((b, kvh, g, hd), generator=gen, device=dev)
    kf = torch.randn((b, kvh, s, hd), generator=gen, device=dev)
    vf = torch.randn((b, kvh, s, hd), generator=gen, device=dev)
    ks = vs = None
    if kind == "bf16":
        k, v = kf.bfloat16(), vf.bfloat16()
    elif kind == "f32":
        k, v = kf, vf
    else:
        qmax = 127 if kind == "int8" else 7
        ks = kf.abs().amax(-1).clamp_min(1e-8) / qmax
        vs = vf.abs().amax(-1).clamp_min(1e-8) / qmax
        k = torch.round(kf / ks[..., None]).clamp(-qmax, qmax).to(torch.int8)
        v = torch.round(vf / vs[..., None]).clamp(-qmax, qmax).to(torch.int8)
        if kind == "int4":
            k, v = pack_codes_4bit(k), pack_codes_4bit(v)
    lengths = [first + (132 * i) // (b - 1) if ragged else s
               for i in range(b)]
    window = s if ring else 0
    if ring:
        j = torch.arange(s, dtype=torch.int32, device=dev)
        k_pos = (j + s * ((ring - 1 - j) // s)).repeat(b, 1)
        q_pos = torch.full((b,), ring - 1, dtype=torch.int32, device=dev)
    else:
        q_pos = torch.tensor(lengths, dtype=torch.int32, device=dev) - 1
        k_pos = torch.arange(s, dtype=torch.int32, device=dev).repeat(b, 1)
        k_pos = torch.where(k_pos <= q_pos[:, None], k_pos, -1)
    ok = (k_pos >= 0) & (k_pos <= q_pos[:, None])
    if window:
        ok &= q_pos[:, None] - k_pos < window
    mask = ok[:, None, None, :]

    def kernel(q_, k_, v_, ks_, vs_):
        return dk.flash_decode(q_, k_, v_, q_pos, k_pos, ks_, vs_, window)

    def plain(q_, k_, v_, ks_, vs_):
        return dk.decode_attention_plain(q_, k_, v_, q_pos, k_pos, ks_, vs_,
                                         window)

    got, want = kernel(q, k, v, ks, vs), plain(q, k, v, ks, vs)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    tol = 1e-4 * max(1.0, float(want.abs().max()))
    # the yardstick: SDPA on the dense (dequantized) cache
    if kind == "bf16":
        kd, vd, qd = k, v, q.bfloat16()
    elif kind == "f32":
        kd, vd, qd = k, v, q
    else:
        kc, vc = (unpack_codes_4bit(k), unpack_codes_4bit(v)) \
            if kind == "int4" else (k, v)
        kd, vd, qd = kc.float() * ks[..., None], vc.float() * vs[..., None], q
    # query heads of a group side by side, each KV head repeated for them
    qd = qd.reshape(b, kvh * g, 1, hd)
    kd, vd = kd.repeat_interleave(g, 1), vd.repeat_interleave(g, 1)
    per_copy = tensor_bytes(k, v, ks, vs)
    n_copies = copies_for(per_copy)
    sets = [(q, k.clone(), v.clone(), None if ks is None else ks.clone(),
             None if vs is None else vs.clone()) for _ in range(n_copies)]
    dense = [(qd, kd.clone(), vd.clone()) for _ in range(n_copies)]
    t_kernel, host = time_ms(kernel, sets)
    t_plain, _ = time_ms(plain, sets)
    t_lib, _ = time_ms(lambda a, b_, c: F.scaled_dot_product_attention(
        a, b_, c, attn_mask=mask if ragged or ring else None), dense)
    # bytes: the K/V rows (and scales) of the valid slots, the positions,
    # q and the output; "walked": every slot of every row
    valid = int(ok.sum())
    kv_itemsize = k.element_size() / (2 if kind == "int4" else 1)
    work = cost.decode_attention_work(b, kvh, g, hd, s, valid=valid,
                                      kv_itemsize=kv_itemsize,
                                      scaled=ks is not None,
                                      q_itemsize=q.element_size())
    b_ms, b_by = bound_of(work, "float32")
    row = dict(name="K3 flash_decode", shape=f"B={b} KV={kvh} G={g} S={s} "
               f"hd={hd} {kind}"
               + (f" rows {first}-{first + 132}" if ragged else "")
               + (f" ring {ring - s}-{ring - 1} window {s}" if ring else ""),
               max_abs_err=err, tol=tol, ms=t_kernel, host_ms=host,
               plain_ms=t_plain, library_ms=t_lib, bound_ms=b_ms,
               bound_by=b_by)
    if ragged:
        row["walked_bound_ms"] = hbm_ms(b * s * cost.decode_slot_bytes(
            kvh, hd, kv_itemsize, ks is not None))
    return row


def check_decode_latent(dev, kind: str, b=8, s=512, h=16, r=512, pe=64,
                        hd=128) -> dict:
    """K3's latent instance at MLA's decode shape (deepseek-v2-lite-16b):
    q (B, 1, H, r + pe) f32 as ``mla_step`` gives it, the latent cache
    (B, S, r + pe) in ``kind`` with every slot valid, K its rows and V
    their first r columns (one tensor), the score scale 1/√(hd + pe). The
    yardstick: SDPA with ``scale=`` and a mask, the KV head expanded to the
    H query heads (expanded before it is timed), Ev = r."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as dk
    from repro_torch.launch import cost

    dt = {"bf16": torch.bfloat16, "f32": torch.float32}[kind]
    gen = torch.Generator(device=dev).manual_seed(s + r)
    q = torch.randn((b, 1, h, r + pe), generator=gen, device=dev)
    lat = torch.randn((b, s, r + pe), generator=gen, device=dev).to(dt)
    q_pos = torch.full((b,), s - 1, dtype=torch.int32, device=dev)
    k_pos = torch.arange(s, dtype=torch.int32, device=dev).repeat(b, 1)
    scale = (hd + pe) ** -0.5

    def kernel(q_, lat_):
        return dk.flash_decode(q_, lat_[:, None], lat_[:, None, :, :r],
                               q_pos, k_pos, scale=scale, latent=True)

    def plain(q_, lat_):
        return dk.decode_attention_plain(q_, lat_[:, None],
                                         lat_[:, None, :, :r], q_pos, k_pos,
                                         scale=scale)

    got, want = kernel(q, lat), plain(q, lat)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    tol = 1e-4 * max(1.0, float(want.abs().max()))
    n_copies = copies_for(tensor_bytes(lat))
    sets = [(q, lat.clone()) for _ in range(n_copies)]
    qd = q.reshape(b, h, 1, r + pe).to(dt)
    mask = (k_pos >= 0)[:, None, None, :]
    dense = [(qd, lat[:, None].expand(b, h, s, r + pe).contiguous(),
              lat[:, None, :, :r].expand(b, h, s, r).contiguous())
             for _ in range(n_copies)]
    t_kernel, host = time_ms(kernel, sets)
    t_plain, _ = time_ms(plain, sets)
    t_lib, _ = time_ms(lambda a, b_, c: F.scaled_dot_product_attention(
        a, b_, c, attn_mask=mask, scale=scale), dense)
    # bytes: each latent row once (V is its first r columns), q, the
    # positions and the f32 output
    b_ms, b_by = bound_of(cost.latent_decode_work(
        b, h, s, r, pe, lat_itemsize=lat.element_size(),
        q_itemsize=q.element_size()), "float32")
    return dict(name="K3 flash_decode",
                shape=f"B={b} KV=1 G={h} S={s} hd={r + pe} dv={r} {kind}",
                max_abs_err=err, tol=tol, ms=t_kernel, host_ms=host,
                plain_ms=t_plain, library_ms=t_lib, bound_ms=b_ms,
                bound_by=b_by)


def check_flash(dev, h=32, s=256, hd=96, g: int = 1, dtype: str = "f32",
                window: int = 0, sk: int = 0, causal: bool = True) -> dict:
    """K4 over a causal prefill of ``s`` tokens: ``h`` query heads, ``g``
    of them a KV head, an optional window; f32 (tolerance 1e-4 of the
    output scale) or bf16 (one bf16 ulp of it). ``causal=False``: ``s``
    queries over ``sk`` keys (``s`` by default), every key valid (the
    encoder's and the cross attention's prefill). The yardstick is SDPA
    with the KV heads expanded to the query heads (expanded before it is
    timed) and, under a window, its boolean mask."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.launch import cost

    dt = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    kvh = h // g
    sk = sk or s
    gen = torch.Generator(device=dev).manual_seed(hd)
    q = torch.randn((1, s, kvh, g, hd), generator=gen, device=dev).to(dt)
    k = torch.randn((1, sk, kvh, hd), generator=gen, device=dev).to(dt)
    v = torch.randn((1, sk, kvh, hd), generator=gen, device=dev).to(dt)
    pos = torch.arange(s, dtype=torch.int32, device=dev)
    k_pos = torch.arange(sk, dtype=torch.int32, device=dev)

    def kernel(q_, k_, v_):
        return fk.flash_attention_cuda(q_, k_, v_, pos, k_pos, causal=causal,
                                       window=window)

    def plain(q_, k_, v_):
        return fk.flash_attention_plain(q_, k_, v_, pos, k_pos, causal=causal,
                                        window=window)

    got, want = kernel(q, k, v), plain(q, k, v)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    tol = (1e-4 if dtype == "f32" else 2 ** -8) \
        * max(1.0, float(want.float().abs().max()))
    n_copies = copies_for(tensor_bytes(q, k, v))
    sets = [(q.clone(), k.clone(), v.clone()) for _ in range(n_copies)]
    heads = [(st[0].reshape(1, s, h, hd).transpose(1, 2).contiguous(),
              *(t.transpose(1, 2).repeat_interleave(g, 1).contiguous()
                for t in st[1:])) for st in sets]
    i = torch.arange(s, device=dev)
    mask = (i[:, None] >= i[None, :]) & (i[:, None] - i[None, :] < window) \
        if window else None
    t_kernel, host = time_ms(kernel, sets)
    t_plain, _ = time_ms(plain, sets)
    t_lib, _ = time_ms(lambda a, b_, c: F.scaled_dot_product_attention(
        a, b_, c, is_causal=causal and mask is None, attn_mask=mask), heads)
    # causal: keys at or before; a window keeps the last ``window`` of them;
    # non-causal: every key
    pairs = cost.attention_pairs(s, sk, causal=causal, window=window)
    b_ms, b_by = bound_of(cost.flash_attention_work(
        s, h, kvh, hd, pairs=pairs, kv_rows=sk, positions=s + sk,
        itemsize=q.element_size()), "float32" if dtype == "f32" else "bfloat16")
    shape = (f"H={h} Sq={s} Sk={sk} hd={hd} non-causal {dtype}"
             if not causal else f"H={h} S={s} hd={hd} causal f32"
             if (g, dtype, window) == (1, "f32", 0) else
             f"H={h} KV={kvh} S={s} hd={hd} causal {dtype}"
             + (f" window {window}" if window else ""))
    return dict(name="K4 flash_attention", shape=shape, max_abs_err=err,
                tol=tol, ms=t_kernel, host_ms=host, plain_ms=t_plain,
                library_ms=t_lib, bound_ms=b_ms, bound_by=b_by)


def check_paged(dev, kind: str, b=8, kvh=32, hd=96, ps=16, nb=32,
                pages=296, g: int = 1) -> dict:
    """K5 on the paged serving shape: a pool of ``pages`` pages, each row
    a shuffled table of ``nb`` distinct pages, ragged positions, ``g``
    query heads a KV head (the note's SDPA over the KV heads expanded)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as dk
    from repro_torch.launch import cost
    from repro_torch.quant.mxint import pack_codes_4bit, unpack_codes_4bit

    gen = torch.Generator(device=dev).manual_seed(pages)
    q = torch.randn((b, kvh, g, hd), generator=gen, device=dev)
    kf = torch.randn((pages, kvh, ps, hd), generator=gen, device=dev)
    vf = torch.randn((pages, kvh, ps, hd), generator=gen, device=dev)
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
    cpu = torch.Generator().manual_seed(1)
    bt = torch.randperm(pages, generator=cpu)[:b * nb].reshape(b, nb) \
        .to(torch.int32).to(dev)
    q_pos = torch.randint(150, 501, (b,), generator=cpu, dtype=torch.int32) \
        .to(dev)
    k_pos = torch.arange(nb * ps, dtype=torch.int32, device=dev).repeat(b, 1)

    def kernel(q_, k_, v_, ks_, vs_):
        return dk.flash_decode_paged(q_, k_, v_, q_pos, k_pos, bt, ks_, vs_)

    def plain(q_, k_, v_, ks_, vs_):
        return dk.decode_attention_paged_plain(q_, k_, v_, q_pos, k_pos, bt,
                                               ks_, vs_)

    def gather_sdpa(q_, k_, v_, ks_, vs_):
        kd, vd = dk.gather_pages(k_, bt), dk.gather_pages(v_, bt)
        if ks_ is not None:
            if kd.dtype == torch.uint8:
                kd, vd = unpack_codes_4bit(kd), unpack_codes_4bit(vd)
            kd = kd.float() * dk.gather_pages(ks_, bt)[..., None]
            vd = vd.float() * dk.gather_pages(vs_, bt)[..., None]
        mask = (k_pos <= q_pos[:, None])[:, None, None, :]
        return F.scaled_dot_product_attention(
            q_.to(kd.dtype).reshape(b, kvh * g, 1, hd),
            kd.repeat_interleave(g, 1), vd.repeat_interleave(g, 1),
            attn_mask=mask)

    got, want = kernel(q, k, v, ks, vs), plain(q, k, v, ks, vs)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    tol = 1e-4 * max(1.0, float(want.abs().max()))
    per_copy = tensor_bytes(k, v, ks, vs)
    sets = [(q, k.clone(), v.clone(), None if ks is None else ks.clone(),
             None if vs is None else vs.clone())
            for _ in range(copies_for(per_copy))]
    t_kernel, host = time_ms(kernel, sets)
    t_plain, _ = time_ms(plain, sets)
    t_note, _ = time_ms(gather_sdpa, sets)
    # the bytes the function needs: the K/V rows (and scales) of every
    # row's valid slots 0..q_pos, its table, positions, q and the output
    valid = int((q_pos + 1).sum())
    kv_itemsize = k.element_size() / (2 if kind == "int4" else 1)
    walked = b * nb * ps * cost.decode_slot_bytes(kvh, hd, kv_itemsize,
                                                  ks is not None)
    b_ms, b_by = bound_of(cost.paged_decode_work(
        b, kvh, g, hd, nb * ps, bt.numel(), valid=valid,
        kv_itemsize=kv_itemsize, scaled=ks is not None,
        q_itemsize=q.element_size()), "float32")
    return dict(name="K5 flash_decode_paged",
                shape=f"B={b} KV={kvh} G={g} hd={hd} ps={ps} nb={nb} "
                      f"P={pages} {kind}",
                max_abs_err=err, tol=tol, ms=t_kernel, host_ms=host,
                plain_ms=t_plain, library_ms=None, bound_ms=b_ms,
                bound_by=b_by, walked_bound_ms=hbm_ms(walked),
                note=f"gather_pages + SDPA on the gathered cache "
                     f"{t_note:.4f} ms")


def check_flash_chunk(dev, h=32, sq=256, ctx=512, start=200, hd=96) -> dict:
    """K4 at the chunked-prefill shape: ``sq`` queries at positions
    [start, start+sq) over [``ctx`` stored slots ‖ the chunk], the
    stored slots at and above ``start`` masked by k_pos = -1."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.launch import cost

    gen = torch.Generator(device=dev).manual_seed(start)
    q = torch.randn((1, sq, h, 1, hd), generator=gen, device=dev)
    k = torch.randn((1, ctx + sq, h, hd), generator=gen, device=dev)
    v = torch.randn((1, ctx + sq, h, hd), generator=gen, device=dev)
    q_pos = torch.arange(start, start + sq, dtype=torch.int32, device=dev)
    slots = torch.arange(ctx, dtype=torch.int32, device=dev)
    k_pos = torch.cat([torch.where(slots < start, slots, -1), q_pos])
    mask = (k_pos[None, :] >= 0) & (q_pos[:, None] >= k_pos[None, :])

    def kernel(q_, k_, v_):
        return fk.flash_attention_cuda(q_, k_, v_, q_pos, k_pos)

    def plain(q_, k_, v_):
        return fk.flash_attention_plain(q_, k_, v_, q_pos, k_pos)

    got, want = kernel(q, k, v), plain(q, k, v)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    tol = 1e-4 * max(1.0, float(want.abs().max()))
    n_copies = copies_for(tensor_bytes(q, k, v))
    sets = [(q.clone(), k.clone(), v.clone()) for _ in range(n_copies)]
    heads = [(a.reshape(1, sq, h, hd).transpose(1, 2).contiguous(),
              b_.transpose(1, 2).contiguous(), c.transpose(1, 2).contiguous())
             for a, b_, c in sets]
    t_kernel, host = time_ms(kernel, sets)
    t_plain, _ = time_ms(plain, sets)
    t_lib, _ = time_ms(lambda a, b_, c: F.scaled_dot_product_attention(
        a, b_, c, attn_mask=mask), heads)
    # bytes: q, out and the K/V rows of the valid keys; ops: the valid
    # (query, key) pairs — start stored keys and the causal chunk
    b_ms, b_by = bound_of(cost.flash_attention_work(
        sq, h, h, hd, pairs=cost.attention_pairs(sq, ctx + sq, start=start),
        kv_rows=start + sq, positions=q_pos.numel() + k_pos.numel()),
        "float32")
    return dict(name="K4 flash_attention", shape=f"H={h} Sq={sq} "
                f"Sk={ctx + sq} start={start} hd={hd} chunk f32",
                max_abs_err=err, tol=tol, ms=t_kernel, host_ms=host,
                plain_ms=t_plain, library_ms=t_lib, bound_ms=b_ms,
                bound_by=b_by)


def routed_counts(e: int, t: int, k: int, seed: int) -> list:
    """Rows of each of ``e`` experts' capacity queues that hold a token
    when ``t`` tokens each pick ``k`` distinct experts uniformly at random
    (seeded): the dropless decode dispatch, capacity ``t``."""
    import torch
    gen = torch.Generator().manual_seed(seed)
    idx = torch.rand((t, e), generator=gen).argsort(dim=-1)[:, :k]
    return torch.bincount(idx.reshape(-1), minlength=e).clamp_max(t).tolist()


def check_qlr_batched(dev, e: int, m: int, k: int, n: int, rank: int,
                      top_k: int = 0) -> dict:
    """K6 over an ``e``-expert int8 stack with ``m`` rows each. With
    ``top_k``, at serving occupancy: ``counts`` from a seeded top-k
    routing of ``m`` tokens, x zero past them (as the dispatch buffer
    is), and the bound over the bytes and operations of the experts and
    rows that hold a token (the library's ``bmm`` on the dense stack
    cannot skip experts without a host sync, so it computes them all)."""
    import torch
    from repro_torch.kernels import mxint_matmul as mk
    from repro_torch.launch import cost
    from repro_torch.quant.mxint import MXIntQuantizer

    gen = torch.Generator(device=dev).manual_seed(e + m + k + n)
    x = torch.randn((e, m, k), generator=gen, device=dev)
    qz = MXIntQuantizer(bits=3).quantize(
        torch.randn((e * k, n), generator=gen, device=dev) * k ** -0.5)
    codes = qz.codes.reshape(e, k, n)
    scale = torch.exp2(qz.exponents.float()).reshape(e, k // 32, n)
    l = torch.randn((e, k, rank), generator=gen, device=dev) * 0.05
    r = torch.randn((e, rank, n), generator=gen, device=dev) * 0.05
    rows = [m] * e
    counts = None
    if top_k:
        rows = routed_counts(e, m, top_k, seed=m)
        counts = torch.tensor(rows, dtype=torch.int32, device=dev)
        past = torch.arange(m, device=dev)[None, :] >= counts[:, None]
        x = x.masked_fill(past[..., None], 0.0)
    got = mk.qlr_batched_matmul_cuda(x, codes, scale, l, r, counts)
    want = mk.qlr_matmul_batched_plain(x, codes, scale, l, r, counts)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if top_k and bool(got[past].any()):
        err = math.inf                 # a row past its count is not zero
    tol = 1e-4 * max(1.0, float(want.abs().max()))
    w_dense = mk.dequant_blockwise(codes, scale, torch.float32) \
        + torch.bmm(l, r)
    sets = [(x, codes.clone(), scale.clone(), l.clone(), r.clone(), counts)
            for _ in range(copies_for(tensor_bytes(codes, scale, l, r)))]
    dense = [(x, w_dense.clone())
             for _ in range(copies_for(tensor_bytes(w_dense)))]
    t_kernel, host = time_ms(mk.qlr_batched_matmul_cuda, sets)
    t_plain, _ = time_ms(mk.qlr_matmul_batched_plain, sets)
    t_lib, _ = time_ms(torch.bmm, dense)
    # bytes: x's rows that hold a token, the codes, scale, L and R of the
    # experts that hold one, the counts, and all of y (zeros included)
    live = sum(1 for c in rows if c > 0)
    work = cost.qlr_batched_work(e, m, k, n, rank, rows=sum(rows), live=live,
                                 x_itemsize=x.element_size(),
                                 counts=counts is not None)
    b_ms, b_by = bound_of(work, "bfloat16")     # as check_qlr's
    shape = f"E={e} M={m} K={k} N={n} r={rank} int8"
    row = dict(name="K6 qlr_batched_matmul",
               shape=shape + (f" top-{top_k} counts ({live} experts, "
                              f"{sum(rows)} rows)" if top_k else ""),
               max_abs_err=err, tol=tol, ms=t_kernel, host_ms=host,
               plain_ms=t_plain, library_ms=t_lib, bound_ms=b_ms,
               bound_by=b_by,
               f32_bound_ms=bound_of(work, "float32")[0])
    if top_k:
        row["note"] = ("library: torch.bmm on the whole dense stack, which "
                       "cannot skip the experts without a token (that would "
                       "need a host sync)")
    return row


def check_quantize(dev, m: int, n: int, bits: int = 3) -> dict:
    """K7 against its plain version, bit for bit (tolerance 0): max_abs_err
    is the largest code or exponent difference. Beside the kernel's time:
    the same-bytes yardstick ``copy_ms`` (an f32 → int8 ``copy_``: 4 bytes
    read and 1 written a weight) and the path its plan takes."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import mxint_quantize as kq
    from repro_torch.launch import cost

    gen = torch.Generator(device=dev).manual_seed(m + n)
    w = torch.randn((m, n), generator=gen, device=dev) * m ** -0.5
    w[:32, :16] = 0.0                          # all-zero blocks
    codes, exps = kq.mxint_quantize_cuda(w, bits)
    want_c, want_e = kq.mxint_quantize_plain(w, bits)
    torch.cuda.synchronize()
    err = max(float((codes.int() - want_c.int()).abs().max()),
              float((exps.int() - want_e.int()).abs().max()))
    sets = [(w.clone(), bits) for _ in range(copies_for(tensor_bytes(w)))]
    t_kernel, host = time_ms(kq.mxint_quantize_cuda, sets)
    t_plain, _ = time_ms(kq.mxint_quantize_plain, sets)
    t_copy, _ = time_ms(lambda w_, b_: torch.empty_like(
        w_, dtype=torch.int8).copy_(w_), sets)
    plan = kq.mxint_quantize_plan(m, n, _build.sm_count(dev.index or 0))
    # one read of w, one write of the codes and of the exponents; per
    # weight an abs, a max, a scaling, a rounding and two clamps
    b_ms, b_by = bound_of(cost.mxint_quantize_work(
        m, n, w_itemsize=w.element_size()), "float32")
    path = {kq.MXINT_PATH_SCALAR: "scalar", kq.MXINT_PATH_REGISTERS:
            "register"}[plan.path]
    return dict(name="K7 mxint_quantize", shape=f"M={m} N={n} bits={bits}",
                max_abs_err=err, tol=0.0, ms=t_kernel, host_ms=host,
                plain_ms=t_plain, library_ms=None, bound_ms=b_ms,
                bound_by=b_by, copy_ms=t_copy,
                path=f"{path} path, grid {plan.grid}×{kq.MXINT_THREADS}",
                note="no single PyTorch call computes MXINT quantization")


# Every distinct matrix shape the SRR pass quantizes: phi3-mini-3.8b
# (attention 3072², gate/up 3072×8192, down 8192×3072), deepseek-moe-16b
# (attention 2048², router 2048×64, expert gate/up and down, shared-expert
# gate/up and down, the dense lead-in layer's), then an N below a
# multiple of 128 and an N that is not a multiple of 4 (the scalar path).
K7_SHAPES = ((3072, 3072), (3072, 8192), (8192, 3072), (2048, 2048),
             (2048, 64), (2048, 1408), (1408, 2048), (2048, 2816),
             (2816, 2048), (2048, 10944), (10944, 2048), (2048, 1000),
             (2048, 1002))
# phase "dense": K3/K5 at chatglm3-6b's group (KV 2, G 16) and
# minitron-4b's (KV 8, G 3), head_dim 128, as (KV, G, cache kind); K1 at
# chatglm's wk/wv and down and, for phase "depth", qwen1.5-32b's gate/up;
# K7 at chatglm's and qwen's down
DENSE_DECODE = ((2, 16, "bf16"), (8, 3, "bf16"), (2, 16, "int8"))
DENSE_QLR = ((4096, 256), (13696, 4096), (5120, 27392))
DENSE_K7 = ((13696, 4096), (27392, 5120))
# phase "mla": the latent cache kinds K3's latent instance is timed at;
# K1 (decode rows) and K2 (prefill rows) at deepseek-v2-lite-16b's MLA
# projections w_q 2048×3072, w_dkv 2048×512, wo 2048×2048 and (prefill
# only: decode folds them into the absorbed einsums) w_uk/w_uv 512×2048;
# K7 at the ones no other phase quantizes
MLA_LATENT_KINDS = ("bf16", "f32")
MLA_QLR = ((8, 2048, 3072), (8, 2048, 512), (8, 2048, 2048),
           (256, 2048, 3072), (256, 2048, 512), (256, 2048, 2048),
           (256, 512, 2048))
MLA_K7 = ((2048, 3072), (2048, 512), (512, 2048))
# phase "hybrid" (recurrentgemma-9b): K3 at the local layers' decode (B=8,
# one KV head, G 16, head dim 256) in the four cache kinds, bf16 at the
# serving rows; K3 on run (b)'s wrapped 2048-slot ring (positions
# 952–2999, q_pos 2999, window 2048); K4 at the local prefill (16 heads
# over one KV head of 256, S 256 f32/bf16, and S 2100 under the window);
# K1 (decode rows) and K2 (prefill rows) at its projections: the RG-LRU
# w_gate/w_branch/w_a/w_x/w_out and the local wq/wo 4096×4096, the MLP's
# gate/up 4096×12288 and down 12288×4096; K7 at those and at wk/wv
# 4096×256
HYBRID_DECODE = (("bf16", True), ("f32", False), ("int8", False),
                 ("int4", False))
HYBRID_RING = 3000
HYBRID_FLASH = ((256, "f32", 0), (256, "bf16", 0), (2100, "f32", 2048))
HYBRID_QLR = ((8, 4096, 4096), (8, 4096, 12288), (8, 12288, 4096),
              (256, 4096, 4096), (256, 4096, 12288), (256, 12288, 4096))
HYBRID_K7 = ((4096, 4096), (4096, 256), (4096, 12288), (12288, 4096))
# phase "xlstm" (xlstm-125m): K1 (decode rows) and K2 (prefill rows) at
# its eight projection shapes, as (K, N, rank): up/up_gate 768×1536,
# wq/wk/wv 1536×1536, w_if 1536×8 at rank 4 (rank_for: N < 32), down
# 1536×768, w_gates 768×3072, w_out 768×768, ffn_up 768×1024, ffn_down
# 1024×768; and the reduced sLSTM FFN's 64×85 (an N the launchers widen
# to 88); K7 at the pass's new shapes
XLSTM_QLR = ((768, 1536, 16), (1536, 1536, 16), (1536, 8, 4),
             (1536, 768, 16), (768, 3072, 16), (768, 768, 16),
             (768, 1024, 16), (1024, 768, 16))
XLSTM_RAGGED = (64, 85, 16)
XLSTM_K7 = ((768, 1536), (1536, 1536), (1536, 8), (1024, 768))
# phase "whisper" (whisper-large-v3, head dim 64, 20 heads over 20 KV
# heads): K4 over the encoder's non-causal 1500 × 1500 and the cross
# prefill's 256 queries × 1500 memory slots (every key valid; 1500 is not
# a multiple of the 64-key tile), f32, and the decoder's causal 256, as
# (Sq, Sk, causal); K3 over the self cache (S 512, bf16 and int8) and over
# the cross memory (S 1500, every slot valid: 47 tiles of 32, the last
# partial; bf16 and f32), as (S, kind); K1 (8 decode rows) and K2 (the
# decoder's 256 prefill rows, the encoder's and the cross wk/wv's 1500)
# at its three projection shapes; K7 at them
WHISPER_FLASH = ((1500, 1500, False), (256, 1500, False), (256, 256, True))
WHISPER_DECODE = ((512, "bf16"), (512, "int8"), (1500, "bf16"),
                  (1500, "f32"))
WHISPER_SHAPES = ((1280, 1280), (1280, 5120), (5120, 1280))
WHISPER_QLR = tuple((m, k, n) for m in (8, 256, 1500)
                    for k, n in WHISPER_SHAPES)
# phase "vlm" (internvl2-2b: 16 query heads over 8 KV heads of 128, G 2):
# its serving cache (576 slots) and prefill width (512 rows: the 256
# vision rows and the prompt padded to 256); K1 (decode rows) and K2 (the
# prefill's rows) at its four projection shapes (wq/wo 2048², wk/wv
# 2048×1024, gate/up 2048×8192, down 8192×2048); K3 at B 8, KV 8, G 2
# over the 576 slots at the serving rows (VLM_ROWS = 150 + 256 to 538
# valid slots); K4 at the causal 512-row prefill; K7 at the four shapes
VLM_MAX_LEN, VLM_PREFILL, VLM_ROWS = 576, 512, 406
VLM_SHAPES = ((2048, 2048), (2048, 1024), (2048, 8192), (8192, 2048))
VLM_QLR = tuple((m, k, n) for m in (8, VLM_PREFILL) for k, n in VLM_SHAPES)


def phase_kernels(dev) -> list:
    rows = []
    for m in (8, 256):                         # decode lanes → K1; prefill → K2
        for k, n in ((3072, 3072), (3072, 8192), (8192, 3072)):
            for packed in (False, True):
                for rank in (16, 0):
                    rows.append(check_qlr(dev, m, k, n, rank, packed))
    # deepseek-moe-16b: the router (N = 64, K1's 64-column tile), the
    # dense lead-in layer (N = 10944; K = 10944 for its down projection)
    for m, k, n in ((8, 2048, 64), (256, 2048, 64), (8, 2048, 10944),
                    (8, 10944, 2048)):
        rows.append(check_qlr(dev, m, k, n, 16, False))
    for kind in ("bf16", "int8", "int4"):
        rows.append(check_decode(dev, kind))
    rows.append(check_decode(dev, "bf16", kvh=16, hd=128))
    rows.append(check_decode(dev, "bf16", ragged=True))
    # the speculative verify chunk (phase "surface"): K1 at M = spec_k = 4
    # rows, K4 at 4 queries over a 512-slot context
    for k, n in ((3072, 3072), (3072, 8192)):
        rows.append(check_qlr(dev, 4, k, n, 16, False))
    rows.append(check_flash(dev))
    rows.append(check_flash(dev, h=16, hd=128))
    rows.append(check_flash_chunk(dev))
    rows.append(check_flash_chunk(dev, sq=4, ctx=512, start=250))
    for kind in ("bf16", "int8", "int4"):
        rows.append(check_paged(dev, kind))
    # K6 at the expert stacks: gate/up (K = 2048) and down (K = 1408),
    # decode (8) and prefill (30) rows, every row computed; then gate/up at
    # decode with the counts of a top-6 routing of the 8 lanes
    for m in (8, 30):
        for k, n in ((2048, 1408), (1408, 2048)):
            rows.append(check_qlr_batched(dev, 64, m, k, n, 16))
    rows.append(check_qlr_batched(dev, 64, 8, 2048, 1408, 16, top_k=6))
    for m, n in K7_SHAPES:
        rows.append(check_quantize(dev, m, n))
    # phase "dense": the wide groups (K3, K5), its projections (K1) and
    # its widest matrices (K7)
    for kvh, g, kind in DENSE_DECODE:
        rows.append(check_decode(dev, kind, kvh=kvh, hd=128, g=g))
        rows.append(check_paged(dev, kind, kvh=kvh, hd=128, g=g))
    for k, n in DENSE_QLR:
        rows.append(check_qlr(dev, 8, k, n, 16, False))
    for m, n in DENSE_K7:
        rows.append(check_quantize(dev, m, n))
    # phase "mla": K3's latent instance (head dim 576, V its first 512
    # columns, G = 16 over one KV head, scale 1/√192), K1/K2 at the MLA
    # projections and K7 at the SRR pass's new shapes
    for kind in MLA_LATENT_KINDS:
        rows.append(check_decode_latent(dev, kind))
    for m, k, n in MLA_QLR:
        rows.append(check_qlr(dev, m, k, n, 16, False))
    for m, n in MLA_K7:
        rows.append(check_quantize(dev, m, n))
    # phase "hybrid": K3 and K4 at head dim 256 (one KV head, G = 16), K3
    # on a wrapped ring, K1/K2/K7 at recurrentgemma-9b's projections
    for kind, ragged in HYBRID_DECODE:
        rows.append(check_decode(dev, kind, kvh=1, hd=256, g=16,
                                 ragged=ragged))
    rows.append(check_decode(dev, "bf16", b=2, kvh=1, s=2048, hd=256, g=16,
                             ring=HYBRID_RING))
    for s_len, dtype, window in HYBRID_FLASH:
        rows.append(check_flash(dev, h=16, s=s_len, hd=256, g=16,
                                dtype=dtype, window=window))
    for m, k, n in HYBRID_QLR:
        rows.append(check_qlr(dev, m, k, n, 16, False))
    for m, n in HYBRID_K7:
        rows.append(check_quantize(dev, m, n))
    # phase "xlstm": K1/K2 at xlstm-125m's projections (w_if at rank 4, 8
    # columns), at an N that is not a multiple of 4, and K7 at its matrices
    for m in (8, 256):
        for k, n, rank in XLSTM_QLR + (XLSTM_RAGGED,):
            rows.append(check_qlr(dev, m, k, n, rank, False))
    for m, n in XLSTM_K7:
        rows.append(check_quantize(dev, m, n))
    rows += phase_kernels_whisper(dev)
    rows += phase_kernels_vlm(dev)
    for r in rows:
        lib = (f"library {r['library_ms']:.4f} ms"
               if r["library_ms"] is not None else f"[{r['note']}]")
        log("kernels", f"{r['name']:22s} {r['shape']:34s} err {r['max_abs_err']:.3e} "
            f"(tol {r['tol']:.1e}) kernel {r['ms']:.4f} ms (host "
            f"{r['host_ms']:.4f} ms/call) plain "
            f"{r['plain_ms']:.4f} ms {lib} bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']})"
            + (f", pages walked {r['walked_bound_ms']:.4f} ms"
               if "walked_bound_ms" in r else "")
            + (f", f32 bound {r['f32_bound_ms']:.4f} ms"
               if "f32_bound_ms" in r else "")
            + (f", x·L GEMM {r['xl_ms']:.4f} ms" if "xl_ms" in r else "")
            + (f", copy_ {r['copy_ms']:.4f} ms, {r['path']}"
               if "copy_ms" in r else "")
            + (f" [{r['note']}]" if "note" in r and r["library_ms"] is not None
               else ""))
    bad = [r for r in rows if not r["max_abs_err"] <= r["tol"]]
    require(not bad, f"kernels disagree with their plain versions: {bad}")
    return rows


def phase_kernels_whisper(dev) -> list:
    """Phase 3's cases at whisper-large-v3's shapes: K4 non-causal and
    causal at head dim 64, K3 at hd 64 over the self cache and the cross
    memory, K1/K2 and K7 at its projections."""
    rows = []
    for sq, sk, causal in WHISPER_FLASH:
        rows.append(check_flash(dev, h=20, s=sq, hd=64, sk=sk,
                                causal=causal))
    for s_len, kind in WHISPER_DECODE:
        rows.append(check_decode(dev, kind, kvh=20, s=s_len, hd=64))
    for m, k, n in WHISPER_QLR:
        rows.append(check_qlr(dev, m, k, n, 16, False))
    for m, n in WHISPER_SHAPES:
        rows.append(check_quantize(dev, m, n))
    return rows


def phase_kernels_vlm(dev) -> list:
    """Phase 3's cases at internvl2-2b's shapes: K1/K2 at its projections
    (8 decode rows, the 512-row prefill), K3 at G 2 over its serving
    cache, K4 at its prefill, K7 at its matrices."""
    rows = [check_qlr(dev, m, k, n, 16, False) for m, k, n in VLM_QLR]
    rows.append(check_decode(dev, "bf16", kvh=8, s=VLM_MAX_LEN, hd=128, g=2,
                             ragged=True, first=VLM_ROWS))
    rows.append(check_flash(dev, h=16, s=VLM_PREFILL, hd=128, g=2))
    rows += [check_quantize(dev, m, n) for m, n in VLM_SHAPES]
    return rows


# ---------------------------------------------------------------------------
# phases 4 and 5: the serving path
# ---------------------------------------------------------------------------
def launch_counts() -> dict:
    from repro_torch.kernels import decode_attention, flash_attention, \
        mxint_matmul, mxint_quantize
    return {"K1": mxint_matmul.LAUNCHES["qlr_fused"],
            "K2": mxint_matmul.LAUNCHES["qlr"],
            "K3": decode_attention.LAUNCHES["flash_decode"],
            "K4": flash_attention.LAUNCHES["flash_attention"],
            "K5": decode_attention.LAUNCHES["flash_decode_paged"],
            "K6": mxint_matmul.LAUNCHES["qlr_batched"],
            "K7": mxint_quantize.LAUNCHES["mxint_quantize"]}


def reset_counts() -> None:
    from repro_torch.kernels import decode_attention, flash_attention, \
        mxint_matmul, mxint_quantize
    for mod in (mxint_matmul, decode_attention, flash_attention,
                mxint_quantize):
        for key in mod.LAUNCHES:
            mod.LAUNCHES[key] = 0
    mxint_quantize.LAUNCH_SHAPES.clear()


def prefill_work(eng) -> tuple:
    """(admissions, prefill chunks) so far: a step that changes neither
    only decoded. Read from the counters themselves: ``stats()`` builds
    the whole registry snapshot."""
    return eng.sched.stats.admitted, getattr(eng, "_prefill_chunks", 0)


def serve(eng, reqs) -> tuple[list, list, float]:
    """Submit every request and step the engine to the end; returns
    (results, seconds of the steps that only decoded, wall seconds)."""
    t0 = time.perf_counter()
    for r in reqs:
        r.t_submit = t0
        eng.submit(r)
    results, decode_steps = [], []
    while eng.sched.has_work:
        before = prefill_work(eng)
        ts = time.perf_counter()
        results.extend(eng.step())          # ends in a device → host copy
        took = time.perf_counter() - ts
        if prefill_work(eng) == before:
            decode_steps.append(took)
    return sorted(results, key=lambda r: r.uid), decode_steps, \
        time.perf_counter() - t0


def profile_decode(eng, cfg, reqs, n_steps: int = 4,
                   tag: str = "profile") -> dict:
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
    log(tag, f"{n_steps} decode steps under torch.profiler: "
        f"{1e3 * wall / n_steps:.2f} ms/step wall, device busy "
        f"{sum(dev_us.values()) / n_steps / 1e3:.2f} ms/step "
        f"({100 * busy:.1f}% busy, {100 * (1 - busy):.1f}% idle)")
    # K1/K2 (qlr_tc_kernel) and K6 (qlr_stacked_kernel) run alone; the
    # finishing kernel and the x·L bmm of the first K6 must not appear
    for kname in ("qlr_tc_kernel", "qlr_stacked_kernel", "qlr_finish_kernel",
                  "flash_decode_kernel", "decode_combine_kernel",
                  "flash_attention_kernel"):
        us = sum(v for k_, v in dev_us.items() if kname in k_)
        log(tag, f"  {kname}: {us / n_steps / 1e3:.3f} ms/step")
    bmm_calls = sum(e.count for e in prof.key_averages()
                    if e.key == "aten::bmm")
    log(tag, f"  aten::bmm calls: {bmm_calls / n_steps:.1f} a step")
    top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:10]
    for key, us in top:
        log(tag, f"  {us / n_steps / 1e3:8.3f} ms/step  {key[:90]}")
    return dict(wall_ms=1e3 * wall / n_steps, busy=busy,
                device_ms=sum(dev_us.values()) / n_steps / 1e3,
                decode_ms=sum(v for k_, v in dev_us.items()
                              if "flash_decode_kernel" in k_) / n_steps / 1e3,
                qlr_ms=sum(v for k_, v in dev_us.items()
                           if "qlr_tc_kernel" in k_) / n_steps / 1e3,
                stacked_ms=sum(v for k_, v in dev_us.items()
                               if "qlr_stacked_kernel" in k_) / n_steps / 1e3,
                bmm_calls=bmm_calls,
                finish_ms=sum(v for k_, v in dev_us.items()
                              if "qlr_finish_kernel" in k_) / n_steps / 1e3,
                combine_ms=sum(v for k_, v in dev_us.items()
                               if "decode_combine_kernel" in k_)
                / n_steps / 1e3,
                top=[(key, us / n_steps / 1e3) for key, us in top])


# the SRR stages' torch.profiler ranges (core/srr.py, quant/mxint.py)
SRR_STAGES = ("srr.", "mxint.")


def profile_srr(dev, cfg, tag: str, t_pass: float, reports,
                k7_ms=None) -> dict:
    """Where an SRR pass's time goes, read apart from the timed pass and
    after serving: ``cfg`` cut to its first two layers (``init_lm`` seed
    0; the same matrix shapes as the full model's first two layers) is
    calibrated, its scalings built (timed apart: ``srr.scaling``'s work),
    then quantized as the timed pass quantizes (qera-exact) under
    torch.profiler. Logs and returns the device time by stage (the
    ranges ``srr.scaling`` — here only the lookup of the S built ahead —,
    ``srr.select_rank``, ``srr.svd_factors``, ``mxint.quantize`` — K7 and
    the row pad —, ``mxint.dequantize``; a kernel counts to the range
    whose span on the device timeline holds it) and by kernel, the
    device's busy share, the host ms a matrix profiled and, from the
    timed pass (``t_pass``, ``reports``), unprofiled, and K7's device
    total over the timed pass from its launches × phase 3's time at each
    shape (``k7_ms``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import init_lm
    from repro_torch.models.quantize import quantize_model_params

    cut = dataclasses.replace(cfg, n_layers=2)
    model = init_lm(cut, 0, device=dev)
    stats, _ = calibrate(dev, cut, model, tag)
    # S is built ahead, outside the window: torch.profiler slows cuSOLVER's
    # eigh by orders of magnitude on an H100 (phi3's two layers: 1.6 s
    # outside the window, unfinished after 20 minutes inside it)
    scaling_s = build_scalings(stats)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, window = quantize_model_params(
            model, srr_ptq(),
            container="int8", stats=stats, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    del model
    n = len(window)
    cuda = torch.autograd.DeviceType.CUDA
    # kernels, memcpys and memsets; a range's own span on the device
    # timeline (a user annotation) is not device work
    kernels = {e.key: e.self_device_time_total for e in prof.key_averages()
               if e.device_type == cuda and e.self_device_time_total > 0
               and not e.key.startswith(SRR_STAGES)}
    busy_ms = sum(kernels.values()) / 1e3
    # the stream runs one kernel at a time, so a range's device span holds
    # its kernels and no other range's
    spans = sorted((e.time_range.start, e.time_range.end, e.key)
                   for e in prof.events() if e.device_type == cuda
                   and e.key.startswith(SRR_STAGES))
    starts = [sp[0] for sp in spans]
    by_stage = {key: 0.0 for _, _, key in spans}
    for e in prof.events():
        if e.device_type != cuda or e.key.startswith(SRR_STAGES):
            continue
        j = bisect.bisect_right(starts, e.time_range.start) - 1
        if j >= 0 and e.time_range.start < spans[j][1]:
            by_stage[spans[j][2]] += e.time_range.elapsed_us() / 1e3
    rest = busy_ms - sum(by_stage.values())
    log(tag, f"SRR pass of the first two layers under torch.profiler: {n} "
        f"matrices in {wall:.3f} s ({1e3 * wall / n:.2f} ms a matrix on "
        f"the host clock; the timed pass, unprofiled: "
        f"{1e3 * t_pass / len(reports):.2f} ms a matrix); device busy "
        f"{busy_ms:.1f} ms ({100 * busy_ms / (1e3 * wall):.1f}% busy, "
        f"{100 - 100 * busy_ms / (1e3 * wall):.1f}% idle)")
    log(tag, f"  {'srr.scaling (ahead)':22s} {1e3 * scaling_s:9.3f} ms wall, "
        f"synchronized, outside the window (the eigh of every moment set)")
    for key, ms in sorted(by_stage.items(), key=lambda kv: -kv[1]):
        log(tag, f"  {key:22s} {ms:9.3f} ms device "
            f"({1e3 * ms / n:.1f} us a matrix)")
    log(tag, f"  {'other':22s} {rest:9.3f} ms device")
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
    for key, us in top:
        log(tag, f"  {us / 1e3:9.3f} ms  {key[:90]}")
    k7_window = sum(us for k_, us in kernels.items()
                    if "mxint_quantize_kernel" in k_) / 1e3
    k7_pass = k7_pass_ms(reports, k7_ms)
    log(tag, f"  K7 in the profiled pass {k7_window:.3f} ms device; over "
        f"the timed pass " + ("not measured" if k7_pass is None else
                              f"{k7_pass:.1f} ms (launches × phase-3 time "
                              f"at each shape)")
        + f" of {t_pass:.2f} s")
    return dict(matrices=n, wall_s=wall, scaling_s=scaling_s,
                host_ms_matrix=1e3 * wall / n,
                timed_host_ms_matrix=1e3 * t_pass / len(reports),
                busy_ms=busy_ms, busy=busy_ms / (1e3 * wall),
                by_stage=by_stage, other_ms=rest, k7_window_ms=k7_window,
                k7_pass_ms=k7_pass, top=[(k_, us / 1e3) for k_, us in top])


def k7_pass_ms(reports, k7_ms) -> float | None:
    """K7's device time over an SRR pass: two launches a matrix (the
    residual's fake-quant and the stored codes) at its row-padded shape,
    each at phase 3's time for that shape; None if phase 3 lacks one."""
    from collections import Counter
    shapes = Counter((-(-r.shape[0] // 32) * 32, r.shape[1]) for r in reports)
    if k7_ms is None or any(sh not in k7_ms for sh in shapes):
        return None
    return sum(2 * count * k7_ms[sh] for sh, count in shapes.items())


# calibration of the full-width paths: 4 batches of 8 × 256 tokens (seed
# 0), 8,192 rows, at least phi3's widest projection input (d_ff 8,192),
# so Σxxᵀ is not rank-deficient by construction
CALIB_BATCHES, CALIB_BATCH, CALIB_SEQ = 4, 8, 256


def srr_ptq(**kw):
    """Phase 4's pass configuration (qera-exact SRR, rank 16, 3-bit MXINT
    in blocks of 32, seed 0), with ``kw`` replacing any of it."""
    from repro_torch.core.api import PTQConfig
    from repro_torch.quant import QuantizerConfig
    return PTQConfig(**dict(dict(
        method="srr", scaling="qera-exact",
        quantizer=QuantizerConfig(kind="mxint", bits=3, block_size=32),
        rank=16, seed=0), **kw))


def calibrate(dev, cfg, model, tag: str) -> tuple:
    """``capture_calibration`` of ``model`` over the calibration batches
    through ``lm_loss``; returns (stats, seconds)."""
    import torch
    from repro_torch.data import capture_calibration, data_config_for
    from repro_torch.models import lm_loss

    dcfg = data_config_for(cfg, seq_len=CALIB_SEQ, global_batch=CALIB_BATCH,
                           seed=0)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    stats = capture_calibration(model, dcfg, lm_loss, n_batches=CALIB_BATCHES,
                                device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    took = time.perf_counter() - t0
    distinct = {id(v): v for v in stats.values()}
    log(tag, f"calibrated on {dev.type}: {CALIB_BATCHES} batches of "
        f"{CALIB_BATCH} × {CALIB_SEQ} tokens in {took:.2f} s; {len(stats)} "
        f"tap names, {len(distinct)} distinct moment sets, Σxxᵀ "
        f"{sum(v.autocorr.numel() * 4 for v in distinct.values()) / 2**30:.2f}"
        f" GiB")
    return stats, took


def build_scalings(stats) -> float:
    """Build every distinct moment set's qera-exact S (an ``eigh`` each),
    which the pass then finds built; returns the synchronized seconds."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for st in {id(v): v for v in stats.values()}.values():
        st.scaling("qera-exact")
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def quantized_model(dev, cfg):
    """``init_lm`` (seed 0) → calibration → qera-exact SRR PTQ (rank 16,
    3-bit MXINT, int8 container): the model phases 4 and 4b share, with
    the pass's seconds and reports. The scalings are built before the
    pass and timed apart (``build_scalings``)."""
    import torch
    from repro_torch.models import init_lm
    from repro_torch.models.quantize import quantize_model_params

    gib = 2.0 ** 30
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = init_lm(cfg, 0, device=dev)
    torch.cuda.synchronize()
    log("main", f"init_lm {cfg.name}: {cfg.n_layers} layers d_model "
        f"{cfg.d_model} heads {cfg.n_heads} head_dim {cfg.head_dim_} d_ff "
        f"{cfg.d_ff} vocab {cfg.vocab} in {time.perf_counter() - t0:.2f} s")
    stats, t_calib = calibrate(dev, cfg, model, "main")
    t_scaling = build_scalings(stats)
    t0 = time.perf_counter()
    model, reports = quantize_model_params(
        model, srr_ptq(), container="int8", stats=stats, device=dev)
    torch.cuda.synchronize()
    t_quant = time.perf_counter() - t0
    require(not stats, "the pass left calibration statistics behind")
    peak = torch.cuda.max_memory_allocated() / gib
    mean_k = sum(r.k_star for r in reports) / len(reports)
    log("main", f"qera-exact scalings built in {t_scaling:.2f} s; SRR "
        f"quantized {len(reports)} matrices in {t_quant:.2f} s (rank 16, "
        f"3-bit MXINT b32, mean k* {mean_k:.2f}, mean scaled error "
        f"{sum(r.scaled_err for r in reports) / len(reports):.4f}); peak "
        f"memory of init + calibration + PTQ {peak:.2f} GiB")
    return model, t_quant, reports, dict(calibration_s=t_calib,
                                         scaling_s=t_scaling, peak_gib=peak,
                                         mean_k=mean_k)


MAIN_LENGTHS = [150 + (100 * i) // 7 for i in range(8)]   # phase 4's prompts


def main_serve_config(**kw):
    """Phase 4's ``ServeConfig`` (8 lanes, bf16 KV, 32 new tokens)."""
    from repro_torch.serve import ServeConfig
    return ServeConfig(**dict(dict(max_len=512, decode_batch=8,
                                   prefill_len=256, kv_dtype="bf16",
                                   fused="auto", max_new_tokens=32), **kw))


def paged_serve_config(**kw):
    """Phase 4b's: pages of 16, chunks of 256, a 520-token step budget."""
    return main_serve_config(paged=True, page_size=16, max_step_tokens=520,
                             **kw)


def phase_main_path(dev, cfg, model) -> dict:
    import torch
    from repro_torch.launch.serve import make_requests
    from repro_torch.models import Ctx, init_cache, prefill
    from repro_torch.serve import Engine

    sc = main_serve_config()
    eng = Engine(model, cfg, sc, device=dev)
    lengths = MAIN_LENGTHS
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
    require(all(counts[k] > 0 for k in ("K1", "K2", "K3", "K4")),
            f"a kernel of the path never launched: {counts}")

    prof = profile_decode(eng, cfg, make_requests(cfg, 8, seed=4,
                                                  lengths=lengths))

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
    del eng
    torch.cuda.empty_cache()
    return dict(counts=counts, tok_s=n_tok / wall, step_ms=step_ms,
                ttft_ms=[1e3 * t for t in ttft], profile=prof,
                tokens=[r.tokens.tolist() for r in results])


def shared_prefix_requests(cfg, n: int, seed: int) -> list:
    """``n`` prompts: one shared 256-token prefix (seed 5) and a tail of
    40–150 tokens of their own (``seed``), so 296–406 tokens each."""
    import numpy as np
    from repro_torch.serve import Request

    head = np.random.default_rng(5).integers(0, cfg.vocab, 256)
    rng = np.random.default_rng(seed)
    return [Request(uid=i, prompt=np.concatenate(
        [head, rng.integers(0, cfg.vocab, int(rng.integers(40, 151)))])
        .astype(np.int32)) for i in range(n)]


def phase_paged(dev, cfg, model, unpaged_step_ms: float) -> dict:
    import numpy as np
    import torch
    from repro_torch.models import Ctx, init_cache, prefill, prefill_chunk
    from repro_torch.serve import Engine
    from repro_torch.serve.pages import set_block_table_row

    sc = paged_serve_config()
    serve(Engine(model, cfg, sc, device=dev),
          shared_prefix_requests(cfg, 2, seed=7))            # warm-up
    eng = Engine(model, cfg, sc, device=dev)
    reqs = shared_prefix_requests(cfg, 16, seed=6)
    reset_counts()
    results, steps, wall = serve(eng, reqs)
    counts = launch_counts()
    st = eng.stats()
    n_tok = sum(len(r.tokens) for r in results)
    ttft = [r.ttft_s for r in results]
    step_ms = 1e3 * sum(steps) / len(steps)
    log("paged", f"served {len(results)} requests (prompts "
        f"{min(len(r.prompt) for r in reqs)}–{max(len(r.prompt) for r in reqs)}"
        f" tokens, shared 256-token prefix), {n_tok} tokens in {wall:.3f} s: "
        f"{n_tok / wall:.1f} tok/s; TTFT first {1e3 * min(ttft):.1f} ms mean "
        f"{1e3 * sum(ttft) / len(ttft):.1f} ms max {1e3 * max(ttft):.1f} ms; "
        f"decode step {step_ms:.2f} ms over {len(steps)} decode-only steps "
        f"(unpaged phase 4: {unpaged_step_ms:.2f} ms)")
    log("paged", f"{st['prefill_chunks']} chunks, "
        f"{st['prefill_tokens_computed']}/{st['prompt_tokens_total']} prompt "
        f"tokens computed, prefix hit tokens {st['prefix_hit_tokens']} (hit "
        f"rate {st['prefix_hit_rate']:.4f}), budget-capped chunks "
        f"{st['budget_capped_chunks']}, deferred admissions "
        f"{st['budget_deferred_admissions']}, pages hot/total "
        f"{st['pages_hot']}/{st['pages_total']}")
    log("paged", f"kernel launches in the run: {counts}")
    require(len(results) == 16 and all(len(r.tokens) == 32 for r in results),
            f"expected 16 requests × 32 tokens, got "
            f"{[len(r.tokens) for r in results]}")
    require(all(0 <= t < cfg.vocab for r in results for t in r.tokens),
            "a token outside the vocabulary")
    require(all(counts[k] > 0 for k in ("K1", "K2", "K4", "K5")),
            f"a kernel of the paged path never launched: {counts}")
    require(counts["K3"] == 0, f"paged decode went through K3: {counts}")
    require(st["prefix_hit_tokens"] > 0
            and st["prefill_tokens_computed"] < st["prompt_tokens_total"],
            "the prefix cache served no prompt token")
    require(st["pages_hot"] == sc.decode_batch,
            f"{st['pages_hot']} pages hot after draining, expected only the "
            f"{sc.decode_batch} parked pages")
    del eng

    # a 300-token prompt in two chunks (256 + 44) over a paged f32 cache
    # against the unpaged one-shot prefill, and against fused="off"
    prompt = np.random.default_rng(8).integers(0, cfg.vocab, 300)
    tokens = torch.from_numpy(prompt).long()[None].to(dev)
    n = torch.tensor([300], dtype=torch.int32, device=dev)
    logit = {"unpaged": prefill(Ctx(), model, tokens,
                                init_cache(cfg, 1, 512, torch.float32, dev),
                                lengths=n)[0].float()}
    for fused in ("auto", "off"):
        cache = init_cache(cfg, 1, 512, torch.float32, dev, pages=32,
                           page_size=16)
        set_block_table_row(cache, 0, torch.arange(32, dtype=torch.int32,
                                                   device=dev), 0)
        for start, length in ((0, 256), (256, 44)):
            chunk = torch.zeros((1, 256), dtype=torch.int64, device=dev)
            chunk[0, :length] = tokens[0, start:start + length]
            lg, cache = prefill_chunk(Ctx(fused=fused), model, chunk, cache,
                                      0, start, length)
        logit[fused] = lg.float()
        del cache
    scale = float(logit["unpaged"].abs().max())
    err_unpaged = float((logit["auto"] - logit["unpaged"]).abs().max())
    err_off = float((logit["auto"] - logit["off"]).abs().max())
    require(bool(torch.isfinite(logit["auto"]).all()), "non-finite logits")
    log("paged", f"300-token prompt, paged chunks 256 + 44 (kernels) vs "
        f"unpaged one-shot prefill: max |Δ| {err_unpaged:.3e}; vs fused=off: "
        f"max |Δ| {err_off:.3e} (max |logit| {scale:.3f}, tol "
        f"{1e-3 * scale:.3e})")
    require(err_unpaged <= 1e-3 * max(1.0, scale),
            "paged chunks disagree with the unpaged prefill")
    require(err_off <= 1e-3 * max(1.0, scale),
            "paged chunks through the kernels disagree with fused=off")
    torch.cuda.empty_cache()
    return dict(counts=counts, tok_s=n_tok / wall, step_ms=step_ms,
                ttft_ms=[1e3 * t for t in ttft],
                prefix_hit_rate=st["prefix_hit_rate"],
                prefill_chunks=st["prefill_chunks"],
                prefill_tokens_computed=st["prefill_tokens_computed"],
                prompt_tokens_total=st["prompt_tokens_total"],
                logit_err_unpaged=err_unpaged, logit_err_off=err_off,
                tokens=[r.tokens.tolist() for r in results])


# ---------------------------------------------------------------------------
# phase "surface": sampling, stop ids, logprobs, abort, speculative decoding
# ---------------------------------------------------------------------------
# (temperature, top_p, top_k) of the 8 lanes: greedy, T 0.7, top-p 0.9,
# top-k 40 and combinations
SPEC_PAGED_REQUESTS = 8       # "surface" (d): the first 8 of phase 4b's 16
# "surface" (c)'s one-lane run, spec off and on: the first 2 of phase 4's
# prompts (it was 4; cut to make room for phase "depth")
SPEC_ONE_LANE_REQUESTS = 2
SURFACE_LANES = [(0.0, 1.0, 0), (0.7, 1.0, 0), (0.7, 0.9, 0), (0.7, 1.0, 40),
                 (0.7, 0.9, 40), (1.0, 0.9, 40), (0.0, 0.9, 40),
                 (1.3, 0.5, 5)]


def check_sampler(dev, model, cfg, tag: str = "surface") -> dict:
    """``sample_tokens`` on the card against the same function on the CPU
    over the logits (8, V) of one real decode step, and the threefry bits
    of 8 seeds × 4 indices × V, bit for bit across the two devices."""
    import numpy as np
    import torch
    from repro_torch.models import Ctx, decode_step, init_cache, prefill
    from repro_torch.serve import prng
    from repro_torch.serve.sampling import sample_tokens

    b, length = 8, 64
    rng = np.random.default_rng(3)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (b, length))).to(dev)
    cache = init_cache(cfg, b, 128, torch.bfloat16, dev)
    logits, cache = prefill(Ctx(), model, tokens, cache)
    logits, _ = decode_step(Ctx(), model, logits[:, -1].argmax(-1)[:, None],
                            cache)
    lg = logits[:, -1].float().contiguous()
    del cache
    temps, top_ps, top_ks = (np.array(c, dt) for c, dt in zip(
        zip(*SURFACE_LANES), (np.float32, np.float32, np.int32)))
    seeds = rng.integers(0, 2 ** 31 - 1, b).astype(np.int32)
    idxs = rng.integers(0, 10 ** 6, b).astype(np.int32)
    lanes = (temps, top_ps, top_ks, seeds, idxs)
    got = sample_tokens(lg, *lanes).tolist()
    want = sample_tokens(lg.cpu(), *lanes).tolist()
    # every (seed, index) pair of 8 seeds × 4 indices: 32 keys, V bits each
    s = torch.tensor(np.repeat(seeds, 4), dtype=torch.int32)
    i = torch.tensor(np.tile([0, 1, 31, 10 ** 6], b))
    bits_cpu = prng.random_bits(prng.fold_in(prng.prng_key(s), i), cfg.vocab)
    bits_dev = prng.random_bits(prng.fold_in(prng.prng_key(s.to(dev)),
                                             i.to(dev)), cfg.vocab).cpu()
    unif_cpu = prng.uniform(prng.fold_in(prng.prng_key(s), i), cfg.vocab)
    unif_dev = prng.uniform(prng.fold_in(prng.prng_key(s.to(dev)), i.to(dev)),
                            cfg.vocab).cpu()
    mixed = host_bound_ms(lambda: sample_tokens(lg, *lanes))
    greedy = host_bound_ms(lambda: sample_tokens(
        lg, np.zeros(b, np.float32), *lanes[1:]))
    out = dict(tokens_card=got, tokens_cpu=want,
               bits_equal=bool(torch.equal(bits_cpu, bits_dev)),
               uniforms_equal=bool(torch.equal(unif_cpu.view(torch.int32),
                                               unif_dev.view(torch.int32))),
               n_bits=bits_cpu.numel(), mixed=mixed, greedy=greedy)
    log(tag, f"sampler over logits {tuple(lg.shape)} of a decode step: "
        f"card tokens {got}, CPU tokens {want}; threefry bits of 8 seeds × 4 "
        f"indices × {cfg.vocab} equal across devices: {out['bits_equal']} "
        f"(uniforms {out['uniforms_equal']}); a call, mixed lanes: "
        f"{mixed['wall_ms']:.4f} ms wall, {mixed['device_ms']:.4f} ms "
        f"device, {mixed['launches']:.0f} launches; all greedy: "
        f"{greedy['wall_ms']:.4f} ms wall, {greedy['device_ms']:.4f} ms "
        f"device, {greedy['launches']:.0f} launches")
    require(got == want, f"sampled tokens differ between card and CPU: "
            f"{got} vs {want}")
    require(out["bits_equal"] and out["uniforms_equal"],
            "threefry bits or uniforms differ between card and CPU")
    return out


def host_bound_ms(fn, n: int = 20) -> dict:
    """A host-heavy function's cost a call, warm: the wall of ``n`` calls
    back to back ending in a synchronize (the host's enqueue and the
    device's tail), and from ``torch.profiler`` over ``n`` more calls the
    device time and kernel launches. (``time_ms``'s enqueue behind a
    sleep kernel does not fit a function that allocates pinned memory:
    no pinned block frees while the card sleeps.)"""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / n
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    ev = prof.key_averages()
    dev_us = sum(getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0)) for e in ev)
    launches = sum(e.count for e in ev
                   if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                "cudaLaunchKernelExC"))
    return dict(wall_ms=1e3 * wall, device_ms=dev_us / 1e3 / n,
                launches=launches / n)


def top2_gap(dev, cfg, model, prompt, tokens, pos: int,
             frames=None) -> float:
    """Gap between the two largest logits after ``prompt`` and the first
    ``pos`` generated ``tokens``, from a one-shot unpaged prefill (an
    encoder-decoder's over ``frames``, (1, enc_seq, d_frontend))."""
    import numpy as np
    import torch
    from repro_torch.models import Ctx, init_cache, prefill

    seq = np.concatenate([prompt, np.asarray(tokens[:pos], np.int32)])
    t = torch.from_numpy(seq).long()[None].to(dev)
    n = torch.tensor([len(seq)], dtype=torch.int32, device=dev)
    logits, _ = prefill(Ctx(), model, t, init_cache(cfg, 1, 512,
                                                    torch.bfloat16, dev),
                        lengths=n, frames=frames)
    top = torch.topk(logits[0, 0].float(), 2).values
    return float(top[0] - top[1])


def hold_tokens(dev, cfg, model, reqs, got, want, what: str) -> int:
    """Count the requests whose tokens differ; for each, print its first
    divergent position and the spec-off top-2 logit gap there."""
    bad = 0
    for r, g, w in zip(reqs, got, want):
        if g == w:
            continue
        bad += 1
        pos = next((j for j, (x, y) in enumerate(zip(g, w)) if x != y),
                   min(len(g), len(w)))
        log("surface", f"{what}: request {r.uid} diverges at token {pos} "
            f"({g[pos:pos + 3]} vs {w[pos:pos + 3]}); spec-off top-2 logit "
            f"gap there {top2_gap(dev, cfg, model, r.prompt, w, pos):.3e}")
    return bad


def _hist_line(h: dict) -> str:
    """A registry histogram's summary on one line."""
    if not h["count"]:
        return "count 0"
    return (f"count {h['count']} sum {h['sum']:.6g} min {h['min']:.6g} "
            f"p50 {h['p50']:.6g} max {h['max']:.6g}")


def serve_rounds(eng, reqs) -> tuple:
    """``serve`` that also times the engine steps that ran a speculative
    round and admitted nothing: (results, round seconds, wall seconds)."""
    t0 = time.perf_counter()
    for r in reqs:
        r.t_submit = t0
        eng.submit(r)
    results, rounds = [], []
    while eng.sched.has_work:
        before = prefill_work(eng), eng._spec_rounds
        ts = time.perf_counter()
        results.extend(eng.step())
        took = time.perf_counter() - ts
        if prefill_work(eng) == before[0] and eng._spec_rounds > before[1]:
            rounds.append(took)
    return sorted(results, key=lambda r: r.uid), rounds, \
        time.perf_counter() - t0


def phase_surface(dev, cfg, model, main_run: dict, paged_run: dict) -> dict:
    """Phase "surface" on phase 4's quantized model: (a) the sampler on the
    card against the CPU; (b) sampled serving with logprobs, a stop id and
    an abort; (c) speculative serving over the unpaged cache against
    phase 4's tokens, then at 1 lane spec on and off; (d) speculative
    serving over the paged cache against phase 4b's tokens."""
    import numpy as np
    import torch
    from repro_torch.launch.serve import make_requests
    from repro_torch.serve import Engine, SamplingParams

    out = {"sampler": check_sampler(dev, model, cfg)}

    # ---- b: sampled serving, twice; then an abort ----------------------
    # uid 6 decodes greedily (temperature 0): its stop id is a token that
    # phase 4's greedy run gave it
    stop_id = main_run["tokens"][6][10]

    def sampled_requests(n=8, stop=True):
        reqs = make_requests(cfg, n, seed=0, lengths=(MAIN_LENGTHS * 2)[:n])
        for r in reqs:
            t, p, k = SURFACE_LANES[r.uid % 8]
            r.params = SamplingParams(
                temperature=t, top_p=p, top_k=k,
                logprobs=5 if r.uid % 2 == 0 else None,
                stop=(stop_id,) if stop and r.uid == 6 else ())
        return reqs

    # the sampled batch twice, in turns with phase 4's greedy batch:
    # greedy, sampled, sampled, greedy (host time moves between runs far
    # apart, so the two step times are compared within these turns)
    runs, greedy_steps = [], []
    for kind in ("greedy", "sampled", "sampled", "greedy"):
        eng = Engine(model, cfg, main_serve_config(), device=dev)
        infos = []
        eng.on_token = lambda uid, tok, info: infos.append((uid, tok, info))
        reqs = sampled_requests() if kind == "sampled" else \
            make_requests(cfg, 8, seed=0, lengths=MAIN_LENGTHS)
        results, steps, wall = serve(eng, reqs)
        if kind == "sampled":
            runs.append(([r.tokens.tolist() for r in results],
                         [r.finish_reason for r in results], infos, steps,
                         wall))
        else:
            greedy_steps.append(1e3 * sum(steps) / len(steps))
        del eng
    toks, reasons, infos, steps, wall = runs[0]
    sampled_steps = [1e3 * sum(r[3]) / len(r[3]) for r in runs]
    recs = [info for _, _, info in infos if info is not None]
    lp_ok = all(i["logprob"] <= 0.0 and i["logprob"] <= i["top_logprobs"][0][1]
                for i in recs)
    n_tok = sum(len(t) for t in toks)
    log("surface", f"sampled serving (8 lanes: {SURFACE_LANES}, logprobs=5 "
        f"on even uids, stop id {stop_id} on uid 6): {n_tok} tokens in "
        f"{wall:.3f} s; decode step in turns, greedy / sampled / sampled / "
        f"greedy: {greedy_steps[0]:.2f} / {sampled_steps[0]:.2f} / "
        f"{sampled_steps[1]:.2f} / {greedy_steps[1]:.2f} ms (phase 4: "
        f"{main_run['step_ms']:.2f} ms); finish reasons {reasons}; "
        f"{len(recs)} logprob records, all ≤ 0 and ≤ their top-1: {lp_ok}; "
        f"the two runs identical: {runs[0][0] == runs[1][0]}")
    require(runs[0][0] == runs[1][0], "two sampled runs of one batch differ")
    require(lp_ok and len(recs) == sum(len(t) for t in toks[0::2]),
            "a logprob record is positive, above its top-1, or missing")
    require(reasons[6] == "stop" and toks[6][-1] == stop_id,
            f"the stop request ended {reasons[6]} with {toks[6][-3:]}")
    require(all(0 <= t < cfg.vocab for row in toks for t in row),
            "a token outside the vocabulary")

    eng = Engine(model, cfg, main_serve_config(), device=dev)
    for r in sampled_requests(9, stop=False):       # uid 8 waits in queue
        eng.submit(r)
    done = []
    while True:
        done.extend(eng.step())
        slot = next(s for s, st in eng.sched.table.active.items()
                    if st.uid == 3)
        if len(eng.sched.table.active[slot].tokens) >= 8:
            break
    aborted = eng.abort(3)
    queued = len(eng.sched.queue)
    done.extend(eng.step())
    took_slot = eng.sched.table.active.get(slot)
    done.extend(eng.drain())
    log("surface", f"abort after the 8th token: {len(aborted.tokens)} "
        f"tokens, finish_reason {aborted.finish_reason!r}; the queued "
        f"request took slot {slot}: "
        f"{took_slot is not None and took_slot.uid == 8}; "
        f"{len(done)} others finished, aborted count "
        f"{eng.stats()['aborted']}")
    require(len(aborted.tokens) == 8 and aborted.finish_reason == "abort",
            f"abort returned {len(aborted.tokens)} tokens, "
            f"{aborted.finish_reason!r}")
    require(queued == 1 and took_slot is not None and took_slot.uid == 8,
            "the queued request did not take the aborted request's slot")
    require(sorted(r.uid for r in done) == [0, 1, 2, 4, 5, 6, 7, 8],
            "a request of the abort run did not finish")
    del eng
    out["sampled"] = dict(step_ms=sampled_steps, greedy_step_ms=greedy_steps,
                          wall_s=wall, tokens=n_tok, reasons=reasons,
                          logprob_records=len(recs))

    # ---- c: speculative serving, unpaged -------------------------------
    reqs = make_requests(cfg, 8, seed=0, lengths=MAIN_LENGTHS)
    eng = Engine(model, cfg, main_serve_config(speculative=True, spec_k=4),
                 device=dev)
    reset_counts()
    results, rounds, wall = serve_rounds(eng, reqs)
    counts = launch_counts()
    st = eng.stats()
    got = [r.tokens.tolist() for r in results]
    n_tok = sum(len(t) for t in got)
    round_ms = 1e3 * sum(rounds) / max(len(rounds), 1)
    bad = hold_tokens(dev, cfg, model, reqs, got, main_run["tokens"],
                      "spec unpaged vs phase 4")
    log("surface", f"speculative, unpaged (8 lanes, spec_k 4, store="
        f"{eng._spec_store}): {n_tok} tokens in {wall:.3f} s, "
        f"{n_tok / wall:.1f} tok/s (phase 4 plain: {main_run['tok_s']:.1f}); "
        f"{st['spec_rounds']} rounds, {len(rounds)} decode-only rounds of "
        f"{round_ms:.2f} ms; acceptance {st['spec_accepted_tokens']}/"
        f"{st['spec_draft_tokens']} = {st['spec_acceptance_rate']:.4f}, "
        f"accepted drafts a lane a round (histogram) "
        f"{_hist_line(st['spec_accept_per_round'])}; {bad} of 8 requests "
        f"differ from phase 4's tokens; launches {counts}")
    require(bad == 0, f"{bad} speculative requests diverged from plain decode")
    require(st["spec_rounds"] >= 1
            and st["spec_accepted_tokens"] <= st["spec_draft_tokens"],
            f"speculative counters {st}")
    require(all(counts[k] > 0 for k in ("K1", "K3", "K4")),
            f"a kernel of the speculative path never launched: {counts}")
    del eng
    out["spec_unpaged"] = dict(tok_s=n_tok / wall, round_ms=round_ms,
                               rounds=st["spec_rounds"],
                               decode_only_rounds=len(rounds),
                               acceptance=st["spec_acceptance_rate"],
                               accept_hist=st["spec_accept_per_round"],
                               drafted=st["spec_draft_tokens"],
                               accepted=st["spec_accepted_tokens"],
                               counts=counts, plain_tok_s=main_run["tok_s"])

    # one lane, spec off then on, the first SPEC_ONE_LANE_REQUESTS prompts
    one = {}
    n1_req = SPEC_ONE_LANE_REQUESTS
    for spec in (False, True):
        eng = Engine(model, cfg, main_serve_config(
            decode_batch=1, speculative=spec, spec_k=4), device=dev)
        reqs1 = make_requests(cfg, n1_req, seed=0,
                              lengths=MAIN_LENGTHS[:n1_req])
        results, rounds, wall = serve_rounds(eng, reqs1)
        toks1 = [r.tokens.tolist() for r in results]
        n1 = sum(len(t) for t in toks1)
        one[spec] = dict(tok_s=n1 / wall, wall_s=wall, tokens=toks1,
                         round_ms=1e3 * sum(rounds) / max(len(rounds), 1),
                         acceptance=eng.stats()["spec_acceptance_rate"])
        del eng
    bad1 = hold_tokens(dev, cfg, model, reqs1, one[True]["tokens"],
                       one[False]["tokens"], "spec vs plain at 1 lane")
    log("surface", f"1 lane, {n1_req} requests × 32 tokens: plain "
        f"{one[False]['tok_s']:.1f} tok/s, speculative "
        f"{one[True]['tok_s']:.1f} tok/s (rounds of "
        f"{one[True]['round_ms']:.2f} ms, acceptance "
        f"{one[True]['acceptance']:.4f}); {bad1} of {n1_req} requests "
        f"differ")
    require(bad1 == 0, "speculative decode at 1 lane diverged from plain")
    out["one_lane"] = {("spec" if k else "plain"): {
        key: v for key, v in d.items() if key != "tokens"}
        for k, d in one.items()}

    # ---- d: speculative serving, paged --------------------------------
    # the first SPEC_PAGED_REQUESTS of phase 4b's prompts (cut from 16 to
    # make room for phase "train"), held to phase 4b's tokens
    reqs = shared_prefix_requests(cfg, SPEC_PAGED_REQUESTS, seed=6)
    eng = Engine(model, cfg, paged_serve_config(speculative=True, spec_k=4),
                 device=dev)
    reset_counts()
    results, rounds, wall = serve_rounds(eng, reqs)
    counts = launch_counts()
    st = eng.stats()
    got = [r.tokens.tolist() for r in results]
    n_tok = sum(len(t) for t in got)
    bad = hold_tokens(dev, cfg, model, reqs, got, paged_run["tokens"],
                      "spec paged vs phase 4b")
    log("surface", f"speculative, paged ({len(reqs)} requests, shared "
        f"prefix): "
        f"{n_tok} tokens in {wall:.3f} s, {n_tok / wall:.1f} tok/s (phase "
        f"4b plain: {paged_run['tok_s']:.1f}); {st['spec_rounds']} rounds, "
        f"acceptance {st['spec_acceptance_rate']:.4f}; pages hot after the "
        f"drain {st['pages_hot']} (parked {eng.sc.decode_batch}); {bad} of "
        f"{len(reqs)} requests differ from phase 4b's tokens; launches "
        f"{counts}")
    require(bad == 0, f"{bad} paged speculative requests diverged")
    require(counts["K5"] > 0 and counts["K3"] == 0,
            f"paged speculative decode launches {counts}")
    require(st["pages_hot"] == eng.sc.decode_batch
            and sum(eng.pool.refcount(p) for p in range(eng.pool.n_pages))
            == eng.sc.decode_batch,
            "page refcounts did not return to the pool's idle state")
    del eng
    torch.cuda.empty_cache()
    out["spec_paged"] = dict(tok_s=n_tok / wall, rounds=st["spec_rounds"],
                             acceptance=st["spec_acceptance_rate"],
                             counts=counts, plain_tok_s=paged_run["tok_s"])
    return out


# ---------------------------------------------------------------------------
# phase "frontend": the HTTP server and the serving observability
# ---------------------------------------------------------------------------
# required schema keys only the paged engine publishes (the page pool, the
# prefix cache and the chunked-prefill entry): an unpaged snapshot lacks
# them, as the JAX engine's does
PAGED_ONLY_KEYS = frozenset({
    "pages_total", "pages_free", "pages_cold", "pages_hot", "evictions",
    "watermark_evictions", "page_allocs", "prefix_queries",
    "prefix_hit_blocks", "prefix_miss_blocks", "prefix_cached_blocks",
    "prefix_inserted_blocks", "prefill_chunks", "prefill_tokens_computed",
    "prompt_tokens_total", "prefix_hit_tokens", "prefix_hit_rate",
    "compiled_shapes_prefill_chunk", "dispatches_prefill_chunk",
    "compile_seconds_prefill_chunk"})


def schema_errors(snap: dict, schema_name: str = "metrics_schema.json",
                  allow_missing=frozenset()) -> list:
    """``tools/validate_metrics.py``'s violations of ``snap`` against the
    named schema under ``tools/``, less missing required keys named in
    ``allow_missing``."""
    sys.path.insert(0, ROOT)
    from tools.validate_metrics import validate
    with open(os.path.join(ROOT, "tools", schema_name)) as fh:
        schema = json.load(fh)
    return [e for e in validate(snap, schema, schema)
            if not any(e.endswith(f"missing required key {k!r}")
                       for k in allow_missing)]


def http_json(port: int, method: str, path: str, body=None) -> tuple:
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=180)
    conn.request(method, path, None if body is None else json.dumps(body),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, json.loads(data)


def http_stream(port: int, path: str, body: dict, stop_after=None) -> dict:
    """POST ``body`` with ``stream: true`` and read the SSE frames as they
    arrive: token ids, the seconds to the first token frame, the frames.
    With ``stop_after=n`` the client vanishes (a reset, not a FIN) after
    its n-th token frame."""
    import http.client
    import socket
    import struct
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=180)
    t0 = time.perf_counter()
    conn.request("POST", path, json.dumps(dict(body, stream=True)),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    require(resp.status == 200, f"{path}: HTTP {resp.status}")
    out = dict(tokens=[], frames=[], ttft_s=None)
    while True:
        line = resp.readline()
        if not line:
            break
        line = line.decode().strip()
        if not line.startswith("data: "):
            continue
        payload = line[len("data: "):]
        out["frames"].append(payload)
        if payload == "[DONE]":
            continue                # read on to the closing chunk
        ev = json.loads(payload)
        ids = ev.get("choices", [{}])[0].get("token_ids")
        if ids:
            out["ttft_s"] = out["ttft_s"] or time.perf_counter() - t0
            out["tokens"].extend(ids)
            if stop_after is not None and len(out["tokens"]) >= stop_after:
                conn.sock.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                                     struct.pack("ii", 1, 0))
                break
    out["wall_s"] = time.perf_counter() - t0
    resp.close()
    conn.close()
    return out


class StepTimers:
    """Synchronized wall time of the engine's drift probe and sanitizer,
    and the largest |logit| the probe compared, read by wrapping the
    engine's methods (measurement only)."""

    def __init__(self, eng):
        import torch
        self.drift, self.sanitize, self.max_logit = [], [], 0.0

        def timed(fn, into):
            def call(*a, **k):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*a, **k)
                torch.cuda.synchronize()
                into.append(time.perf_counter() - t0)
                return out
            return call

        ref, obs = eng._drift_reference, eng._observe_drift
        probe = []

        def observe(s, r, decoding):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rows = torch.tensor(decoding, device=s.device)
            self.max_logit = max(self.max_logit,
                                 float(s[rows].abs().max()))
            obs(s, r, decoding)
            self.drift.append(probe.pop() + time.perf_counter() - t0)

        eng._drift_reference = timed(ref, probe)
        eng._observe_drift = observe
        if eng._san is not None:
            eng._san.check = timed(eng._san.check, self.sanitize)

    def ms(self, what: str) -> float:
        xs = getattr(self, what)
        return 1e3 * sum(xs) / max(len(xs), 1)


def probe_leaves_cache(dev, cfg, model, sc) -> int:
    """Serve phase 4's prompts into an engine with the drift monitor for a
    few steps, then run the probe's reference pass once more by hand and
    count the cache tensors it changed (bit for bit; ``pos`` by
    identity)."""
    import torch
    from repro_torch.launch.serve import make_requests
    from repro_torch.serve import Engine

    eng = Engine(model, cfg, sc, device=dev)
    for r in make_requests(cfg, 8, seed=0, lengths=MAIN_LENGTHS):
        eng.submit(r)
    for _ in range(6):
        eng.step()
    before = [{k: v.clone() for k, v in layer.items()}
              for layer in eng.slots.cache]
    pos = [layer["pos"] for layer in eng.slots.cache]
    eng._drift_reference()
    torch.cuda.synchronize()
    changed = sum(not torch.equal(layer[k], b[k])
                  for layer, b in zip(eng.slots.cache, before) for k in b)
    changed += sum(layer["pos"] is not p
                   for layer, p in zip(eng.slots.cache, pos))
    del eng, before
    torch.cuda.empty_cache()
    return changed


def stream_all(port: int, reqs, max_tokens: int, tag: str) -> dict:
    """Stream every request of ``reqs`` at once, as token-id prompts;
    returns the tokens, client TTFTs and tok/s over the wall of all."""
    import threading
    got = [None] * len(reqs)

    def client(i):
        got[i] = http_stream(port, "/v1/completions", {
            "prompt": reqs[i].prompt.tolist(), "max_tokens": max_tokens})

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(reqs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    wall = time.perf_counter() - t0
    require(all(g is not None for g in got), f"{tag}: a stream hung")
    errors = [f for g in got for f in g["frames"] if '"error"' in f]
    require(not errors, f"{tag}: streams failed: {errors[:2]}")
    require(all(g["frames"][-1] == "[DONE]" for g in got),
            f"{tag}: a stream did not end with [DONE]")
    n_tok = sum(len(g["tokens"]) for g in got)
    return dict(wall_s=wall, tokens=[g["tokens"] for g in got],
                ttft_ms=[1e3 * g["ttft_s"] for g in got], n_tok=n_tok,
                tok_s=n_tok / wall)


@contextlib.contextmanager
def http_server(eng):
    """``serve_http`` over ``eng`` on an ephemeral port, served from a
    thread; yields (port, EngineServer) and shuts both down."""
    import threading
    from repro_torch.serve import serve_http

    httpd, srv = serve_http(eng, port=0, model_id="repro-qlr")
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        yield httpd.server_address[1], srv
    finally:
        httpd.shutdown()
        srv.close()
        httpd.server_close()


def http_plain(dev, cfg, model, sc, reqs, tag: str) -> dict:
    """``stream_all`` through ``serve_http`` over a warmed engine of ``sc``
    (no telemetry, sanitizer or drift monitor): the frontend's own cost
    beside the engine figures."""
    import torch
    from repro_torch.serve import Engine

    eng = Engine(model, cfg, sc, device=dev)
    eng.warmup()
    with http_server(eng) as (port, _):
        out = stream_all(port, reqs, sc.max_new_tokens, tag)
    del eng
    torch.cuda.empty_cache()
    return out


def serve_over_http(dev, cfg, model, sc, reqs, tag: str) -> dict:
    """Boot ``serve_http`` on an ephemeral port over an engine of ``sc``
    (telemetry, sanitizer and the drift monitor at rate 1.0, warmed up),
    stream ``reqs`` concurrently as token-id prompts, read the snapshot
    and the trace; returns what the gates need."""
    import torch
    from repro_torch.serve import Engine

    eng = Engine(model, cfg, sc, device=dev)
    eng.warmup()
    timers = StepTimers(eng)
    admits = []
    admit = eng.sched.admit

    def logged_admit(state):
        slot = admit(state)
        admits.append((state.uid, slot))
        return slot

    eng.sched.admit = logged_admit
    with http_server(eng) as (port, srv):
        reset_counts()
        out = stream_all(port, reqs, sc.max_new_tokens, tag)
        out["counts"] = launch_counts()

        # one chat stream, one non-stream with logprobs, one client that
        # vanishes after its 8th token
        chat = http_stream(port, "/v1/chat/completions", {
            "messages": [{"role": "user", "content": "frontend smoke"}],
            "max_tokens": 16})
        ev = [json.loads(f) for f in chat["frames"][:-1]]
        require(chat["frames"][-1] == "[DONE]"
                and ev[0]["choices"][0]["delta"] == {"role": "assistant"}
                and ev[-1]["choices"][0]["finish_reason"] == "length"
                and len(chat["tokens"]) == 16,
                f"{tag}: chat stream {chat['frames'][:2]} … "
                f"{chat['frames'][-2:]}")
        status, lp = http_json(port, "POST", "/v1/completions", {
            "prompt": reqs[0].prompt.tolist(), "max_tokens": 8,
            "logprobs": 3})
        choice = lp["choices"][0]
        block = choice["logprobs"]
        lp_ok = (status == 200 and choice["token_ids"] == out["tokens"][0][:8]
                 and all(c <= 0.0 and max(top.values()) == c
                         for c, top in zip(block["token_logprobs"],
                                           block["top_logprobs"])))
        require(lp_ok, f"{tag}: logprob completion {lp}")
        aborted0 = srv.stats()["aborted"]
        # the longest generation the cache allows, so the server is still
        # writing when the reset arrives
        cut = http_stream(port, "/v1/completions", {
            "prompt": reqs[1].prompt.tolist(),
            "max_tokens": sc.max_len - len(reqs[1].prompt) - 1},
            stop_after=8)
        deadline = time.time() + 60
        while time.time() < deadline:
            if srv.stats()["aborted"] > aborted0 \
                    and eng.sched.table.n_active == 0:
                break
            time.sleep(0.05)
        cut_uid, cut_slot = admits[-1]
        status, _ = http_json(port, "POST", "/v1/completions", {
            "prompt": reqs[2].prompt.tolist(), "max_tokens": 4})
        snap = srv.stats()
        require(snap["aborted"] == aborted0 + 1
                and eng.sched.table.n_active == 0,
                f"{tag}: the disconnect did not abort (aborted "
                f"{snap['aborted']}, active {eng.sched.table.n_active})")
        require(status == 200 and admits[-1][1] == cut_slot,
                f"{tag}: the request after the abort took slot "
                f"{admits[-1][1]}, not the freed slot {cut_slot}")
        for route in ("/health", "/v1/models"):
            status, _ = http_json(port, "GET", route)
            require(status == 200, f"{tag}: GET {route} → {status}")
        status, snap = http_json(port, "GET", "/metrics.json")
        require(status == 200, f"{tag}: /metrics.json → {status}")
        trace = os.path.join(OUT_DIR, f"frontend_{tag}.trace.json")
        os.makedirs(OUT_DIR, exist_ok=True)
        with srv.cv:                  # the server's lock contract
            eng.write_trace(trace)
        with open(trace) as fh:
            events = json.load(fh)["traceEvents"]
        uids = {uid for uid, _ in admits if uid >= 0}
        lanes = {n: {e["tid"] for e in events
                     if e["pid"] == 1 and e["name"] == n}
                 for n in ("queued", "retired")}
        out.update(snap=snap, uids=sorted(uids), lanes=lanes,
                   drift_ms=timers.ms("drift"),
                   sanitize_ms=timers.ms("sanitize"),
                   drift_calls=len(timers.drift),
                   max_logit=timers.max_logit, cut_uid=cut_uid,
                   cut_tokens=len(cut["tokens"]))
    del eng
    torch.cuda.empty_cache()
    return out


def frontend_gates(tag: str, run: dict, want_tokens: list,
                   allow_missing=frozenset()) -> None:
    snap = run["snap"]
    errs = schema_errors(snap, allow_missing=allow_missing)
    delta = snap["drift_logit_delta"]
    tol = 1e-3 * max(1.0, run["max_logit"])
    bad = sum(g != w for g, w in zip(run["tokens"], want_tokens))
    log("frontend", f"{tag}: /metrics.json against tools/metrics_schema.json"
        f": {len(errs)} violations" + (f" (the {len(allow_missing)} "
                                       f"paged-only keys exempt)"
                                       if allow_missing else "")
        + f"; drift checks {snap['drift_checks']}, top-1 agreement "
        f"{snap['drift_top1_agreement_rate']}, non-finite "
        f"{snap['drift_nonfinite']}, OOB tokens {snap['guard_token_oob']}; "
        f"KL {_hist_line(snap['drift_kl'])}; max |Δlogit| "
        f"{delta['max']:.3e} (max |logit| {run['max_logit']:.3f}, tol "
        f"{tol:.3e}); {bad} of {len(want_tokens)} requests differ from the "
        f"engine's tokens; trace lanes queued/retired "
        f"{len(run['lanes']['queued'])}/{len(run['lanes']['retired'])} of "
        f"{len(run['uids'])} uids")
    require(not errs, f"{tag}: snapshot violates the schema: {errs[:5]}")
    require(bad == 0, f"{tag}: {bad} HTTP requests diverged from the "
            f"engine's tokens")
    require(snap["drift_nonfinite"] == 0 and snap["guard_token_oob"] == 0,
            f"{tag}: non-finite logits or out-of-range tokens")
    require(snap["drift_checks"] > 0 and delta["max"] <= tol,
            f"{tag}: drift gate: {snap['drift_checks']} checks, max "
            f"|Δlogit| {delta['max']} > {tol}")
    require(run["lanes"]["queued"] >= set(run["uids"])
            and run["lanes"]["retired"] >= set(run["uids"]),
            f"{tag}: the trace misses uids {run['uids']} vs {run['lanes']}")


def step_ms_telemetry(dev, cfg, model) -> dict:
    """Phase 4's serving, decode-only step ms with telemetry off and on,
    in turns off, on, on, off."""
    from repro_torch.launch.serve import make_requests
    from repro_torch.serve import Engine

    out = {False: [], True: []}
    for tel in (False, True, True, False):
        eng = Engine(model, cfg, main_serve_config(telemetry=tel), device=dev)
        _, steps, _ = serve(eng, make_requests(cfg, 8, seed=0,
                                               lengths=MAIN_LENGTHS))
        out[tel].append(1e3 * sum(steps) / len(steps))
        del eng
    return {"off": out[False], "on": out[True]}


def quant_report_pass(dev, cfg) -> dict:
    """Phase "ptq"'s two-layer model calibrated, then quantized twice by
    the same SRR pass (qera-exact, rank 16, the randomized SVDs of the
    serving pipeline: phase "ptq"'s exact ones take half a minute a pass),
    with a ``QuantRecorder`` and without: the report validates against
    ``tools/quant_report_schema.json`` and ``python -m tools.quant_report``
    renders it; the containers are bit-identical."""
    import contextlib
    import io
    import torch
    from repro_torch.models import init_lm
    from repro_torch.models.linear import QLinear
    from repro_torch.models.quantize import quantize_model_params
    from repro_torch.obs import QuantRecorder

    cut = dataclasses.replace(cfg, n_layers=2)
    stats, _ = calibrate(dev, cut, init_lm(cut, 0, device=dev), "frontend")
    ptq = srr_ptq()
    models, took = {}, {}
    rec = QuantRecorder()
    for with_rec in (False, True):
        model = init_lm(cut, 0, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        models[with_rec], _ = quantize_model_params(
            model, ptq, stats=dict(stats), recorder=rec if with_rec else None,
            device=dev)
        torch.cuda.synchronize()
        took[with_rec] = time.perf_counter() - t0
    same = all(torch.equal(a, b) for ma, mb in zip(models[False].modules(),
                                                   models[True].modules())
               if isinstance(ma, QLinear)
               for a, b in zip(ma.buffers(), mb.buffers()))
    path = os.path.join(OUT_DIR, "frontend_quant_report.json")
    os.makedirs(OUT_DIR, exist_ok=True)
    rec.write(path)
    with open(path) as fh:
        report = json.load(fh)
    errs = schema_errors(report, "quant_report_schema.json")
    sys.path.insert(0, ROOT)
    from tools.quant_report import main as render_main
    with contextlib.redirect_stdout(io.StringIO()) as text:
        rendered = render_main([path])
    s = report["summary"]
    log("frontend", f"quant report of the two-layer pass: {s['layers']} "
        f"matrices, mean k* {s['mean_k']:.2f}, mean preserved energy "
        f"{s['mean_preserved_energy_fraction']:.4f}, mean scaled rel err "
        f"{s['mean_scaled_rel_err']:.4f}, {s['total_bytes']} container "
        f"bytes; {len(errs)} schema violations; tools.quant_report exit "
        f"{rendered} ({len(text.getvalue().splitlines())} lines); pass "
        f"{took[False]:.2f} s without the recorder, {took[True]:.2f} s with "
        f"it; containers bit-identical: {same}")
    require(not errs, f"quant report violates its schema: {errs[:5]}")
    require(rendered == 0, "python -m tools.quant_report failed")
    require(same and s["layers"] == 14,
            "the recorder changed the containers, or missed a matrix")
    del models
    torch.cuda.empty_cache()
    return dict(summary=s, pass_s=took[False], recorded_pass_s=took[True])


def phase_frontend(dev, cfg, model, main_run: dict, paged_run: dict) -> dict:
    """Phase "frontend" on phase 4's quantized model: (a) ``serve_http``
    over phase 4's config with telemetry, the sanitizer and the drift
    monitor at rate 1.0 — phase 4's prompts streamed concurrently as
    token-id lists (tokens equal phase 4's), a chat stream, a non-stream
    completion with logprobs, a client that vanishes after 8 tokens
    (aborted, its slot reused), the snapshot against the schema, the
    drift and guard gates, every uid in the trace; the probe leaving the
    cache bit for bit; step ms with telemetry off and on; (b) the same
    over phase 4b's paged config (K5 launched, K3 not, the full schema);
    (c) the quant report of phase "ptq"'s two-layer pass."""
    from repro_torch.launch.serve import make_requests

    obs = dict(telemetry=True, sanitize=True, drift_monitor=True,
               drift_sample_rate=1.0)
    out = {}
    changed = probe_leaves_cache(dev, cfg, model, main_serve_config(**obs))
    log("frontend", f"drift probe's reference pass over a live unpaged "
        f"cache: {changed} cache tensors changed")
    require(changed == 0, "the drift probe changed the cache")

    # ---- a: unpaged server -----------------------------------------------
    reqs = make_requests(cfg, 8, seed=0, lengths=MAIN_LENGTHS)
    plain = http_plain(dev, cfg, model, main_serve_config(), reqs, "plain")
    ttft = plain["ttft_ms"]
    bad = sum(g != w for g, w in zip(plain["tokens"], main_run["tokens"]))
    log("frontend", f"unpaged over HTTP, no observability: 8 concurrent "
        f"streams, {plain['n_tok']} tokens in {plain['wall_s']:.3f} s: "
        f"{plain['tok_s']:.1f} tok/s (phase 4 engine: "
        f"{main_run['tok_s']:.1f}); client TTFT first {min(ttft):.1f} mean "
        f"{sum(ttft) / len(ttft):.1f} max {max(ttft):.1f} ms (phase 4 engine:"
        f" first {min(main_run['ttft_ms']):.1f} mean "
        f"{sum(main_run['ttft_ms']) / 8:.1f} max "
        f"{max(main_run['ttft_ms']):.1f} ms); {bad} of 8 requests differ from "
        f"phase 4's tokens")
    require(bad == 0, f"{bad} HTTP requests diverged from phase 4's tokens")
    out["plain"] = {k: v for k, v in plain.items() if k != "tokens"}
    run = serve_over_http(dev, cfg, model, main_serve_config(**obs), reqs,
                          "unpaged")
    ttft = run["ttft_ms"]
    log("frontend", f"unpaged over HTTP with telemetry, sanitizer and the "
        f"drift monitor at rate 1.0: {run['n_tok']} tokens in "
        f"{run['wall_s']:.3f} s: {run['tok_s']:.1f} tok/s; client TTFT first "
        f"{min(ttft):.1f} mean {sum(ttft) / len(ttft):.1f} max "
        f"{max(ttft):.1f} ms; drift probe "
        f"{run['drift_ms']:.2f} ms a step over {run['drift_calls']} steps; "
        f"sanitizer {run['sanitize_ms']:.2f} ms a step; the client cut "
        f"after {run['cut_tokens']} tokens was aborted and its slot reused; "
        f"launches {run['counts']}")
    require(all(run["counts"][k] > 0 for k in ("K1", "K2", "K3", "K4")),
            f"a kernel of the served path never launched: {run['counts']}")
    frontend_gates("unpaged", run, main_run["tokens"],
                   allow_missing=PAGED_ONLY_KEYS)
    out["unpaged"] = {k: v for k, v in run.items()
                      if k not in ("snap", "tokens", "lanes")}

    tel = step_ms_telemetry(dev, cfg, model)
    log("frontend", f"decode step, telemetry off / on / on / off: "
        f"{tel['off'][0]:.2f} / {tel['on'][0]:.2f} / {tel['on'][1]:.2f} / "
        f"{tel['off'][1]:.2f} ms")
    out["step_ms_telemetry"] = tel

    # ---- b: paged server -------------------------------------------------
    preqs = shared_prefix_requests(cfg, 16, seed=6)
    prun = serve_over_http(dev, cfg, model, paged_serve_config(**obs), preqs,
                           "paged")
    ttft = prun["ttft_ms"]
    log("frontend", f"paged over HTTP: 16 concurrent streams, "
        f"{prun['n_tok']} tokens in {prun['wall_s']:.3f} s: "
        f"{prun['tok_s']:.1f} tok/s (phase 4b engine: "
        f"{paged_run['tok_s']:.1f}); client TTFT first {min(ttft):.1f} mean "
        f"{sum(ttft) / len(ttft):.1f} max {max(ttft):.1f} ms; drift probe "
        f"{prun['drift_ms']:.2f} ms a step; sanitizer {prun['sanitize_ms']:.2f}"
        f" ms a step; prefix hit rate {prun['snap']['prefix_hit_rate']}; "
        f"launches {prun['counts']}")
    require(prun["counts"]["K5"] > 0 and prun["counts"]["K3"] == 0,
            f"paged HTTP serving launches {prun['counts']}")
    frontend_gates("paged", prun, paged_run["tokens"])
    out["paged"] = {k: v for k, v in prun.items()
                    if k not in ("snap", "tokens", "lanes")}

    # ---- c: the quant report ---------------------------------------------
    out["quant_report"] = quant_report_pass(dev, cfg)
    return out


# ---------------------------------------------------------------------------
# phase "lowering": the dry run, one decode step's count, the compressed sync
# ---------------------------------------------------------------------------
DRYRUN_ARGS = ["--arch", "phi3-mini-3.8b", "--shape", "decode_32k",
               "--mesh", "both"]
SYNC_SEED = 23
SYNC_REPS = 5


def start_dryrun():
    """(a) ``launch.dryrun`` in a process of its own (its fake world is the
    default process group there; (c) and (d) need this process's)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *DRYRUN_ARGS,
         "--out", os.path.join(OUT_DIR, "dryrun")], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def lowering_count(dev, cfg, model, smi: str) -> dict:
    """(b) one decode step of phase 4's model over phase 4's 8-lane cache
    (its prompts prefilled) counted by ``cost.count`` at ``fused="auto"``
    (K1 and K3 on the card) and ``"off"``: the same FLOPs, and the recorded
    K1/K3 calls equal to the launches. The step's roofline terms beside
    its device busy time under the profiler (no gate)."""
    import torch
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import cost, roofline
    from repro_torch.launch.serve import make_requests
    from repro_torch.models import Ctx, decode_step, init_cache, prefill

    reqs = make_requests(cfg, 8, seed=0, lengths=MAIN_LENGTHS)
    tokens = torch.zeros((8, max(MAIN_LENGTHS)), dtype=torch.long, device=dev)
    for i, r in enumerate(reqs):
        tokens[i, :len(r.prompt)] = torch.from_numpy(r.prompt).to(dev)
    lengths = torch.tensor(MAIN_LENGTHS, dtype=torch.int32, device=dev)
    ctx = {f: Ctx(fused=f) for f in ("auto", "off")}
    cache = init_cache(cfg, 8, main_serve_config().max_len, torch.bfloat16,
                       dev)
    with torch.no_grad():
        logits, cache = prefill(ctx["auto"], model, tokens, cache,
                                lengths=lengths)
        token = logits.argmax(-1)
        reset_counts()
        counted = {"auto": cost.count(decode_step, ctx["auto"], model, token,
                                      cache)}
        launched = launch_counts()
        counted["off"] = cost.count(decode_step, ctx["off"], model, token,
                                    cache)
        inside = flops_inside(lambda: decode_step(ctx["off"], model, token,
                                                  cache))
        dev_ms, wall_ms = device_busy_ms(
            lambda: decode_step(ctx["auto"], model, token, cache))
    calls = {k: v["calls"] for k, v in counted["auto"]["by_kernel"].items()}
    log("lowering", f"(b) one decode step counted: fused=auto {calls}, "
        f"launches {launched}; flops auto {counted['auto']['flops']:.6e} "
        f"off {counted['off']['flops']:.6e}, bytes auto "
        f"{counted['auto']['bytes']:.6e} off {counted['off']['bytes']:.6e}")
    require(counted["auto"]["flops"] == counted["off"]["flops"],
            "the decode step's FLOPs differ between the kernels and "
            "fused='off'")
    log("lowering", "(b) each kernel function's formula vs flop_counter of "
        "the fused='off' ops that compute it: " + ", ".join(
            f"{k} {f:.6e} / {o:.6e}" for k, (f, o) in inside.items()))
    require(sorted(inside) == sorted(calls) and all(
        f == o for f, o in inside.values()),
        f"a kernel function's formula is not the FLOPs its ops run: {inside}")
    want = {"K1 qlr_fused_matmul": 7 * cfg.n_layers,
            "K3 flash_decode": cfg.n_layers}
    require(calls == want and launched["K1"] == want["K1 qlr_fused_matmul"]
            and launched["K3"] == want["K3 flash_decode"]
            and sum(launched.values()) == sum(want.values()),
            f"recorded kernel calls {calls} vs launches {launched}, "
            f"expected {want}")
    shape = ShapeConfig("phase4_decode", main_serve_config().max_len, 8,
                        "decode")
    r = roofline.analyze(counted["auto"], cfg, shape, "host1x1", 1, cfg.name)
    log("lowering", f"(b) roofline of the step on one card (H100 SXM data-"
        f"sheet peaks): t_compute {r.t_compute * 1e3:.4f} ms, t_memory "
        f"{r.t_memory * 1e3:.4f} ms ({r.bottleneck}-bound; K1 "
        f"{counted['auto']['by_kernel']['K1 qlr_fused_matmul']['bytes']:.4e}"
        f" B, K3 {counted['auto']['by_kernel']['K3 flash_decode']['bytes']:.4e}"
        f" B); measured under torch.profiler: device busy {dev_ms:.3f} ms "
        f"in a {wall_ms:.3f} ms step; {smi}")
    return dict(calls=calls, launches=launched,
                flops=counted["auto"]["flops"], bytes=counted["auto"]["bytes"],
                bytes_off=counted["off"]["bytes"],
                by_kernel=counted["auto"]["by_kernel"],
                t_compute_ms=r.t_compute * 1e3, t_memory_ms=r.t_memory * 1e3,
                device_ms=dev_ms, wall_ms=wall_ms)


def flops_inside(fn) -> dict:
    """Run ``fn`` once under ``torch.utils.flop_counter`` with a
    ``kernels.work`` recorder that passes each kernel function's call
    through: {name: (its formula's FLOPs, flop_counter's FLOPs of the
    ops that computed it)}, summed over its calls."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels import work

    class Inside:
        def kernel(self, w, call, args, kw):
            before = counter.get_total_flops()
            out = call(*args, **kw)
            f, o = table.get(w.name, (0, 0))
            table[w.name] = (f + w.flops,
                             o + counter.get_total_flops() - before)
            return out

    table = {}
    with FlopCounterMode(display=False) as counter:
        work.RECORDER = Inside()
        try:
            fn()
        finally:
            work.RECORDER = None
    return table


def device_busy_ms(fn, n: int = 3) -> tuple[float, float]:
    """(device busy ms, wall ms) a call of ``fn`` over ``n`` calls under
    ``torch.profiler``, synchronized at the end: the device time of its
    kernels, memcpys and memsets (``profile_decode``'s measure; a decode
    step waits on the device inside, so CUDA events around back-to-back
    calls would time the host too)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    return busy_us / n / 1e3, 1e3 * wall / n


def lowering_sync(dev, model, smi: str) -> dict:
    """(c) ``ef_compressed_psum`` over phase 4's model's QPEFT adapter
    tree (224 ``l``/``r`` pairs), gradients and a residual filled from a
    seed: an NCCL group of one on the card (a ``FileStore`` under
    ``build/``) against a gloo group of one on the CPU, bit for bit, and
    ``synced + ef' = g + ef`` within f32 rounding; one sync's time."""
    import torch
    import torch.distributed as dist
    from repro_torch.models.quantize import split_qpeft
    from repro_torch.optim import ef_compressed_psum
    from repro_torch.optim.tree import tree_leaves, tree_map

    adapters, _ = split_qpeft(model)
    gen = torch.Generator().manual_seed(SYNC_SEED)
    grads = tree_map(lambda t: torch.randn(t.shape, generator=gen) * 1e-3,
                     adapters)
    ef = tree_map(lambda t: torch.randn(t.shape, generator=gen) * 1e-6,
                  adapters)
    store = os.path.join(OUT_DIR, "nccl_store")
    if os.path.exists(store):
        os.remove(store)
    dist.init_process_group("nccl", store=dist.FileStore(store, 1), rank=0,
                            world_size=1)
    try:
        g_dev = tree_map(lambda t: t.to(dev), grads)
        e_dev = tree_map(lambda t: t.to(dev), ef)
        synced, ef2 = ef_compressed_psum(g_dev, e_dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(SYNC_REPS):
            ef_compressed_psum(g_dev, e_dev)
        torch.cuda.synchronize()
        sync_ms = 1e3 * (time.perf_counter() - t0) / SYNC_REPS
    finally:
        dist.destroy_process_group()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        synced_c, ef2_c = ef_compressed_psum(grads, ef)
    finally:
        dist.destroy_process_group()
    leaves = list(zip(tree_leaves(synced), tree_leaves(ef2),
                      tree_leaves(synced_c), tree_leaves(ef2_c),
                      tree_leaves(grads), tree_leaves(ef)))
    unequal = sum(not (torch.equal(s.cpu(), sc) and torch.equal(e.cpu(), ec))
                  for s, e, sc, ec, _, _ in leaves)
    books = max(float(((sc + ec) - (g + e)).abs().max()
                      / (g + e).abs().max()) for _, _, sc, ec, g, e in leaves)
    n_el = sum(g.numel() for *_, g, _ in leaves)
    log("lowering", f"(c) ef_compressed_psum over {len(leaves)} adapter "
        f"leaves ({n_el} values): NCCL world 1 on the card vs gloo world 1 on "
        f"the CPU: {len(leaves) - unequal} of {len(leaves)} leaves bit for "
        f"bit; max |synced + ef' − (g + ef)| / max|g + ef| {books:.3e}; one "
        f"sync {sync_ms:.3f} ms wall (synchronized, {2 * len(leaves)} "
        f"all-reduces); {smi}")
    require(unequal == 0, f"{unequal} leaves differ between the card's "
            f"NCCL sync and the CPU's gloo one")
    require(books <= 2 ** -22, f"synced + ef' misses g + ef by {books:.3e}")
    return dict(leaves=len(leaves), values=n_el, sync_ms=sync_ms,
                books=books)


def lowering_host_mesh(dev, model) -> dict:
    """(d) phase 4's container distributed over ``make_host_mesh()`` (one
    card: a 1×1 NCCL mesh) by the rules: every ``to_local()`` equals its
    tensor."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding.rules import distribute, tree_param_specs

    mesh = make_host_mesh()
    try:
        specs = tree_param_specs(model, mesh)
        bad = [name for name, spec in specs.items()
               if not torch.equal(distribute(name, model.get_buffer(name),
                                             spec, mesh).to_local(),
                                  model.get_buffer(name))]
        shape = tuple(mesh.shape)
    finally:
        dist.destroy_process_group()
    log("lowering", f"(d) {len(specs)} buffers distributed over "
        f"make_host_mesh() {shape}: {len(specs) - len(bad)} to_local() equal "
        f"their tensors")
    require(not bad, f"to_local() differs for {bad[:5]}")
    return dict(buffers=len(specs), mesh=list(shape))


def finish_dryrun(proc) -> dict:
    """(a) the dry run's exit and its records."""
    out, err = proc.communicate(timeout=600)
    for line in out.splitlines():
        if line.startswith(("[dryrun]", "  per-chip", "  roofline")):
            log("lowering", f"(a) {line.strip()}")
    require(proc.returncode == 0 and "2 ok, 0 skip, 0 FAIL" in out,
            f"the dry run failed (exit {proc.returncode}): {err[-2000:]}")
    recs = {}
    for mesh in ("pod16x16", "pod2x16x16"):
        path = os.path.join(OUT_DIR, "dryrun",
                            f"phi3-mini-3.8b__decode_32k__{mesh}.json")
        with open(path) as fh:
            rec = json.load(fh)
        recs[mesh] = {k: rec[k] for k in ("flops", "hbm_bytes",
                                          "peak_mem_bytes", "resident_bytes",
                                          "t_compute", "t_memory")}
    return recs


def phase_lowering(dev, cfg, model, smi: str, proc) -> dict:
    """Phase "lowering" on phase 4's model: (b), (c) and (d) here, then
    (a), the dry run of phi3's decode_32k cells, from ``proc``: the
    subprocess :func:`start_dryrun` started beside the kernels' build (it
    needs no kernel and no card)."""
    try:
        out = {"count": lowering_count(dev, cfg, model, smi),
               "sync": lowering_sync(dev, model, smi),
               "host_mesh": lowering_host_mesh(dev, model)}
    except BaseException:
        proc.kill()
        proc.communicate()
        raise
    out["dryrun"] = finish_dryrun(proc)
    return out


def phase_reduced(dev, cfg) -> None:
    import torch
    from repro_torch.launch.serve import make_requests
    from repro_torch.models import Ctx, init_cache, init_lm, prefill
    from repro_torch.models.quantize import quantize_model_params
    from repro_torch.serve import Engine, ServeConfig

    model, _ = quantize_model_params(init_lm(cfg, 1, device=dev),
                                     srr_ptq(seed=1),
                                     container="packed4", device=dev)
    for kv in ("int4", "int8"):
        for paged in (False, True):
            # paged: 64-wide chunks, so prompts of up to 255 tokens take
            # up to four chunks, at odd lengths
            extra = dict(paged=True, prefill_len=64) if paged else {}
            eng = Engine(model, cfg, ServeConfig(**{
                **dict(max_len=320, decode_batch=4, prefill_len=256,
                       kv_dtype=kv, max_new_tokens=8), **extra}), device=dev)
            reset_counts()
            results, _, wall = serve(eng, make_requests(
                cfg, 6, seed=2, lengths=[40, 90, 200, 17, 255, 129]))
            counts = launch_counts()
            log("reduced", f"packed4 weights, kv {kv}, "
                f"{'paged' if paged else 'unpaged'}: {len(results)} requests "
                f"in {wall:.3f} s, launches {counts}")
            require(len(results) == 6 and all(len(r.tokens) == 8
                                              for r in results),
                    "reduced run did not finish its requests")
            # paged, every 64-row chunk projects through K1 (rows <= 128)
            path = ("K1", "K4", "K5") if paged else ("K1", "K2", "K4", "K3")
            require(all(counts[k] > 0 for k in path),
                    f"a kernel never launched with kv {kv}: {counts}")
            require(counts["K3" if paged else "K5"] == 0,
                    f"the other decode kernel launched: {counts}")

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


# Σ|x|, Σx², Σxxᵀ on the card against the CPU, relative to each moment's
# largest entry: f32 sums over 8,192 rows in another order (~1e-6), and
# layer 1's input passes K4 and the card's GEMMs, each held to 1e-4 of its
# output's scale in phase 3; a moment is quadratic in its input, so 2e-4
MOMENT_TOL = 2e-4
# held-out lm_loss through the kernels against fused="off": the loss moves
# by at most twice the largest logit difference, which phases 4 and 6
# hold to 1e-3 · max|logit| (a few units on these models)
LOSS_TOL = 1e-3


# phase "ptq"'s depth: layer 0 holds every projection shape; one layer
# (it was two) halves the exact SVDs, to make room for phase "depth"
PTQ_LAYERS = 1


def phase_ptq(dev, cfg) -> dict:
    """phi3 at full width and ``PTQ_LAYERS`` layers, calibrated on the
    card and on the CPU (plain path) from the same batches: equal tap
    names and counts, moments within MOMENT_TOL. Then w-only, qer, srr and srr-joint under
    qera-exact with exact SVDs from the card's statistics, gated per
    matrix on scaled_err(qer) ≤ scaled_err(w-only)·(1 + 1e-5) and
    scaled_err(srr-joint) ≤ scaled_err(srr)·(1 + 1e-5) (srr and
    srr-joint draw the same probe, so they share k* and Q); the held-out
    lm_loss of the fp model and of each method, through the kernels and
    through ``fused="off"``."""
    import torch
    from repro_torch.data import data_config_for, host_batch
    from repro_torch.models import Ctx, init_lm, lm_loss
    from repro_torch.models.quantize import quantize_model_params

    cpu = torch.device("cpu")
    fp = init_lm(cfg, 0, device=dev)
    card, _ = calibrate(dev, cfg, fp, "ptq")
    host, _ = calibrate(cpu, cfg, copy.deepcopy(fp).to(cpu), "ptq")
    require(sorted(card) == sorted(host), f"tap names differ: card "
            f"{sorted(card)} CPU {sorted(host)}")
    worst = {}
    for name, st in card.items():
        ref = host[name]
        require(st.count == ref.count == CALIB_BATCHES * CALIB_BATCH
                * CALIB_SEQ, f"{name}: counts {st.count} / {ref.count}")
        for moment in ("sum_abs", "sum_sq", "autocorr"):
            a, b = getattr(st, moment).cpu(), getattr(ref, moment)
            rel = float((a - b).abs().max() / b.abs().max())
            worst[moment] = max(worst.get(moment, 0.0), rel)
    log("ptq", "card vs CPU moments, max |Δ| / max|moment| over "
        f"{len(card)} tap names: " + ", ".join(
            f"{k} {v:.3e}" for k, v in worst.items())
        + f" (tol {MOMENT_TOL:.0e}); counts equal")
    require(all(v <= MOMENT_TOL for v in worst.values()),
            "card and CPU calibration moments disagree")
    del host

    batch = host_batch(data_config_for(cfg, CALIB_SEQ, CALIB_BATCH, 0), 999,
                       device=dev)

    def losses(model) -> tuple:
        with torch.no_grad():
            got = [float(lm_loss(Ctx(fused=f), model, batch))
                   for f in ("auto", "off")]
        require(all(math.isfinite(v) for v in got), f"lm_loss {got}")
        require(abs(got[0] - got[1]) <= LOSS_TOL * max(1.0, abs(got[1])),
                f"lm_loss through the kernels {got[0]} vs fused=off {got[1]}")
        return got[0], got[1]

    out = {"fp": dict(loss=losses(fp))}
    log("ptq", f"held-out lm_loss (step 999, {CALIB_BATCH} × {CALIB_SEQ}), "
        f"fp: {out['fp']['loss'][0]:.6f} (fused=off "
        f"{out['fp']['loss'][1]:.6f})")
    errs = {}
    for method in ("w-only", "qer", "srr", "srr-joint"):
        model = copy.deepcopy(fp)
        t0 = time.perf_counter()
        model, reports = quantize_model_params(
            model, srr_ptq(method=method, exact_svd=True),
            container="int8", stats=dict(card), device=dev)
        torch.cuda.synchronize()
        took = time.perf_counter() - t0
        errs[method] = {r.name: r for r in reports}
        n = len(reports)
        out[method] = dict(
            loss=losses(model), seconds=took,
            mean_k=sum(r.k_star for r in reports) / n,
            mean_scaled_err=sum(r.scaled_err for r in reports) / n,
            mean_weight_err=sum(r.weight_err for r in reports) / n)
        log("ptq", f"{method:9s} {n} matrices in {took:.2f} s: mean k* "
            f"{out[method]['mean_k']:.2f}, mean scaled error "
            f"{out[method]['mean_scaled_err']:.6f}, mean weight error "
            f"{out[method]['mean_weight_err']:.6f}; held-out lm_loss "
            f"{out[method]['loss'][0]:.6f} (fused=off "
            f"{out[method]['loss'][1]:.6f})")
        del model
    for better, base in (("qer", "w-only"), ("srr-joint", "srr")):
        bad = [name for name, r in errs[better].items()
               if not r.scaled_err <= errs[base][name].scaled_err * (1 + 1e-5)]
        ratio = max(r.scaled_err / errs[base][name].scaled_err
                    for name, r in errs[better].items())
        log("ptq", f"scaled_err({better}) ≤ scaled_err({base})·(1 + 1e-5) on "
            f"{len(errs[better]) - len(bad)}/{len(errs[better])} matrices "
            f"(largest ratio {ratio:.6f})")
        require(not bad, f"{better} loses to {base} on {bad}")
    shared = all(errs["srr"][k].k_star == r.k_star
                 for k, r in errs["srr-joint"].items())
    require(shared, "srr and srr-joint chose different k*")
    out["quantizers"] = quantizer_gates(dev, fp, card)
    del fp
    torch.cuda.empty_cache()
    out["moment_rel_err"] = worst
    return out


# phase "ptq"'s quantizer gates: one phi3 matrix of each shape, by the
# module that holds it and its tap name
QUANTIZER_MATRICES = (("mixer", "wq", "L0.attn.wq"), ("mlp", "up", "L0..up"),
                      ("mlp", "down", "L0..down"))


def quantizer_gates(dev, fp, stats) -> dict:
    """The uniform and GPTQ quantizers (``make_quantizer``) on one phi3
    matrix of each shape (3072², 3072×8192, 8192×3072) of layer 0: the
    uniform codes, scales and zeros on the card bit for bit the CPU's,
    symmetric and asymmetric, at 3 bits in groups of 32; GPTQ, bound to
    the matrix's calibration Hessian H = Σxxᵀ / n, with a proxy error
    tr((W − Q)ᵀ H (W − Q)) below uniform round-to-nearest's (the same
    group scales), and its seconds on the card."""
    import torch
    from repro_torch.quant import QuantizerConfig, make_quantizer

    out = {}
    for owner, name, key in QUANTIZER_MATRICES:
        w = getattr(getattr(fp.blocks[0], owner), name).w
        shape = "x".join(str(d) for d in w.shape)
        for symmetric in (True, False):
            q = make_quantizer(QuantizerConfig(kind="uniform", bits=3,
                                               block_size=32,
                                               symmetric=symmetric))
            card, host = q.quantize(w), q.quantize(w.cpu())
            bad = [f for f in ("codes", "scales", "zeros")
                   if not torch.equal(getattr(card, f).cpu(),
                                      getattr(host, f))]
            require(not bad, f"uniform {shape} symmetric={symmetric}: "
                    f"{bad} differ between the card and the CPU")
        st = stats[key]
        h = st.autocorr / st.count
        cfg = QuantizerConfig(kind="gptq", bits=3, block_size=32)
        gptq = make_quantizer(cfg, h)
        rtn = make_quantizer(dataclasses.replace(cfg, kind="uniform"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        qg = gptq.fake_quant(w)
        torch.cuda.synchronize()
        took = time.perf_counter() - t0

        def proxy(q_):
            e = (w - q_).double()
            return float((e * (h.double() @ e)).sum())

        err_g, err_r = proxy(qg), proxy(rtn.fake_quant(w))
        log("ptq", f"{key} {shape}: uniform codes/scales/zeros card = CPU "
            f"(symmetric and asymmetric); proxy tr((W−Q)ᵀH(W−Q)) GPTQ "
            f"{err_g:.6e} vs round-to-nearest {err_r:.6e} (ratio "
            f"{err_g / err_r:.4f}); GPTQ {took:.2f} s on the card")
        require(math.isfinite(err_g) and err_g < err_r,
                f"GPTQ does not beat round-to-nearest on {key}")
        out[key] = dict(shape=shape, gptq_proxy=err_g, rtn_proxy=err_r,
                        gptq_s=took)
    return out


def routing_flips(log_a: list, log_b: list) -> int:
    """(token, layer) pairs whose top-k expert sets differ between two
    runs' routing logs."""
    flips = 0
    for a, b in zip(log_a, log_b):
        flips += int((a.sort(dim=-1).values != b.sort(dim=-1).values)
                     .any(dim=-1).sum())
    return flips


# deepseek-moe-16b's layers in phase 6 (of 28): the dense lead-in and
# one MoE layer, every width and so every kernel shape as published; the
# whole depth took 227 s of the script's time, which phase "dense"
# needed, and with phase "train" the script took 1005 s at 8 layers on
# an H100 80GB HBM3 at 700 W, and a slower host's run 1191 s at 4
MOE_LAYERS = 2


def phase_moe(dev) -> dict:
    """Phase 6: deepseek-moe-16b at full width, init → calibration →
    qera-exact SRR (K7) → serve."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import make_requests
    from repro_torch.models import Ctx, init_cache, init_lm, prefill
    from repro_torch.models.quantize import quantize_model_params
    from repro_torch.serve import Engine, ServeConfig

    cfg = dataclasses.replace(get_config("deepseek-moe-16b"),
                              n_layers=MOE_LAYERS)
    gib = 2.0 ** 30
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = init_lm(cfg, 0, device=dev)
    torch.cuda.synchronize()
    log("moe", f"init_lm {cfg.name}: {cfg.n_layers} layers ({cfg.first_dense}"
        f" dense, d_ff {cfg.d_ff}) d_model {cfg.d_model} heads {cfg.n_heads} "
        f"head_dim {cfg.head_dim_} experts {cfg.n_routed} routed + "
        f"{cfg.n_shared} shared top-{cfg.top_k} d_expert {cfg.d_expert} vocab "
        f"{cfg.vocab} in {time.perf_counter() - t0:.2f} s; f32 "
        f"{torch.cuda.memory_allocated() / gib:.2f} GiB")
    stats, t_calib = calibrate(dev, cfg, model, "moe")
    peak_calib = torch.cuda.max_memory_allocated() / gib
    reset_counts()
    t0 = time.perf_counter()
    model, reports = quantize_model_params(
        model, srr_ptq(), container="int8", stats=stats, device=dev)
    torch.cuda.synchronize()
    t_quant = time.perf_counter() - t0
    ptq_counts = launch_counts()
    require(not stats, "the pass left calibration statistics behind")
    peak = torch.cuda.max_memory_allocated() / gib
    mean_k = sum(r.k_star for r in reports) / len(reports)
    log("moe", f"qera-exact SRR (routed experts: identity) quantized "
        f"{len(reports)} matrices in {t_quant:.2f} s, scalings built in the "
        f"pass, each layer's statistics released after it (rank 16, 3-bit "
        f"MXINT b32, mean k* {mean_k:.2f}); K7 launches {ptq_counts['K7']}; "
        f"peak memory of init + calibration {peak_calib:.2f} GiB, of init + "
        f"calibration + PTQ {peak:.2f} GiB; int8 model "
        f"{torch.cuda.memory_allocated() / gib:.2f} GiB")
    require(ptq_counts["K7"] >= 2 * len(reports),
            f"the PTQ pass did not quantize through K7: {ptq_counts}")

    sc = ServeConfig(max_len=512, decode_batch=8, prefill_len=256,
                     kv_dtype="bf16", fused="auto", max_new_tokens=32)
    lengths = [150 + (100 * i) // 7 for i in range(8)]
    serve(Engine(model, cfg, sc, device=dev),
          make_requests(cfg, 2, seed=1, lengths=[40, 60]))     # warm-up
    eng = Engine(model, cfg, sc, device=dev)
    reqs = make_requests(cfg, 8, seed=0, lengths=lengths)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    results, steps, wall = serve(eng, reqs)
    counts = launch_counts()
    n_tok = sum(len(r.tokens) for r in results)
    ttft = [r.ttft_s for r in results]
    step_ms = 1e3 * sum(steps) / len(steps)
    log("moe", f"served {len(results)} requests, {n_tok} tokens in "
        f"{wall:.3f} s: {n_tok / wall:.1f} tok/s; TTFT first "
        f"{1e3 * min(ttft):.1f} ms mean {1e3 * sum(ttft) / len(ttft):.1f} ms "
        f"max {1e3 * max(ttft):.1f} ms; decode step {step_ms:.2f} ms over "
        f"{len(steps)} decode-only steps ({8 / step_ms * 1e3:.1f} tok/s at 8 "
        f"lanes); peak memory while serving "
        f"{torch.cuda.max_memory_allocated() / gib:.2f} GiB")
    log("moe", f"kernel launches in the run: {counts}")
    require(len(results) == 8 and all(len(r.tokens) == 32 for r in results),
            f"expected 8 requests × 32 tokens, got "
            f"{[len(r.tokens) for r in results]}")
    require(all(0 <= t < cfg.vocab for r in results for t in r.tokens),
            "a token outside the vocabulary")
    require(all(counts[k] > 0 for k in ("K1", "K2", "K3", "K4", "K6")),
            f"a kernel of the MoE path never launched: {counts}")
    prof = profile_decode(eng, cfg, make_requests(cfg, 8, seed=4,
                                                  lengths=lengths), tag="moe")
    log("moe", f"K6 (qlr_stacked_kernel) {prof['stacked_ms']:.3f} ms of "
        f"device time a decode step; finishing kernel "
        f"{prof['finish_ms']:.3f} ms, aten::bmm calls {prof['bmm_calls']}")
    require(prof["stacked_ms"] > 0, "K6 took no device time in the profile")
    require(prof["finish_ms"] == 0 and prof["bmm_calls"] == 0,
            "a finishing kernel or an x·L bmm ran in the MoE decode step")
    del eng

    # kernels vs fused="off" on one prompt (150 tokens: capacity 17, so
    # the dispatch drops assignments), under one routing
    tokens = torch.from_numpy(reqs[0].prompt).long()[None].to(dev)
    n = torch.tensor([tokens.shape[1]], dtype=torch.int32, device=dev)
    logit, routes = {}, {}
    for fused in ("auto", "off"):
        routes[fused] = []
        ctx = Ctx(fused=fused, route_log=routes[fused])
        logit[fused] = prefill(ctx, model, tokens,
                               init_cache(cfg, 1, 512, torch.bfloat16, dev),
                               lengths=n)[0].float()
    flips = routing_flips(routes["auto"], routes["off"])
    scale = float(logit["off"].abs().max())
    err = float((logit["auto"] - logit["off"]).abs().max())
    held = "fused=off"
    if flips:
        ctx = Ctx(fused="off", route_replay=iter(routes["auto"]))
        replayed = prefill(ctx, model, tokens,
                           init_cache(cfg, 1, 512, torch.bfloat16, dev),
                           lengths=n)[0].float()
        scale = float(replayed.abs().max())
        log("moe", f"{flips} (token, layer) routing flips between the kernel "
            f"run and fused=off (max |Δ| {err:.3e} there); fused=off replays "
            f"the kernel run's expert choices")
        err = float((logit["auto"] - replayed).abs().max())
        held = "fused=off under the kernel run's routing"
    require(bool(torch.isfinite(logit["auto"]).all()), "non-finite logits")
    log("moe", f"prefill logits ({tokens.shape[1]} tokens, "
        f"{len(routes['auto'])} MoE layers), kernels vs {held}: routing flips "
        f"{flips}, max |Δ| {err:.3e} (max |logit| {scale:.3f}, tol "
        f"{1e-3 * max(1.0, scale):.3e})")
    require(err <= 1e-3 * max(1.0, scale), "the MoE kernel path disagrees "
            "with the dequantize-then-matmul baseline")
    del model
    torch.cuda.empty_cache()
    return dict(counts=counts, ptq_counts=ptq_counts, tok_s=n_tok / wall,
                step_ms=step_ms, ttft_ms=[1e3 * t for t in ttft],
                calibration_s=t_calib, peak_gib_calibration=peak_calib,
                quantize_s=t_quant, matrices=len(reports), mean_k=mean_k,
                peak_gib_ptq=peak, profile=prof, routing_flips=flips,
                logit_err=err)


# ---------------------------------------------------------------------------
# phase "dense": chatglm3-6b and minitron-4b at full width
# ---------------------------------------------------------------------------
# (arch, layers run: None for the published depth, paged run too, build
# the scalings ahead of the pass). chatglm3-6b and minitron-4b run 8 of
# their 28 and 32 layers: at full depth the phase took 240–256 s of the
# script's 1200 s limit, and every width, and so every kernel shape, is
# the same at 8. chatglm3-6b's scalings are built inside the pass, one
# layer at a time, as at its full depth, where S and S⁻¹ of its 112
# moment sets (2 × 26 GB) would not fit beside the f32 model and Σxxᵀ.
# qwen1.5-32b runs at all 64 layers in phase "depth", built a block at a
# time.
DENSE_RUNS = (("chatglm3-6b", 8, True, False),
              ("minitron-4b", 8, True, True))
# the QKV biases filled before calibration: N(0, BIAS_STD²) from a seed
BIAS_STD = 0.1


def fill_qkv_biases(model, seed: int) -> int:
    """Fill the zero wq/wk/wv biases ``init_lm`` gives a ``qkv_bias``
    config with seeded values, so the bias path carries real numbers;
    returns how many were filled."""
    import torch
    gen = torch.Generator(device=model.device).manual_seed(seed)
    return fill_block_biases(model.blocks, gen)


def fill_block_biases(blocks, gen) -> int:
    """:func:`fill_qkv_biases`'s draws from ``gen`` over ``blocks``, in
    order: a block-at-a-time build that passes its blocks here as it
    draws them gets the same biases."""
    n = 0
    for blk in blocks:
        for p in (blk.mixer.wq, blk.mixer.wk, blk.mixer.wv):
            if p.b is not None:
                p.b.normal_(0.0, BIAS_STD, generator=gen)
                n += 1
    return n


def dense_model(dev, cfg, tag: str, ahead: bool) -> tuple:
    """``init_lm`` (seed 0), biases filled (seed 11) → calibration (phase
    4's batches) → qera-exact SRR (rank 16, 3-bit MXINT, int8 container),
    with K7's launches read around the pass; the scalings built ahead and
    timed apart when ``ahead``, else inside the pass, each layer's
    released with its statistics. Returns (model, stats of the pass)."""
    import torch
    from repro_torch.models import init_lm
    from repro_torch.models.quantize import quantize_model_params

    gib = 2.0 ** 30
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = init_lm(cfg, 0, device=dev)
    biases = fill_qkv_biases(model, 11)
    torch.cuda.synchronize()
    log(tag, f"init_lm {cfg.name}: {cfg.n_layers} layers d_model "
        f"{cfg.d_model} heads {cfg.n_heads} kv {cfg.n_kv_heads} (G "
        f"{cfg.n_heads // cfg.n_kv_heads}) head_dim {cfg.head_dim_} d_ff "
        f"{cfg.d_ff} vocab {cfg.vocab} rope {cfg.rope_kind} θ "
        f"{cfg.rope_theta:g} in {time.perf_counter() - t0:.2f} s; f32 "
        f"{torch.cuda.memory_allocated() / gib:.2f} GiB; {biases} QKV biases "
        f"filled")
    stats, t_calib = calibrate(dev, cfg, model, tag)
    t_scaling = build_scalings(stats) if ahead else None
    reset_counts()
    t0 = time.perf_counter()
    model, reports = quantize_model_params(
        model, srr_ptq(), container="int8", stats=stats, device=dev)
    torch.cuda.synchronize()
    t_quant = time.perf_counter() - t0
    ptq_counts = launch_counts()
    require(not stats, "the pass left calibration statistics behind")
    peak = torch.cuda.max_memory_allocated() / gib
    mean_k = sum(r.k_star for r in reports) / len(reports)
    log(tag, ("qera-exact scalings built ahead in "
              f"{t_scaling:.2f} s; " if ahead else
              "qera-exact scalings built in the pass; ")
        + f"SRR quantized {len(reports)} matrices in {t_quant:.2f} s (rank "
        f"16, 3-bit MXINT b32, mean k* {mean_k:.2f}); K7 launches "
        f"{ptq_counts['K7']}; peak memory of init + calibration + PTQ "
        f"{peak:.2f} GiB; int8 model "
        f"{torch.cuda.memory_allocated() / gib:.2f} GiB")
    require(ptq_counts["K7"] >= 2 * len(reports),
            f"the PTQ pass did not quantize through K7: {ptq_counts}")
    require(all(blk.mixer.wk.b is not None for blk in model.blocks)
            == cfg.qkv_bias, "the pass dropped a QKV bias")
    return model, dict(calibration_s=t_calib, scaling_s=t_scaling,
                       quantize_s=t_quant, peak_gib=peak, mean_k=mean_k,
                       matrices=len(reports), ptq_counts=ptq_counts)


def serve_dense(dev, cfg, model, tag: str, paged: bool) -> dict:
    """Phase 4's serving (8 prompts of 150–250 tokens, 8 lanes, bf16 KV)
    or, ``paged``, phase 4b's (16 prompts sharing a 256-token prefix,
    pages of 16, a 520-token step budget), with the launch counts read
    around the run; unpaged, then profiled decode steps."""
    import torch
    from repro_torch.launch.serve import make_requests
    from repro_torch.serve import Engine

    sc = paged_serve_config() if paged else main_serve_config()
    warm = shared_prefix_requests(cfg, 2, seed=7) if paged else \
        make_requests(cfg, 2, seed=1, lengths=[40, 60])
    serve(Engine(model, cfg, sc, device=dev), warm)
    eng = Engine(model, cfg, sc, device=dev)
    reqs = shared_prefix_requests(cfg, 16, seed=6) if paged else \
        make_requests(cfg, 8, seed=0, lengths=MAIN_LENGTHS)
    reset_counts()
    results, steps, wall = serve(eng, reqs)
    counts = launch_counts()
    n_tok = sum(len(r.tokens) for r in results)
    ttft = [r.ttft_s for r in results]
    step_ms = 1e3 * sum(steps) / len(steps)
    st = eng.stats()
    log(tag, f"{'paged' if paged else 'unpaged'}: served {len(results)} "
        f"requests, {n_tok} tokens in {wall:.3f} s: {n_tok / wall:.1f} tok/s;"
        f" TTFT first {1e3 * min(ttft):.1f} ms mean "
        f"{1e3 * sum(ttft) / len(ttft):.1f} ms max {1e3 * max(ttft):.1f} ms; "
        f"decode step {step_ms:.2f} ms over {len(steps)} decode-only steps"
        + (f"; prefix hit rate {st['prefix_hit_rate']:.4f}" if paged else ""))
    log(tag, f"kernel launches in the run: {counts}")
    require(len(results) == len(reqs)
            and all(len(r.tokens) == 32 for r in results),
            f"expected {len(reqs)} requests × 32 tokens, got "
            f"{[len(r.tokens) for r in results]}")
    require(all(0 <= t < cfg.vocab for r in results for t in r.tokens),
            "a token outside the vocabulary")
    path = ("K1", "K2", "K4", "K5") if paged else ("K1", "K2", "K3", "K4")
    require(all(counts[k] > 0 for k in path),
            f"a kernel of the path never launched: {counts}")
    require(counts["K3" if paged else "K5"] == 0,
            f"the other decode kernel launched: {counts}")
    out = dict(counts=counts, tok_s=n_tok / wall, step_ms=step_ms,
               decode_steps=len(steps), ttft_ms=[1e3 * t for t in ttft],
               engine_decode_steps=eng.sched.stats.decode_steps,
               admissions=eng.sched.stats.admitted)
    if paged:
        require(st["prefix_hit_tokens"] > 0, "the prefix cache served no "
                "prompt token")
        out["prefix_hit_rate"] = st["prefix_hit_rate"]
    else:
        out["profile"] = profile_decode(
            eng, cfg, make_requests(cfg, 8, seed=4, lengths=MAIN_LENGTHS),
            tag=tag)
    del eng
    torch.cuda.empty_cache()
    return out


def dense_logits(dev, cfg, model, tag: str, cpu: bool = True) -> dict:
    """A 150-token prompt's prefill logits through the kernels against
    ``fused="off"`` on the card and, with ``cpu``, against the CPU (the
    model moved there last: the plain versions at full width)."""
    import numpy as np
    import torch
    from repro_torch.models import Ctx, init_cache, prefill

    prompt = np.random.default_rng(9).integers(0, cfg.vocab, 150)

    def run(fused: str, d) -> torch.Tensor:
        tokens = torch.from_numpy(prompt).long()[None].to(d)
        n = torch.tensor([150], dtype=torch.int32, device=d)
        return prefill(Ctx(fused=fused), model, tokens,
                       init_cache(cfg, 1, 256, torch.bfloat16, d),
                       lengths=n)[0].float().cpu()

    logit = {"auto": run("auto", dev), "off": run("off", dev)}
    scale = float(logit["off"].abs().max())
    tol = 1e-3 * max(1.0, scale)
    err_off = float((logit["auto"] - logit["off"]).abs().max())
    out = dict(logit_err_off=err_off, max_logit=scale)
    line = (f"prefill logits (150 tokens), kernels vs fused=off: max |Δ| "
            f"{err_off:.3e}")
    if cpu:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.to("cpu")
        logit["cpu"] = run("auto", torch.device("cpu"))
        out["cpu_s"] = time.perf_counter() - t0
        out["logit_err_cpu"] = float(
            (logit["auto"] - logit["cpu"]).abs().max())
        line += (f"; vs the CPU (plain versions, {out['cpu_s']:.1f} s): max "
                 f"|Δ| {out['logit_err_cpu']:.3e}")
    log(tag, line + f" (max |logit| {scale:.3f}, tol {tol:.3e})")
    require(bool(torch.isfinite(logit["auto"]).all()), "non-finite logits")
    require(err_off <= tol, "the kernel path disagrees with fused=off")
    if cpu:
        require(out["logit_err_cpu"] <= tol, "card and CPU logits disagree")
    return out


def phase_dense(dev) -> dict:
    """Phase "dense": each of ``DENSE_RUNS`` at full width through
    :func:`dense_model`, :func:`serve_dense` (unpaged, then paged where
    listed), minitron-4b's sampler at V = 256,000 (``check_sampler``),
    and :func:`dense_logits`; the model is dropped before the next."""
    import torch
    from repro_torch.configs import get_config

    out = {}
    for arch, layers, paged, ahead in DENSE_RUNS:
        t0 = time.perf_counter()
        cfg = get_config(arch)
        if layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        tag = f"dense {arch}"
        model, run = dense_model(dev, cfg, tag, ahead)
        run["unpaged"] = serve_dense(dev, cfg, model, tag, False)
        if paged:
            run["paged"] = serve_dense(dev, cfg, model, tag, True)
        if arch == "minitron-4b":
            run["sampler"] = check_sampler(dev, model, cfg, tag)
        run.update(dense_logits(dev, cfg, model, tag))
        run["layers"] = cfg.n_layers
        del model
        torch.cuda.empty_cache()
        run["seconds"] = time.perf_counter() - t0
        log(tag, f"took {run['seconds']:.1f} s")
        out[arch] = run
    return out


# ---------------------------------------------------------------------------
# phase "depth": qwen1.5-32b built a block at a time, at all 64 layers
# ---------------------------------------------------------------------------
DEPTH_ARCH = "qwen1.5-32b"
# (a): the two builds compared bit for bit, at full width
DEPTH_CHECK_LAYERS = 2
# (b): the serving CLI's own build, at the published size
DEPTH_ARGS = ["--arch", DEPTH_ARCH, "--full"]
# a build's stages as its progress hook names them → the log's names
DEPTH_STAGES = {"tail": "init", "draw": "init", "calibrate": "calibration",
                "scale": "scalings", "quantize": "SRR"}


class StageClock:
    """A block-at-a-time build's ``progress`` hook: synchronized seconds
    and the peak GiB allocated, by stage (``DEPTH_STAGES``), and the most
    blocks that held an ``FpLinear`` at once. The clock starts when it is
    made, so the source's drawing walk counts to "init"."""

    def __init__(self):
        import torch
        self.seconds = {v: 0.0 for v in DEPTH_STAGES.values()}
        self.peak_gib = {v: 0.0 for v in DEPTH_STAGES.values()}
        self.most_fp = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        self.t = time.perf_counter()

    def __call__(self, step) -> None:
        import torch
        from repro_torch.models.linear import FpLinear
        torch.cuda.synchronize()
        stage = DEPTH_STAGES[step.stage]
        self.seconds[stage] += time.perf_counter() - self.t
        self.peak_gib[stage] = max(self.peak_gib[stage],
                                   torch.cuda.max_memory_allocated() / 2**30)
        self.most_fp = max(self.most_fp, sum(
            any(isinstance(m, FpLinear) for m in blk.modules())
            for blk in step.blocks))
        torch.cuda.reset_peak_memory_stats()
        self.t = time.perf_counter()

    def line(self) -> str:
        return ", ".join(f"{k} {v:.2f} s (peak {self.peak_gib[k]:.2f} GiB)"
                         for k, v in self.seconds.items())


def depth_equal(dev, tag: str) -> dict:
    """(a) qwen1.5-32b at full width and ``DEPTH_CHECK_LAYERS`` layers,
    built twice from the same draws (QKV biases from seed 11) and phase
    4's calibration batches: by ``dense_model``'s path (``init_lm`` →
    calibration → ``quantize_model_params``, the scalings in the pass)
    and by ``models.build`` (``DrawnBlocks`` with the biases filled as
    each block is drawn); every buffer and every report's (name, k*)
    must be equal, bit for bit."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import data_config_for
    from repro_torch.models import init_lm
    from repro_torch.models.build import DrawnBlocks, build_quantized_lm
    from repro_torch.models.quantize import quantize_model_params

    cfg = dataclasses.replace(get_config(DEPTH_ARCH),
                              n_layers=DEPTH_CHECK_LAYERS)
    gib = 2.0 ** 30
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    whole = init_lm(cfg, 0, device=dev)
    fill_qkv_biases(whole, 11)
    stats, _ = calibrate(dev, cfg, whole, tag)
    whole, reports = quantize_model_params(whole, srr_ptq(), stats=stats,
                                           device=dev)
    torch.cuda.synchronize()
    t_whole = time.perf_counter() - t0
    peak_whole = torch.cuda.max_memory_allocated() / gib

    class Biased(DrawnBlocks):
        def __init__(self):
            super().__init__(cfg, 0, device=dev)
            self.bias_gen = torch.Generator(device=dev).manual_seed(11)

        def block(self, i):
            blk = super().block(i)
            fill_block_biases([blk], self.bias_gen)
            return blk

    clock = StageClock()
    streamed, reports_b = build_quantized_lm(
        Biased(), srr_ptq(), data_config_for(cfg, seq_len=CALIB_SEQ,
                                             global_batch=CALIB_BATCH,
                                             seed=0),
        CALIB_BATCHES, progress=clock, device=dev)
    t_streamed = sum(clock.seconds.values())
    a, b = whole.state_dict(), streamed.state_dict()
    differ = [k for k in a if k not in b or a[k].dtype != b[k].dtype
              or not torch.equal(a[k], b[k])]
    log(tag, f"(a) {cfg.n_layers} layers at full width: whole-model build "
        f"{t_whole:.2f} s, peak {peak_whole:.2f} GiB; block at a time "
        f"{t_streamed:.2f} s ({clock.line()}); {len(a)} buffers, "
        f"{len(differ)} differ; most fp blocks at once {clock.most_fp}")
    for k in differ[:8]:
        log(tag, f"  {k}: max |Δ| "
            f"{float((a[k].double() - b[k].double()).abs().max()):.3e}")
    require(sorted(a) == sorted(b) and not differ,
            f"the block-at-a-time build differs from the whole-model build "
            f"in {differ[:8]}")
    require([(r.name, r.k_star) for r in reports]
            == [(r.name, r.k_star) for r in reports_b],
            "the two builds' reports differ")
    require(clock.most_fp == 1, f"{clock.most_fp} fp blocks at once")
    n_buffers = len(a)
    del whole, streamed, a, b
    torch.cuda.empty_cache()
    return dict(layers=cfg.n_layers, buffers=n_buffers,
                matrices=len(reports), whole_s=t_whole,
                whole_peak_gib=peak_whole, streamed_s=t_streamed,
                stage_s=clock.seconds, stage_peak_gib=clock.peak_gib)


def phase_depth(dev) -> dict:
    """Phase "depth": (a) :func:`depth_equal`; (b) qwen1.5-32b at full
    width and all 64 layers, built by the serving CLI's
    ``build_quantized_model`` on its own arguments (``--arch qwen1.5-32b
    --full``: calibration on 2 batches of 4 × 32 tokens, qera-exact SRR,
    rank 16, 3-bit MXINT) a block at a time, with the seconds and peak
    GiB of each stage and K7's launches read around it; then
    :func:`serve_dense` unpaged (every launch count as the layout gives
    it: K1 448 and K3 64 a decode step, K5 never) with profiled decode
    steps, and :func:`dense_logits` on the card (no CPU leg: it would
    move 44 GB to the host)."""
    import torch
    from repro_torch.launch.serve import build_quantized_model, parser

    tag = "depth"
    out = {"a": depth_equal(dev, tag)}
    gib = 2.0 ** 30
    args = parser().parse_args(DEPTH_ARGS)
    clock = StageClock()
    reset_counts()
    model, cfg = build_quantized_model(args, tag=tag, progress=clock)
    ptq_counts = launch_counts()
    peak = max(clock.peak_gib.values())
    resident = torch.cuda.memory_allocated() / gib
    n_mat = 7 * cfg.n_layers
    log(tag, f"(b) {cfg.name} at {cfg.n_layers} layers through "
        f"build_quantized_model({' '.join(DEPTH_ARGS)}): "
        f"{sum(clock.seconds.values()):.2f} s ({clock.line()}); K7 "
        f"launches {ptq_counts['K7']}; peak {peak:.2f} GiB, resident after "
        f"the build {resident:.2f} GiB; most fp blocks at once "
        f"{clock.most_fp}")
    require(clock.most_fp == 1, f"{clock.most_fp} fp blocks at once")
    require(ptq_counts["K7"] >= 2 * n_mat,
            f"the pass did not quantize through K7: {ptq_counts}")
    require(peak < 80.0, f"the build peaked at {peak:.2f} GiB")
    run = {"unpaged": serve_dense(dev, cfg, model, tag, False)}
    steps = run["unpaged"]["engine_decode_steps"]
    counts = run["unpaged"]["counts"]
    want = {"K1": n_mat * steps, "K3": cfg.n_layers * steps, "K5": 0}
    require(all(counts[k] == v for k, v in want.items()),
            f"launches {counts}, the layout gives {want} ({steps} decode "
            f"steps)")
    run.update(dense_logits(dev, cfg, model, tag, cpu=False))
    run.update(layers=cfg.n_layers, stage_s=clock.seconds,
               stage_peak_gib=clock.peak_gib, peak_gib=peak,
               resident_gib=resident, ptq_counts=ptq_counts,
               matrices=n_mat)
    del model
    torch.cuda.empty_cache()
    out["b"] = run
    return out


# ---------------------------------------------------------------------------
# phase "mla": deepseek-v2-lite-16b at full width
# ---------------------------------------------------------------------------
# deepseek-v2-lite-16b's layers in phase "mla" (of 27): the dense lead-in
# and 7 MoE layers, every width as published (the f32 model at full depth
# is about 63 GB; 8 layers keep the phase near phase 6's time)
MLA_LAYERS = 8


def mla_decode_logits(dev, cfg, model, reqs) -> dict:
    """One decode step's logits over 8 prefilled lanes through the kernels
    (K3 at the latent head, K1, K6) against ``fused="off"`` (the two-einsum
    latent form, dequantize-then-matmul) on copies of one cache, under one
    routing (the ``fused="off"`` run replays the kernel run's choices)."""
    import torch
    from repro_torch.models import Ctx, decode_step, init_cache, prefill

    width = max(len(r.prompt) for r in reqs)
    tokens = torch.zeros((len(reqs), width), dtype=torch.long)
    for i, r in enumerate(reqs):
        tokens[i, :len(r.prompt)] = torch.from_numpy(r.prompt).long()
    n = torch.tensor([len(r.prompt) for r in reqs], dtype=torch.int32,
                     device=dev)
    logits, cache = prefill(Ctx(), model, tokens.to(dev),
                            init_cache(cfg, len(reqs), 512, torch.bfloat16,
                                       dev), lengths=n)
    tok = logits[:, -1].argmax(-1)[:, None]
    route = []
    out = {}
    for fused in ("auto", "off"):
        ctx = Ctx(fused=fused, route_log=route) if fused == "auto" else \
            Ctx(fused=fused, route_replay=iter(route))
        step_cache = [{k: v.clone() for k, v in c.items()} for c in cache]
        out[fused] = decode_step(ctx, model, tok, step_cache)[0].float()
    scale = float(out["off"].abs().max())
    err = float((out["auto"] - out["off"]).abs().max())
    require(bool(torch.isfinite(out["auto"]).all()), "non-finite logits")
    return dict(err=err, scale=scale, routed_layers=len(route))


def phase_mla(dev) -> dict:
    """Phase "mla": deepseek-v2-lite-16b (MLA over the MoE, its first
    ``MLA_LAYERS`` layers at full width) → calibration as in phase 4 →
    qera-exact SRR (rank 16, 3-bit MXINT, int8; scalings built ahead and
    timed apart) → phase 4's unpaged serving with bf16 latents (K3 at the
    latent head exactly decode steps × layers times, K4 never), profiled
    decode steps, the int8-KV engine (bf16 latents: the same tokens), and
    prefill and one decode step's logits through the kernels against
    ``fused="off"`` under one routing."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import make_requests
    from repro_torch.models import Ctx, init_cache, init_lm, prefill
    from repro_torch.models.quantize import quantize_model_params
    from repro_torch.serve import Engine

    cfg = dataclasses.replace(get_config("deepseek-v2-lite-16b"),
                              n_layers=MLA_LAYERS)
    tag = "mla"
    gib = 2.0 ** 30
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = init_lm(cfg, 0, device=dev)
    torch.cuda.synchronize()
    log(tag, f"init_lm {cfg.name}: {cfg.n_layers} layers ({cfg.first_dense} "
        f"dense, d_ff {cfg.d_ff}) d_model {cfg.d_model} heads {cfg.n_heads} "
        f"head_dim {cfg.head_dim_} MLA kv_lora_rank {cfg.kv_lora_rank} "
        f"rope_head_dim {cfg.rope_head_dim} (latent head "
        f"{cfg.kv_lora_rank + cfg.rope_head_dim}) experts {cfg.n_routed} "
        f"routed + {cfg.n_shared} shared top-{cfg.top_k} d_expert "
        f"{cfg.d_expert} vocab {cfg.vocab} in {time.perf_counter() - t0:.2f}"
        f" s; f32 {torch.cuda.memory_allocated() / gib:.2f} GiB")
    stats, t_calib = calibrate(dev, cfg, model, tag)
    t_scaling = build_scalings(stats)
    reset_counts()
    t0 = time.perf_counter()
    model, reports = quantize_model_params(
        model, srr_ptq(), container="int8", stats=stats, device=dev)
    torch.cuda.synchronize()
    t_quant = time.perf_counter() - t0
    ptq_counts = launch_counts()
    require(not stats, "the pass left calibration statistics behind")
    peak = torch.cuda.max_memory_allocated() / gib
    mean_k = sum(r.k_star for r in reports) / len(reports)
    attn = [r for r in reports if ".mixer." in r.name]
    log(tag, f"calibration {t_calib:.2f} s; qera-exact scalings built ahead "
        f"in {t_scaling:.2f} s; SRR quantized {len(reports)} matrices "
        f"({len(attn)} MLA projections) in {t_quant:.2f} s (rank 16, 3-bit "
        f"MXINT b32, mean k* {mean_k:.2f}); K7 launches {ptq_counts['K7']}; "
        f"peak memory of init + calibration + PTQ {peak:.2f} GiB; int8 "
        f"model {torch.cuda.memory_allocated() / gib:.2f} GiB")
    require(len(attn) == 6 * cfg.n_layers,
            f"expected 6 MLA projections a layer, got {len(attn)}")
    require(ptq_counts["K7"] >= 2 * len(reports),
            f"the PTQ pass did not quantize through K7: {ptq_counts}")

    sc = main_serve_config()
    serve(Engine(model, cfg, sc, device=dev),
          make_requests(cfg, 2, seed=1, lengths=[40, 60]))     # warm-up
    eng = Engine(model, cfg, sc, device=dev)
    reqs = make_requests(cfg, 8, seed=0, lengths=MAIN_LENGTHS)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    results, steps, wall = serve(eng, reqs)
    counts = launch_counts()
    n_steps = eng.sched.stats.decode_steps
    n_tok = sum(len(r.tokens) for r in results)
    ttft = [r.ttft_s for r in results]
    step_ms = 1e3 * sum(steps) / len(steps)
    log(tag, f"served {len(results)} requests, {n_tok} tokens in {wall:.3f} "
        f"s: {n_tok / wall:.1f} tok/s; TTFT first {1e3 * min(ttft):.1f} ms "
        f"mean {1e3 * sum(ttft) / len(ttft):.1f} ms max "
        f"{1e3 * max(ttft):.1f} ms; decode step {step_ms:.2f} ms over "
        f"{len(steps)} decode-only steps ({n_steps} decode steps in all); "
        f"peak memory while serving "
        f"{torch.cuda.max_memory_allocated() / gib:.2f} GiB")
    log(tag, f"kernel launches in the run: {counts}")
    require(len(results) == 8 and all(len(r.tokens) == 32 for r in results),
            f"expected 8 requests × 32 tokens, got "
            f"{[len(r.tokens) for r in results]}")
    require(all(0 <= t < cfg.vocab for r in results for t in r.tokens),
            "a token outside the vocabulary")
    require(counts["K3"] == n_steps * cfg.n_layers,
            f"K3 launched {counts['K3']} times, not {n_steps} decode steps "
            f"× {cfg.n_layers} layers")
    require(counts["K4"] == 0 and counts["K5"] == 0,
            f"MLA prefill or decode launched K4/K5: {counts}")
    require(all(counts[k] > 0 for k in ("K1", "K2", "K6")),
            f"a kernel of the path never launched: {counts}")
    prof = profile_decode(eng, cfg, make_requests(cfg, 8, seed=4,
                                                  lengths=MAIN_LENGTHS),
                          tag=tag)
    del eng

    # int8 KV: JAX's float rule keeps the latents in bf16, so the tokens
    # are the bf16 engine's
    eng8 = Engine(model, cfg, main_serve_config(kv_dtype="int8"), device=dev)
    results8, _, _ = serve(eng8, make_requests(cfg, 8, seed=0,
                                               lengths=MAIN_LENGTHS))
    same = sum(a.tokens.tolist() == b.tokens.tolist()
               for a, b in zip(results, results8))
    log(tag, f"int8 KV engine (bf16 latents): {same}/8 requests' tokens "
        f"equal the bf16 engine's; latent cache dtype "
        f"{eng8.slots.cache[0]['lat'].dtype}")
    require(same == 8, "the int8-KV engine's tokens differ from bf16's")
    del eng8

    # prefill logits, kernels vs fused="off", under one routing
    tokens = torch.from_numpy(reqs[0].prompt).long()[None].to(dev)
    n = torch.tensor([tokens.shape[1]], dtype=torch.int32, device=dev)
    route = []
    logit = {}
    for fused in ("auto", "off"):
        ctx = Ctx(fused=fused, route_log=route) if fused == "auto" else \
            Ctx(fused=fused, route_replay=iter(route))
        logit[fused] = prefill(ctx, model, tokens,
                               init_cache(cfg, 1, 512, torch.bfloat16, dev),
                               lengths=n)[0].float()
    scale = float(logit["off"].abs().max())
    err = float((logit["auto"] - logit["off"]).abs().max())
    require(bool(torch.isfinite(logit["auto"]).all()), "non-finite logits")
    log(tag, f"prefill logits ({tokens.shape[1]} tokens), kernels vs "
        f"fused=off under the kernel run's routing: max |Δ| {err:.3e} (max "
        f"|logit| {scale:.3f}, tol {1e-3 * max(1.0, scale):.3e})")
    require(err <= 1e-3 * max(1.0, scale), "the MLA kernel path disagrees "
            "with fused=off at prefill")
    step = mla_decode_logits(dev, cfg, model, reqs)
    log(tag, f"one decode step's logits (8 lanes, K3 at the latent head), "
        f"kernels vs fused=off under one routing: max |Δ| {step['err']:.3e} "
        f"(max |logit| {step['scale']:.3f}, tol "
        f"{1e-3 * max(1.0, step['scale']):.3e})")
    require(step["err"] <= 1e-3 * max(1.0, step["scale"]),
            "the MLA kernel path disagrees with fused=off at decode")
    del model
    torch.cuda.empty_cache()
    return dict(counts=counts, ptq_counts=ptq_counts, decode_steps=n_steps,
                tok_s=n_tok / wall, step_ms=step_ms,
                ttft_ms=[1e3 * t for t in ttft], calibration_s=t_calib,
                scaling_s=t_scaling, quantize_s=t_quant, peak_gib=peak,
                matrices=len(reports), mean_k=mean_k, profile=prof,
                prefill_logit_err=err, prefill_max_logit=scale,
                decode_logit_err=step["err"],
                decode_max_logit=step["scale"])


# ---------------------------------------------------------------------------
# phase "hybrid": recurrentgemma-9b at full width
# ---------------------------------------------------------------------------
# recurrentgemma-9b's layers in phase "hybrid" (of 38): two (rglru, rglru,
# local) periods and the (rglru, rglru) remainder, every width as
# published. At full depth the f32 model is 41.8 GB and its Σxxᵀ about
# 32 GB, which with the pass's working set does not fit the 80 GB card.
HYBRID_LAYERS = 8
# run (b): two prompts past the 2048-token window, in a 2304-slot cache
RING_LENGTHS = (2100, 2080)


def family_model(dev, cfg, tag: str, prepare=None) -> tuple:
    """``init_lm`` (seed 0) → ``prepare(model)`` where given (it fills
    biases and returns a note for the log) → calibration (phase 4's
    batches) → the qera-exact scalings built ahead (timed) → SRR (rank
    16, 3-bit MXINT, int8 container) with K7's launches read around the
    pass. Phases "hybrid" and "xlstm" share it. Returns (model, stats of
    the pass)."""
    import torch
    from repro_torch.kernels import mxint_quantize
    from repro_torch.models import init_lm
    from repro_torch.models.quantize import quantize_model_params

    gib = 2.0 ** 30
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = init_lm(cfg, 0, device=dev)
    note = prepare(model) if prepare is not None else ""
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in model.buffers())
    log(tag, f"init_lm {cfg.name}: {cfg.n_layers} layers "
        f"{[blk.kind for blk in model.blocks]} d_model {cfg.d_model} d_rnn "
        f"{cfg.d_rnn_} conv {cfg.conv_width} heads {cfg.n_heads} kv "
        f"{cfg.n_kv_heads} head_dim {cfg.head_dim_} window {cfg.window} d_ff "
        f"{cfg.d_ff} vocab {cfg.vocab} norm {cfg.norm} in "
        f"{time.perf_counter() - t0:.2f} s; {n_params / 1e6:.1f} M "
        f"parameters, f32 {torch.cuda.memory_allocated() / gib:.2f} GiB"
        + (f"; {note}" if note else ""))
    stats, t_calib = calibrate(dev, cfg, model, tag)
    t_scaling = build_scalings(stats)
    reset_counts()
    t0 = time.perf_counter()
    model, reports = quantize_model_params(
        model, srr_ptq(), container="int8", stats=stats, device=dev)
    torch.cuda.synchronize()
    t_quant = time.perf_counter() - t0
    ptq_counts = launch_counts()
    k7_shapes = {f"{m}x{n}": c
                 for (m, n), c in mxint_quantize.LAUNCH_SHAPES.items()}
    # a VLM's vision_proj input, recorded under "" as JAX records it, is
    # the one entry no matrix reads
    require(set(stats) <= ({""} if cfg.n_vision_tokens else set()),
            f"the pass left calibration statistics behind: {sorted(stats)}")
    peak = torch.cuda.max_memory_allocated() / gib
    mean_k = sum(r.k_star for r in reports) / len(reports)
    log(tag, f"calibration {t_calib:.2f} s; qera-exact scalings built ahead "
        f"in {t_scaling:.2f} s; SRR quantized {len(reports)} matrices in "
        f"{t_quant:.2f} s (rank 16, 3-bit MXINT b32, mean k* {mean_k:.2f}); "
        f"K7 launches {ptq_counts['K7']}; peak memory of init + calibration "
        f"+ PTQ {peak:.2f} GiB; int8 model "
        f"{torch.cuda.memory_allocated() / gib:.2f} GiB")
    require(ptq_counts["K7"] >= 2 * len(reports),
            f"the PTQ pass did not quantize through K7: {ptq_counts}")
    return model, dict(calibration_s=t_calib, scaling_s=t_scaling,
                       quantize_s=t_quant, peak_gib=peak, mean_k=mean_k,
                       matrices=len(reports), ptq_counts=ptq_counts,
                       k7_shapes=k7_shapes)


def family_logits(dev, cfg, model, reqs, max_len: int,
                  step: bool, frames=None, vision=None) -> dict:
    """The prompts' prefill logits (right-padded, ``lengths``) through the
    kernels against ``fused="off"`` into a bf16 cache of ``max_len``
    slots and, with ``step``, one decode step's logits over the prefilled
    lanes (copies of the kernel run's cache) the same way (and, where the
    model has local layers, the ring's slots and largest position). An
    encoder-decoder encodes ``frames`` (a row a prompt; zeros if None); a
    VLM puts ``vision`` (a row a prompt) in front, its rows counted in
    ``lengths``."""
    import torch
    from repro_torch.models import Ctx, decode_step, init_cache, prefill

    width = max(len(r.prompt) for r in reqs)
    tokens = torch.zeros((len(reqs), width), dtype=torch.long)
    for i, r in enumerate(reqs):
        tokens[i, :len(r.prompt)] = torch.from_numpy(r.prompt).long()
    n_vis = 0 if vision is None else cfg.n_vision_tokens
    n = torch.tensor([len(r.prompt) + n_vis for r in reqs],
                     dtype=torch.int32, device=dev)
    logit, cache = {}, None
    for fused in ("auto", "off"):
        out, c = prefill(Ctx(fused=fused), model, tokens.to(dev),
                         init_cache(cfg, len(reqs), max_len, torch.bfloat16,
                                    dev), lengths=n, frames=frames,
                         vision=vision)
        logit[fused] = out.float()
        cache = cache or c
    res = dict(prefill_err=float((logit["auto"] - logit["off"]).abs().max()),
               prefill_scale=float(logit["off"].abs().max()))
    require(bool(torch.isfinite(logit["auto"]).all()), "non-finite logits")
    if not step:
        return res
    ring = next((c["slot_pos"] for c, blk in zip(cache, model.blocks)
                 if blk.kind == "local"), None)
    if ring is not None:
        res["ring_slots"] = ring.shape[1]
        res["ring_max_pos"] = int(ring.max())
    tok = logit["auto"][:, -1].argmax(-1)[:, None]
    out = {}
    for fused in ("auto", "off"):
        step_cache = [{k: v.clone() for k, v in c.items()} for c in cache]
        out[fused] = decode_step(Ctx(fused=fused), model, tok,
                                 step_cache)[0].float()
    require(bool(torch.isfinite(out["auto"]).all()), "non-finite logits")
    res.update(step_err=float((out["auto"] - out["off"]).abs().max()),
               step_scale=float(out["off"].abs().max()))
    return res


def phase_hybrid(dev) -> dict:
    """Phase "hybrid": recurrentgemma-9b (RG-LRU blocks and sliding-window
    layers) at full width, its first ``HYBRID_LAYERS`` layers →
    :func:`family_model` → (a) phase 4's unpaged serving, bf16 KV (every
    projection through K1 at decode and K2 at prefill, the local layers'
    attention through K3 and K4 at head dim 256; launches exactly as the
    layout gives them), profiled decode steps; (c) the same with int8 KV
    (the same tokens); the drift probe leaving the cache bit for bit;
    ``paged`` and ``speculative`` refused; (b) two prompts of 2100 and 2080
    tokens in a 2304-slot cache (the 2048-slot ring wraps in the prefill
    and the decode; K4 under the live window); the prefill logits of (a)
    and (b) and one decode step's logits after the wrap through the
    kernels against ``fused="off"``, each within 1e-3 · max|logit|."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import make_requests
    from repro_torch.models.linear import QLinear
    from repro_torch.serve import Engine

    cfg = dataclasses.replace(get_config("recurrentgemma-9b"),
                              n_layers=HYBRID_LAYERS)
    tag = "hybrid"
    gib = 2.0 ** 30
    model, run = family_model(dev, cfg, tag)
    n_local = sum(blk.kind == "local" for blk in model.blocks)
    n_proj = sum(isinstance(m, QLinear) for m in model.blocks.modules())

    def check_counts(counts, steps: int, prefills: int, what: str) -> None:
        want = {"K1": steps * n_proj, "K2": prefills * n_proj,
                "K3": steps * n_local, "K4": prefills * n_local, "K5": 0,
                "K6": 0}
        require(all(counts[k] == v for k, v in want.items()),
                f"{what}: launches {counts}, the layout gives {want} "
                f"({steps} decode steps, {prefills} prefills)")

    # (a) phase 4's serving, bf16 KV
    sc = main_serve_config()
    serve(Engine(model, cfg, sc, device=dev),
          make_requests(cfg, 2, seed=1, lengths=[40, 60]))     # warm-up
    eng = Engine(model, cfg, sc, device=dev)
    reqs = make_requests(cfg, 8, seed=0, lengths=MAIN_LENGTHS)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    results, steps, wall = serve(eng, reqs)
    counts = launch_counts()
    n_steps = eng.sched.stats.decode_steps
    n_tok = sum(len(r.tokens) for r in results)
    ttft = [r.ttft_s for r in results]
    step_ms = 1e3 * sum(steps) / len(steps)
    log(tag, f"(a) served {len(results)} requests, {n_tok} tokens in "
        f"{wall:.3f} s: {n_tok / wall:.1f} tok/s; TTFT first "
        f"{1e3 * min(ttft):.1f} ms mean {1e3 * sum(ttft) / len(ttft):.1f} ms "
        f"max {1e3 * max(ttft):.1f} ms; decode step {step_ms:.2f} ms over "
        f"{len(steps)} decode-only steps ({n_steps} decode steps in all); "
        f"peak memory while serving "
        f"{torch.cuda.max_memory_allocated() / gib:.2f} GiB")
    log(tag, f"(a) kernel launches in the run: {counts} ({n_proj} "
        f"projections, {n_local} local layers)")
    require(len(results) == 8 and all(len(r.tokens) == 32 for r in results),
            f"expected 8 requests × 32 tokens, got "
            f"{[len(r.tokens) for r in results]}")
    require(all(0 <= t < cfg.vocab for r in results for t in r.tokens),
            "a token outside the vocabulary")
    check_counts(counts, n_steps, eng.sched.stats.admitted, "(a)")
    prof = profile_decode(eng, cfg, make_requests(cfg, 8, seed=4,
                                                  lengths=MAIN_LENGTHS),
                          tag=tag)
    del eng

    # (c) int8 KV: the local layers' K/V as int8 codes, the RG-LRU
    # states' conv history in bf16 (as under bf16 KV)
    eng8 = Engine(model, cfg, main_serve_config(kv_dtype="int8"), device=dev)
    reset_counts()
    results8, _, _ = serve(eng8, make_requests(cfg, 8, seed=0,
                                               lengths=MAIN_LENGTHS))
    counts8 = launch_counts()
    bad = hold_tokens(dev, cfg, model, reqs,
                      [r.tokens.tolist() for r in results8],
                      [r.tokens.tolist() for r in results],
                      "hybrid int8 KV vs bf16")
    log(tag, f"(c) int8 KV engine: {8 - bad}/8 requests' tokens equal the "
        f"bf16 engine's; local K dtype "
        f"{eng8.slots.cache[2]['k'].dtype}, conv history "
        f"{eng8.slots.cache[0]['conv'].dtype}; launches {counts8}")
    require(bad == 0, "the int8-KV engine's tokens differ from bf16's")
    check_counts(counts8, eng8.sched.stats.decode_steps,
                 eng8.sched.stats.admitted, "(c)")
    del eng8

    changed = probe_leaves_cache(dev, cfg, model, main_serve_config(
        drift_monitor=True, drift_sample_rate=1.0))
    log(tag, f"drift probe's reference pass over a live hybrid cache: "
        f"{changed} tensors changed")
    require(changed == 0, "the drift probe left the hybrid cache changed")
    refused = []
    for kw in (dict(paged=True), dict(speculative=True)):
        try:
            Engine(model, cfg, main_serve_config(**kw), device=dev)
        except ValueError as e:
            refused.append(str(e).split(" (")[0])
    log(tag, f"refused: {refused}")
    require(len(refused) == 2, "a paged or speculative hybrid engine was "
            "built")

    # (b) the ring wrapping at full width
    scb = main_serve_config(decode_batch=2, max_len=2304, prefill_len=2112,
                            max_new_tokens=16)
    rreqs = make_requests(cfg, 2, seed=2, lengths=list(RING_LENGTHS))
    engb = Engine(model, cfg, scb, device=dev)
    reset_counts()
    resb, stepsb, wallb = serve(engb, rreqs)
    countsb = launch_counts()
    ttftb = [r.ttft_s for r in resb]
    log(tag, f"(b) {len(resb)} requests of {list(RING_LENGTHS)} tokens, "
        f"{sum(len(r.tokens) for r in resb)} tokens in {wallb:.3f} s; TTFT "
        f"{', '.join(f'{1e3 * t:.1f}' for t in ttftb)} ms; decode step "
        f"{1e3 * sum(stepsb) / len(stepsb):.2f} ms; launches {countsb}")
    require(all(len(r.tokens) == 16 for r in resb),
            f"expected 2 × 16 tokens, got {[len(r.tokens) for r in resb]}")
    check_counts(countsb, engb.sched.stats.decode_steps,
                 engb.sched.stats.admitted, "(b)")
    del engb

    lg = family_logits(dev, cfg, model, reqs[:1], 512, False)
    lgb = family_logits(dev, cfg, model, rreqs, 2304, True)
    gates = [("(a) prefill", lg["prefill_err"], lg["prefill_scale"]),
             ("(b) prefill", lgb["prefill_err"], lgb["prefill_scale"]),
             ("(b) decode step after the wrap", lgb["step_err"],
              lgb["step_scale"])]
    for what, err, scale in gates:
        log(tag, f"{what} logits, kernels vs fused=off: max |Δ| {err:.3e} "
            f"(max |logit| {scale:.3f}, tol {1e-3 * max(1.0, scale):.3e})")
        require(err <= 1e-3 * max(1.0, scale),
                f"the hybrid kernel path disagrees with fused=off: {what}")
    log(tag, f"(b)'s ring: {lgb['ring_slots']} slots holding positions up "
        f"to {lgb['ring_max_pos']}")
    require(lgb["ring_max_pos"] >= lgb["ring_slots"], "the ring never "
            "wrapped")
    del model
    torch.cuda.empty_cache()
    run.update(counts=counts, counts_int8=counts8, counts_ring=countsb,
               decode_steps=n_steps, tok_s=n_tok / wall, step_ms=step_ms,
               ttft_ms=[1e3 * t for t in ttft], profile=prof,
               ring_ttft_ms=[1e3 * t for t in ttftb],
               ring_step_ms=1e3 * sum(stepsb) / len(stepsb),
               probe_changed=changed, logits=[lg, lgb])
    return run


# run (b): two prompts of 2048 and 2000 tokens in a 2304-slot cache, the
# mLSTM's parallel form over 8 chunks of 256
XLSTM_LENGTHS = (2048, 2000)
# a lane's state at full width with JAX's dtypes: 6 mLSTM layers of C
# (4·384²), n (4·384), m (4) f32 and pos int32, 6 sLSTM layers of c, n, h,
# m (4·768) f32 and pos, whatever the context
XLSTM_LANE_BYTES = 6 * 4 * (4 * 384 ** 2 + 4 * 384 + 4 + 1) \
    + 6 * 4 * (4 * 768 + 1)


def fill_xlstm_biases(model, seed: int) -> str:
    """Fill the zero ``w_if`` (mLSTM) and ``w_gates`` (sLSTM) biases
    ``init_lm`` gives with N(0, BIAS_STD²) from a seed, so the bias path
    carries real values."""
    import torch
    gen = torch.Generator(device=model.device).manual_seed(seed)
    for blk in model.blocks:
        p = blk.mixer.w_if if blk.kind == "mlstm" else blk.mixer.w_gates
        p.b.normal_(0.0, BIAS_STD, generator=gen)
    return f"{len(model.blocks)} w_if / w_gates biases filled"


def lane_bytes(eng) -> int:
    """Bytes of the engine's live cache a lane holds."""
    return eng.slots.hbm_bytes() // eng.sc.decode_batch


def phase_xlstm(dev) -> dict:
    """Phase "xlstm": xlstm-125m (mLSTM and sLSTM blocks, LayerNorm, no
    RoPE) at full width and all 12 layers → :func:`family_model` (the
    ``w_if``/``w_gates`` biases filled from seed 13) → (a) phase 4's
    unpaged serving, bf16 KV (every one of the 66 projections through K1
    at decode and K2 at prefill, nothing else launched), profiled decode
    steps; (c) the same with int8 KV (the states f32 either way: the same
    tokens); the drift probe leaving every state tensor bit for bit;
    ``paged`` and ``speculative`` refused; (b) prompts of 2048 and 2000
    tokens with ``max_len`` 2304 (the parallel form over 8 chunks), a
    lane's state bytes equal to (a)'s; the prefill logits of (a) and (b)
    and one decode step's logits after (b)'s prefill through the kernels
    against ``fused="off"``, each within 1e-3 · max|logit|."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import make_requests
    from repro_torch.models.linear import QLinear
    from repro_torch.serve import Engine

    cfg = get_config("xlstm-125m")
    tag = "xlstm"
    gib = 2.0 ** 30
    model, run = family_model(dev, cfg, tag,
                              prepare=lambda m: fill_xlstm_biases(m, 13))
    n_proj = sum(isinstance(m, QLinear) for m in model.blocks.modules())
    w_if = model.blocks[0].mixer.w_if
    log(tag, f"{n_proj} quantized projections; w_if {tuple(w_if.codes.shape)}"
        f" at rank {w_if.r.shape[0]}")
    require(n_proj == 66 and w_if.r.shape == (4, 8),
            f"expected 66 projections and w_if at rank 4, got {n_proj}, "
            f"{tuple(w_if.r.shape)}")

    def check_counts(counts, steps: int, prefills: int, what: str) -> None:
        want = {"K1": steps * n_proj, "K2": prefills * n_proj, "K3": 0,
                "K4": 0, "K5": 0, "K6": 0}
        require(all(counts[k] == v for k, v in want.items()),
                f"{what}: launches {counts}, the layout gives {want} "
                f"({steps} decode steps, {prefills} prefills)")

    # (a) phase 4's serving, bf16 KV
    sc = main_serve_config()
    serve(Engine(model, cfg, sc, device=dev),
          make_requests(cfg, 2, seed=1, lengths=[40, 60]))     # warm-up
    eng = Engine(model, cfg, sc, device=dev)
    reqs = make_requests(cfg, 8, seed=0, lengths=MAIN_LENGTHS)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    results, steps, wall = serve(eng, reqs)
    counts = launch_counts()
    n_steps = eng.sched.stats.decode_steps
    n_tok = sum(len(r.tokens) for r in results)
    ttft = [r.ttft_s for r in results]
    step_ms = 1e3 * sum(steps) / len(steps)
    state_a = lane_bytes(eng)
    log(tag, f"(a) served {len(results)} requests, {n_tok} tokens in "
        f"{wall:.3f} s: {n_tok / wall:.1f} tok/s; TTFT first "
        f"{1e3 * min(ttft):.1f} ms mean {1e3 * sum(ttft) / len(ttft):.1f} ms "
        f"max {1e3 * max(ttft):.1f} ms; decode step {step_ms:.2f} ms over "
        f"{len(steps)} decode-only steps ({n_steps} decode steps in all); "
        f"peak memory while serving "
        f"{torch.cuda.max_memory_allocated() / gib:.2f} GiB; state "
        f"{state_a:,} bytes a lane")
    log(tag, f"(a) kernel launches in the run: {counts} ({n_proj} "
        f"projections)")
    require(len(results) == 8 and all(len(r.tokens) == 32 for r in results),
            f"expected 8 requests × 32 tokens, got "
            f"{[len(r.tokens) for r in results]}")
    require(all(0 <= t < cfg.vocab for r in results for t in r.tokens),
            "a token outside the vocabulary")
    require(state_a == XLSTM_LANE_BYTES, f"a lane holds {state_a} bytes of "
            f"state, JAX's dtypes give {XLSTM_LANE_BYTES}")
    check_counts(counts, n_steps, eng.sched.stats.admitted, "(a)")
    prof = profile_decode(eng, cfg, make_requests(cfg, 8, seed=4,
                                                  lengths=MAIN_LENGTHS),
                          tag=tag)
    del eng

    # (c) int8 KV: the mLSTM and sLSTM states stay f32
    eng8 = Engine(model, cfg, main_serve_config(kv_dtype="int8"), device=dev)
    reset_counts()
    results8, _, _ = serve(eng8, make_requests(cfg, 8, seed=0,
                                               lengths=MAIN_LENGTHS))
    counts8 = launch_counts()
    bad = hold_tokens(dev, cfg, model, reqs,
                      [r.tokens.tolist() for r in results8],
                      [r.tokens.tolist() for r in results],
                      "xlstm int8 KV vs bf16")
    dtypes = sorted({str(t.dtype) for layer in eng8.slots.cache
                     for t in layer.values()})
    log(tag, f"(c) int8 KV engine: {8 - bad}/8 requests' tokens equal the "
        f"bf16 engine's; state dtypes {dtypes}; launches {counts8}")
    require(bad == 0, "the int8-KV engine's tokens differ from bf16's")
    require(dtypes == ["torch.float32", "torch.int32"],
            f"xLSTM states under int8 KV: {dtypes}")
    check_counts(counts8, eng8.sched.stats.decode_steps,
                 eng8.sched.stats.admitted, "(c)")
    del eng8

    changed = probe_leaves_cache(dev, cfg, model, main_serve_config(
        drift_monitor=True, drift_sample_rate=1.0))
    log(tag, f"drift probe's reference pass over live xLSTM states: "
        f"{changed} tensors changed")
    require(changed == 0, "the drift probe left the xLSTM states changed")
    refused = []
    for kw in (dict(paged=True), dict(speculative=True)):
        try:
            Engine(model, cfg, main_serve_config(**kw), device=dev)
        except ValueError as e:
            refused.append(str(e).split(" (")[0])
    log(tag, f"refused: {refused}")
    require(len(refused) == 2, "a paged or speculative xLSTM engine was "
            "built")

    # (b) 2048- and 2000-token prompts: the parallel form over 8 chunks
    scb = main_serve_config(decode_batch=2, max_len=2304, prefill_len=2048,
                            max_new_tokens=16)
    breqs = make_requests(cfg, 2, seed=2, lengths=list(XLSTM_LENGTHS))
    engb = Engine(model, cfg, scb, device=dev)
    reset_counts()
    resb, stepsb, wallb = serve(engb, breqs)
    countsb = launch_counts()
    ttftb = [r.ttft_s for r in resb]
    state_b = lane_bytes(engb)
    log(tag, f"(b) {len(resb)} requests of {list(XLSTM_LENGTHS)} tokens, "
        f"{sum(len(r.tokens) for r in resb)} tokens in {wallb:.3f} s; TTFT "
        f"{', '.join(f'{1e3 * t:.1f}' for t in ttftb)} ms; decode step "
        f"{1e3 * sum(stepsb) / len(stepsb):.2f} ms; launches {countsb}; "
        f"state {state_b:,} bytes a lane (max_len 2304; (a): {state_a:,} at "
        f"512)")
    require(all(len(r.tokens) == 16 for r in resb),
            f"expected 2 × 16 tokens, got {[len(r.tokens) for r in resb]}")
    require(state_b == state_a, "a lane's state grew with the context")
    check_counts(countsb, engb.sched.stats.decode_steps,
                 engb.sched.stats.admitted, "(b)")
    del engb

    t0 = time.perf_counter()
    lg = family_logits(dev, cfg, model, reqs[:1], 512, False)
    lgb = family_logits(dev, cfg, model, breqs, 2304, True)
    gates = [("(a) prefill", lg["prefill_err"], lg["prefill_scale"]),
             ("(b) prefill", lgb["prefill_err"], lgb["prefill_scale"]),
             ("(b) decode step after the prefill", lgb["step_err"],
              lgb["step_scale"])]
    for what, err, scale in gates:
        log(tag, f"{what} logits, kernels vs fused=off: max |Δ| {err:.3e} "
            f"(max |logit| {scale:.3f}, tol {1e-3 * max(1.0, scale):.3e})")
        require(err <= 1e-3 * max(1.0, scale),
                f"the xLSTM kernel path disagrees with fused=off: {what}")
    log(tag, f"logit checks took {time.perf_counter() - t0:.1f} s")
    del model
    torch.cuda.empty_cache()
    run.update(counts=counts, counts_int8=counts8, counts_long=countsb,
               decode_steps=n_steps, tok_s=n_tok / wall, step_ms=step_ms,
               ttft_ms=[1e3 * t for t in ttft], profile=prof,
               long_ttft_ms=[1e3 * t for t in ttftb],
               long_step_ms=1e3 * sum(stepsb) / len(stepsb),
               lane_bytes=state_a, probe_changed=changed, logits=[lg, lgb])
    return run


WHISPER_FRAMES_SEED = 17


def kv_logit_delta(dev, cfg, model, reqs, frames, steps: int = 4) -> tuple:
    """(prefill Δ, decode Δ): the largest |Δlogit| between a bf16 and an
    int8 KV cache prefilled from the same prompts (right-padded,
    ``lengths``) and frames, at the prefill (which reads no cache: 0) and
    over ``steps`` greedy decode steps fed the bf16 run's tokens, through
    the kernels. The decode Δ bounds how far int8 KV moves a logit on
    this path, so how close two logits must be for int8 to swap them."""
    import torch
    from repro_torch.models import Ctx, decode_step, init_cache, prefill
    from repro_torch.serve.slots import KV_DTYPES

    width = max(len(r.prompt) for r in reqs)
    tokens = torch.zeros((len(reqs), width), dtype=torch.long)
    for i, r in enumerate(reqs):
        tokens[i, :len(r.prompt)] = torch.from_numpy(r.prompt).long()
    n = torch.tensor([len(r.prompt) for r in reqs], dtype=torch.int32,
                     device=dev)
    out, cache = {}, {}
    for kind in ("bf16", "int8"):
        out[kind], cache[kind] = prefill(
            Ctx(), model, tokens.to(dev),
            init_cache(cfg, len(reqs), 512, KV_DTYPES[kind], dev),
            lengths=n, frames=frames)
    pre = float((out["int8"] - out["bf16"]).abs().max())
    step = 0.0
    tok = out["bf16"][:, -1].argmax(-1)[:, None]
    for _ in range(steps):
        for kind in out:
            out[kind] = decode_step(Ctx(), model, tok, cache[kind])[0]
        step = max(step, float((out["int8"] - out["bf16"]).abs().max()))
        tok = out["bf16"][:, -1].argmax(-1)[:, None]
    return pre, step


def phase_whisper(dev) -> dict:
    """Phase "whisper": whisper-large-v3 (a bidirectional encoder over the
    1500-frame stub, cross attention in every decoder block, GELU,
    LayerNorm) at full width and all 32 + 32 layers → :func:`family_model`
    (calibration over the synthetic frames) → (a) phase 4's unpaged
    serving, bf16 KV, seeded frames through ``extra_inputs`` (every
    admission takes ``frames[0]``, as in JAX): every launch count exactly
    as the layout gives it (K1 = 256 a decode step, K2 = 512 and K4 = 96
    an admission, K3 = 64 a step, K5 = K6 = 0), profiled decode steps; (b)
    the same with int8 KV: the cross memory bf16, the launches as in (a),
    each request's tokens equal (a)'s or diverging only after its first
    token and where (a)'s top-2 logit gap is within twice the largest
    |Δlogit| int8 KV makes over 4 decode steps (:func:`kv_logit_delta`);
    the drift probe leaving the cache bit for bit; ``paged``/``speculative``
    refused; the prefill logits and one decode step's logits over the 8
    lanes through the kernels against ``fused="off"``, each within 1e-3 ·
    max|logit|."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import make_requests
    from repro_torch.models.linear import QLinear
    from repro_torch.serve import Engine

    cfg = get_config("whisper-large-v3")
    tag = "whisper"
    gib = 2.0 ** 30
    model, run = family_model(dev, cfg, tag)
    n_proj = sum(isinstance(m, QLinear) for m in model.modules())
    per_step = sum(isinstance(m, QLinear) for m in model.blocks.modules())
    n_cross = 2 * cfg.n_layers          # cross wk/wv run at prefill only
    log(tag, f"{n_proj} quantized projections ({n_proj - per_step} in the "
        f"encoder, {per_step} in the decoder); enc_layers {cfg.enc_layers} "
        f"enc_seq {cfg.enc_seq} act {cfg.act}")
    want_k = dict(K1=per_step - n_cross, K2=n_proj, K3=2 * cfg.n_layers,
                  K4=cfg.enc_layers + 2 * cfg.n_layers)
    require(n_proj == 512 and want_k == dict(K1=256, K2=512, K3=64, K4=96),
            f"expected 512 projections, K1/K2/K3/K4 = 256/512/64/96, got "
            f"{n_proj}, {want_k}")

    def check_counts(counts, steps: int, admissions: int, what: str) -> None:
        want = {"K1": steps * want_k["K1"], "K2": admissions * want_k["K2"],
                "K3": steps * want_k["K3"], "K4": admissions * want_k["K4"],
                "K5": 0, "K6": 0}
        require(all(counts[k] == v for k, v in want.items()),
                f"{what}: launches {counts}, the layout gives {want} "
                f"({steps} decode steps, {admissions} admissions)")

    frames = np.random.default_rng(WHISPER_FRAMES_SEED).standard_normal(
        (8, cfg.enc_seq, cfg.d_frontend)).astype(np.float32)
    extra = {"frames": frames}

    # (a) phase 4's serving, bf16 KV, the frames through extra_inputs
    sc = main_serve_config()
    serve(Engine(model, cfg, sc, device=dev, extra_inputs=extra),
          make_requests(cfg, 2, seed=1, lengths=[40, 60]))     # warm-up
    eng = Engine(model, cfg, sc, device=dev, extra_inputs=extra)
    reqs = make_requests(cfg, 8, seed=0, lengths=MAIN_LENGTHS)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    results, steps, wall = serve(eng, reqs)
    counts = launch_counts()
    n_steps = eng.sched.stats.decode_steps
    n_tok = sum(len(r.tokens) for r in results)
    ttft = [r.ttft_s for r in results]
    step_ms = 1e3 * sum(steps) / len(steps)
    cross_bytes = sum(layer[k].numel() * layer[k].element_size()
                      for layer in eng.slots.cache
                      for k in ("cross_k", "cross_v")) // sc.decode_batch
    lane = lane_bytes(eng)
    log(tag, f"(a) served {len(results)} requests, {n_tok} tokens in "
        f"{wall:.3f} s: {n_tok / wall:.1f} tok/s; TTFT first "
        f"{1e3 * min(ttft):.1f} ms mean {1e3 * sum(ttft) / len(ttft):.1f} ms "
        f"max {1e3 * max(ttft):.1f} ms (the encoder runs at every "
        f"admission); decode step {step_ms:.2f} ms over {len(steps)} "
        f"decode-only steps ({n_steps} decode steps in all); peak memory "
        f"while serving {torch.cuda.max_memory_allocated() / gib:.2f} GiB; "
        f"a lane's cache {lane:,} bytes, {cross_bytes:,} of them the cross "
        f"memory (bf16)")
    log(tag, f"(a) kernel launches in the run: {counts}")
    require(len(results) == 8 and all(len(r.tokens) == 32 for r in results),
            f"expected 8 requests × 32 tokens, got "
            f"{[len(r.tokens) for r in results]}")
    require(all(0 <= t < cfg.vocab for r in results for t in r.tokens),
            "a token outside the vocabulary")
    require(cross_bytes == 2 * cfg.n_layers * cfg.n_kv_heads * cfg.enc_seq
            * cfg.head_dim_ * 2, f"a lane's cross memory is {cross_bytes} "
            f"bytes")
    check_counts(counts, n_steps, eng.sched.stats.admitted, "(a)")
    prof = profile_decode(eng, cfg, make_requests(cfg, 8, seed=4,
                                                  lengths=MAIN_LENGTHS),
                          tag=tag)
    del eng

    # (b) int8 KV: the cross memory stays bf16. int8 moves every decode
    # logit by up to the measured Δ, and random weights leave near-ties
    # among 51,866 logits (on an H100, seed 0: 3 of 8 requests diverge at
    # top-2 gaps of 9.2e-4 to 5.2e-3), so a request may diverge, but only
    # after its first token (the prefill reads no cache) and only where
    # bf16's top-2 gap is within 2Δ
    eng8 = Engine(model, cfg, main_serve_config(kv_dtype="int8"), device=dev,
                  extra_inputs=extra)
    reset_counts()
    results8, _, _ = serve(eng8, make_requests(cfg, 8, seed=0,
                                               lengths=MAIN_LENGTHS))
    counts8 = launch_counts()
    d_pre, d_step = kv_logit_delta(dev, cfg, model, reqs, torch.from_numpy(
        np.repeat(frames[:1], len(reqs), 0)).to(dev))
    splits = []
    for r, g, w in zip(reqs, results8, results):
        g, w = g.tokens.tolist(), w.tokens.tolist()
        if g != w:
            pos = next(j for j, (x, y) in enumerate(zip(g, w)) if x != y)
            splits.append((r.uid, pos, top2_gap(
                dev, cfg, model, r.prompt, w, pos,
                torch.from_numpy(frames[:1]).to(dev))))
    cross_dt = sorted({str(layer[k].dtype) for layer in eng8.slots.cache
                       for k in ("cross_k", "cross_v")})
    log(tag, f"(b) int8 KV engine: {8 - len(splits)}/8 requests' tokens "
        f"equal the bf16 engine's; the others diverge at (uid, token, bf16 "
        f"top-2 gap) {[(u, p, float(f'{gap:.3e}')) for u, p, gap in splits]}"
        f"; int8 moves a logit by {d_pre:.3e} at the prefill, by up to "
        f"{d_step:.3e} over 4 decode steps (2Δ {2 * d_step:.3e}); cross "
        f"memory {cross_dt}, self K {eng8.slots.cache[0]['k'].dtype}; "
        f"launches {counts8}")
    require(d_pre == 0.0, "int8 KV changed the prefill logits")
    require(all(p > 0 and gap <= 2 * d_step for _, p, gap in splits),
            f"the int8-KV engine diverges from bf16's past int8's reach: "
            f"{splits}, 2Δ {2 * d_step:.3e}")
    require(cross_dt == ["torch.bfloat16"], f"cross memory {cross_dt}")
    check_counts(counts8, eng8.sched.stats.decode_steps,
                 eng8.sched.stats.admitted, "(b)")
    del eng8

    changed = probe_leaves_cache(dev, cfg, model, main_serve_config(
        drift_monitor=True, drift_sample_rate=1.0))
    log(tag, f"drift probe's reference pass over a live whisper cache: "
        f"{changed} tensors changed")
    require(changed == 0, "the drift probe left the whisper cache changed")
    refused = []
    for kw in (dict(paged=True), dict(speculative=True)):
        try:
            Engine(model, cfg, main_serve_config(**kw), device=dev)
        except ValueError as e:
            refused.append(str(e).split(" (")[0])
    log(tag, f"refused: {refused}")
    require(len(refused) == 2, "a paged or speculative whisper engine was "
            "built")

    t0 = time.perf_counter()
    lg = family_logits(dev, cfg, model, reqs, 512, True,
                       frames=torch.from_numpy(frames).to(dev))
    gates = [("prefill", lg["prefill_err"], lg["prefill_scale"]),
             ("decode step after the prefill", lg["step_err"],
              lg["step_scale"])]
    for what, err, scale in gates:
        log(tag, f"{what} logits over 8 lanes, kernels vs fused=off: max "
            f"|Δ| {err:.3e} (max |logit| {scale:.3f}, tol "
            f"{1e-3 * max(1.0, scale):.3e})")
        require(err <= 1e-3 * max(1.0, scale),
                f"the whisper kernel path disagrees with fused=off: {what}")
    log(tag, f"logit checks took {time.perf_counter() - t0:.1f} s")
    del model
    torch.cuda.empty_cache()
    run.update(counts=counts, counts_int8=counts8, decode_steps=n_steps,
               int8_splits=splits, int8_delta=d_step,
               tok_s=n_tok / wall, step_ms=step_ms,
               ttft_ms=[1e3 * t for t in ttft], profile=prof,
               lane_bytes=lane, cross_bytes=cross_bytes,
               probe_changed=changed, logits=lg)
    return run


VLM_VISION_SEED = 19


def vlm_config(**kw):
    """Phase "vlm"'s ``ServeConfig``: phase 4's, its cache and prefill
    widened by the 256 vision rows (150–250-token prompts + 256 + 32 new
    tokens need 538 slots, and 506 rows of prefill)."""
    return main_serve_config(**dict(dict(max_len=VLM_MAX_LEN,
                                         prefill_len=VLM_PREFILL), **kw))


def vision_moves_logits(dev, cfg, model, prompt, vision) -> tuple:
    """(max |Δ|, max |logit|) between one prompt's prefill logits (through
    the kernels) with the seeded vision rows and with zeros in their
    place: a prefix that reached no layer would leave them equal."""
    import torch
    from repro_torch.models import Ctx, init_cache, prefill

    tokens = torch.from_numpy(prompt).long()[None].to(dev)
    n = torch.tensor([len(prompt) + cfg.n_vision_tokens], dtype=torch.int32,
                     device=dev)
    out = [prefill(Ctx(), model, tokens,
                   init_cache(cfg, 1, VLM_MAX_LEN, torch.bfloat16, dev),
                   lengths=n, vision=v)[0].float()
           for v in (vision, torch.zeros_like(vision))]
    require(all(bool(torch.isfinite(o).all()) for o in out),
            "non-finite logits")
    return float((out[0] - out[1]).abs().max()), float(out[1].abs().max())


def phase_vlm(dev) -> dict:
    """Phase "vlm": internvl2-2b (an InternLM2-1.8B decoder, G 2, with 256
    vision rows of 1024 projected in front of every prompt by the full
    precision ``vision_proj``) at full width and all 24 layers →
    :func:`family_model` (calibration over the synthetic vision stub too;
    ``vision_proj``'s moments stay, unread, as in JAX) → (a) phase 4's
    unpaged serving widened to 576 slots and 512 prefill rows, bf16 KV,
    seeded vision rows through ``extra_inputs`` (every admission takes
    ``vision[0]``, as in JAX): every launch count exactly as the layout
    gives it (K1 = 168 a decode step, K2 = 168 and K4 = 24 an admission,
    K3 = 24 a step, K5 = K6 = 0; K7 twice a matrix in the pass), profiled
    decode steps; (b) the same served with the sanitizer on (every lane's
    position prompt + 256 + generated − 1): no fault and (a)'s tokens; the
    first prompt's prefill logits with the seeded vision rows against
    zeros (the prefix is read: they differ by more than the kernels'
    tolerance); ``paged``/``speculative`` refused; the prefill logits and
    one decode step's logits over the 8 lanes through the kernels against
    ``fused="off"``, each within 1e-3 · max|logit|."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import make_requests
    from repro_torch.models.linear import QLinear
    from repro_torch.serve import Engine
    from repro_torch.serve.sanitizer import SanitizerError

    cfg = get_config("internvl2-2b")
    tag = "vlm"
    gib = 2.0 ** 30
    model, run = family_model(dev, cfg, tag)
    n_proj = sum(isinstance(m, QLinear) for m in model.modules())
    want_k = dict(K1=n_proj, K2=n_proj, K3=cfg.n_layers, K4=cfg.n_layers)
    want_k7 = {f"{m}x{n}": 2 * cfg.n_layers * (1 if (m, n) == (8192, 2048)
                                               else 2)
               for m, n in VLM_SHAPES}
    log(tag, f"{n_proj} quantized projections; vision_proj "
        f"{tuple(model.vision_proj.w.shape)} full precision; "
        f"n_vision_tokens {cfg.n_vision_tokens}; K7 by M×N "
        f"{run['k7_shapes']}")
    require(n_proj == 168 and run["k7_shapes"] == want_k7,
            f"expected 168 projections and K7 {want_k7}, got {n_proj} and "
            f"{run['k7_shapes']}")

    def check_counts(counts, steps: int, admissions: int, what: str) -> None:
        want = {"K1": steps * want_k["K1"], "K2": admissions * want_k["K2"],
                "K3": steps * want_k["K3"], "K4": admissions * want_k["K4"],
                "K5": 0, "K6": 0}
        require(all(counts[k] == v for k, v in want.items()),
                f"{what}: launches {counts}, the layout gives {want} "
                f"({steps} decode steps, {admissions} admissions)")

    vision = np.random.default_rng(VLM_VISION_SEED).standard_normal(
        (8, cfg.n_vision_tokens, cfg.d_frontend)).astype(np.float32)
    extra = {"vision": vision}

    # (a) phase 4's serving, bf16 KV, the vision rows through extra_inputs
    sc = vlm_config()
    serve(Engine(model, cfg, sc, device=dev, extra_inputs=extra),
          make_requests(cfg, 2, seed=1, lengths=[40, 60]))     # warm-up
    eng = Engine(model, cfg, sc, device=dev, extra_inputs=extra)
    reqs = make_requests(cfg, 8, seed=0, lengths=MAIN_LENGTHS)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    results, steps, wall = serve(eng, reqs)
    counts = launch_counts()
    n_steps = eng.sched.stats.decode_steps
    n_tok = sum(len(r.tokens) for r in results)
    ttft = [r.ttft_s for r in results]
    step_ms = 1e3 * sum(steps) / len(steps)
    lane = lane_bytes(eng)
    log(tag, f"(a) served {len(results)} requests, {n_tok} tokens in "
        f"{wall:.3f} s: {n_tok / wall:.1f} tok/s; TTFT first "
        f"{1e3 * min(ttft):.1f} ms mean {1e3 * sum(ttft) / len(ttft):.1f} ms "
        f"max {1e3 * max(ttft):.1f} ms ({VLM_PREFILL}-row prefills, "
        f"{cfg.n_vision_tokens} of them vision); decode step {step_ms:.2f} "
        f"ms over {len(steps)} decode-only steps ({n_steps} decode steps in "
        f"all); peak memory while serving "
        f"{torch.cuda.max_memory_allocated() / gib:.2f} GiB; a lane's cache "
        f"{lane:,} bytes")
    log(tag, f"(a) kernel launches in the run: {counts}")
    require(len(results) == 8 and all(len(r.tokens) == 32 for r in results),
            f"expected 8 requests × 32 tokens, got "
            f"{[len(r.tokens) for r in results]}")
    require(all(0 <= t < cfg.vocab for r in results for t in r.tokens),
            "a token outside the vocabulary")
    check_counts(counts, n_steps, eng.sched.stats.admitted, "(a)")
    prof = profile_decode(eng, cfg, make_requests(cfg, 8, seed=4,
                                                  lengths=MAIN_LENGTHS),
                          tag=tag)
    del eng

    # (b) the sanitizer on: positions count the vision rows
    eng = Engine(model, cfg, vlm_config(sanitize=True), device=dev,
                 extra_inputs=extra)
    try:
        sane, _, _ = serve(eng, make_requests(cfg, 8, seed=0,
                                              lengths=MAIN_LENGTHS))
    except SanitizerError as e:
        require(False, f"(b) the sanitizer found a fault: {e}")
    same = sum(g.tokens.tolist() == w.tokens.tolist()
               for g, w in zip(sane, results))
    pos = sorted({int(p) for layer in eng.slots.cache
                  for p in layer["pos"].tolist()})
    log(tag, f"(b) sanitizer on: no fault over {eng.sched.stats.decode_steps}"
        f" decode steps; {same}/8 requests' tokens equal (a)'s; positions "
        f"at the end {pos[0]}–{pos[-1]}")
    require(same == 8, "(b) the sanitized engine's tokens differ from (a)'s")
    del eng

    delta, scale = vision_moves_logits(dev, cfg, model, reqs[0].prompt,
                                       torch.from_numpy(vision[:1]).to(dev))
    log(tag, f"the first prompt's prefill logits, seeded vision rows vs "
        f"zeros: max |Δ| {delta:.3e} (max |logit| {scale:.3f}; the kernels' "
        f"tolerance {1e-3 * max(1.0, scale):.3e})")
    require(delta > 1e-3 * max(1.0, scale),
            "the vision prefix does not move the logits")
    refused = []
    for kw in (dict(paged=True), dict(speculative=True)):
        try:
            Engine(model, cfg, vlm_config(**kw), device=dev)
        except ValueError as e:
            refused.append(str(e).split(" (")[0])
    log(tag, f"refused: {refused}")
    require(len(refused) == 2, "a paged or speculative VLM engine was built")

    t0 = time.perf_counter()
    lg = family_logits(dev, cfg, model, reqs, VLM_MAX_LEN, True,
                       vision=torch.from_numpy(vision).to(dev))
    gates = [("prefill", lg["prefill_err"], lg["prefill_scale"]),
             ("decode step after the prefill", lg["step_err"],
              lg["step_scale"])]
    for what, err, scale in gates:
        log(tag, f"{what} logits over 8 lanes, kernels vs fused=off: max "
            f"|Δ| {err:.3e} (max |logit| {scale:.3f}, tol "
            f"{1e-3 * max(1.0, scale):.3e})")
        require(err <= 1e-3 * max(1.0, scale),
                f"the VLM kernel path disagrees with fused=off: {what}")
    log(tag, f"logit checks took {time.perf_counter() - t0:.1f} s")
    del model
    torch.cuda.empty_cache()
    run.update(counts=counts, decode_steps=n_steps, tok_s=n_tok / wall,
               step_ms=step_ms, ttft_ms=[1e3 * t for t in ttft],
               profile=prof, lane_bytes=lane, vision_delta=delta,
               logits=lg)
    return run


# ---------------------------------------------------------------------------
# phase "train": training and QPEFT through launch/train.py's entry points
# ---------------------------------------------------------------------------
TRAIN_QPEFT_STEPS = 20
TRAIN_FULL_STEPS = 10
# phi3-mini-3.8b's 3.82 B f32 parameters, gradients, μ and ν take 61 GB:
# all 32 layers fit the card beside the activations under --remat full
TRAIN_FULL_LAYERS = 32
TRAIN_ARGS = ["--full-size", "--device", "cuda"]
# (b)'s run: at JAX's default --lr 3e-3 and 8 × 64 tokens the full-width
# training loss climbed from the sixth step (10.90 → 11.57 in 12 steps on
# an H100 80GB HBM3 at 700 W; the port's full step follows JAX's through
# that lr at reduced width, tests/test_torch_train.py). (b) runs 32 × 128
# tokens at 6e-4 and is gated on the held-out loss (batch 999), which the
# batch-to-batch spread of the training loss (about ±0.05) does not move
TRAIN_FULL_ARGS = ["--batch", "32", "--seq", "128", "--lr", "6e-4"]
# card against the CPU, reduced phi3 in f32: losses within 1e-5 relative;
# trained tensors within 1e-2 of their update's norm (Adam's
# (m/c1)/(sqrt(v/c2)+eps) swings by up to lr where a gradient sits near
# eps, so an element-wise bound does not hold; tests/test_torch_train.py
# bounds the port against JAX the same way)
TRAIN_LOSS_TOL = 1e-5
TRAIN_NORM_TOL = 1e-2


def checksums(model, skip=(".l", ".r")) -> dict:
    """Two int64 sums of every buffer's bits (plain, and weighted by
    position) on the card, by name: a frozen tensor that changes a bit
    changes them, with no copy of the model kept."""
    import torch
    out = {}
    for name, t in model.named_buffers():
        if name.endswith(skip):
            continue
        flat = t.detach().contiguous().view(-1)
        ints = flat.view({4: torch.int32, 2: torch.int16,
                          1: torch.int8}[t.element_size()]).to(torch.int64)
        pos = torch.arange(1, ints.numel() + 1, device=t.device,
                           dtype=torch.int64)
        out[name] = (int(ints.sum()), int((ints * pos).sum()))
        del ints, pos
    return out


def timed_steps(step, state, data, n: int) -> tuple:
    """``n`` steps, each synchronized: (state, losses, ms a step)."""
    import torch
    losses, ms = [], []
    for _ in range(n):
        batch = next(data)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(m["loss"]))
    return state, losses, ms


def profile_steps(step, state, data, n: int = 2) -> tuple:
    """``n`` steps under torch.profiler: (state, losses, the device's busy
    share of their wall, device ms a step)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    losses = []
    torch.cuda.synchronize()
    # the device's kernels only: the busy share needs no host op, and a
    # training step has thousands of them to trace
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            state, m = step(state, next(data))
            losses.append(m["loss"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev_us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and e.self_device_time_total > 0)
    return state, [float(v) for v in losses], dev_us / (wall * 1e6), \
        dev_us / n / 1e3


def step_summary(tag: str, what: str, ms: list, losses: list, busy: float,
                 dev_ms: float, tokens: int, peak: float) -> dict:
    med = sorted(ms[2:])[len(ms[2:]) // 2]
    log(tag, f"{what}: step ms median of steps 3–{len(ms)} {med:.2f} "
        f"(first {ms[0]:.2f}, second {ms[1]:.2f}); {tokens / med * 1e3:.1f} "
        f"trained tokens/s; 2 profiled steps: device busy {dev_ms:.2f} "
        f"ms a step ({100 * busy:.1f}%); peak memory while training "
        f"{peak:.2f} GiB; losses {[round(v, 4) for v in losses]}")
    return dict(step_ms=med, tok_s=tokens / med * 1e3, busy=busy,
                device_ms=dev_ms, peak_gib=peak, losses=losses,
                first_ms=ms[0])


def train_qpeft(dev, tag: str) -> tuple:
    """(a): the qpeft build of ``launch/train.py`` at full width and
    depth (init → calibration → the SRR pass through K7 → split), the
    gradient of every adapter at step 1, ``TRAIN_QPEFT_STEPS`` timed steps
    and 2 profiled ones, the held-out loss before and after, the frozen
    part's checksums before and after. Returns (run, its state, the PTQ
    pass's adapters of one projection, numbers)."""
    import torch
    from repro_torch.data import batches, host_batch
    from repro_torch.kernels import mxint_quantize
    from repro_torch.launch import train as launch_train
    from repro_torch.models import Ctx, lm_loss
    from repro_torch.train.steps import _grads_of

    gib = 2.0 ** 30
    args = launch_train.parser().parse_args(
        ["--mode", "qpeft", "--batch", "8", "--seq", "64", "--rank", "16",
         "--bits", "3", "--steps", str(TRAIN_QPEFT_STEPS)] + TRAIN_ARGS)
    marks = []

    def mark(msg: str) -> None:
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        print(msg, flush=True)

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    run = launch_train.build(args, log=mark)
    torch.cuda.synchronize()
    marks.append(time.perf_counter())
    ptq_counts = launch_counts()
    k7_shapes = {f"{m}x{n}": c
                 for (m, n), c in mxint_quantize.LAUNCH_SHAPES.items()}
    cfg, st = run.cfg, run.state
    n = len(run.reports)
    out = dict(init_s=marks[1] - marks[0], pass_s=marks[2] - marks[1],
               build_s=marks[3] - marks[0], matrices=n,
               build_peak_gib=torch.cuda.max_memory_allocated() / gib,
               mean_k=sum(r.k_star for r in run.reports) / n,
               ptq_counts=ptq_counts, k7_shapes=k7_shapes)
    log(tag, f"(a) {cfg.name} {cfg.n_layers} layers d_model {cfg.d_model} "
        f"d_ff {cfg.d_ff} vocab {cfg.vocab}: init {out['init_s']:.2f} s, "
        f"calibration (2 batches of 8 × 64) + SRR pass {out['pass_s']:.2f} s "
        f"({n} matrices, mean k* {out['mean_k']:.2f}, K7 launches "
        f"{ptq_counts['K7']}, by M×N {k7_shapes}); peak memory of the build "
        f"{out['build_peak_gib']:.2f} GiB; the frozen model "
        f"{torch.cuda.memory_allocated() / gib:.2f} GiB")
    require(n == 224 and len(st.trainable) == 224,
            f"expected 224 adapters, got {n} / {len(st.trainable)}")
    require(ptq_counts["K7"] >= 2 * n,
            f"the PTQ pass did not quantize through K7: {ptq_counts}")
    require(sum(k7_shapes.values()) == ptq_counts["K7"]
            and set(k7_shapes) == {f"{m}x{n}" for m, n in K7_SHAPES[:3]},
            f"K7's launches by shape {k7_shapes}: not phi3's three shapes "
            f"summing to its count {ptq_counts['K7']}")
    require(run.sc.compute_dtype == torch.bfloat16, "not bf16 on the card")
    sums = checksums(st.frozen)
    pass_l = {p: d["l"].clone() for p, d in st.trainable.items()}
    ctx = Ctx(compute_dtype=run.sc.compute_dtype, fused="off")
    held = host_batch(run.dcfg, 999, device=dev)
    with torch.no_grad():
        held0 = float(lm_loss(ctx, st.frozen, held))
    _, g = _grads_of(lambda b: lm_loss(ctx, st.frozen, b), st.trainable,
                     host_batch(run.dcfg, 0, device=dev), 0)
    dead = [f"{p}.{k}" for p, d in g.items() for k, v in d.items()
            if not (bool(torch.isfinite(v).all()) and float(v.abs().max()) > 0)]
    log(tag, f"(a) step 1's gradients: {2 * len(g) - len(dead)} of "
        f"{2 * len(g)} adapter tensors finite and nonzero")
    require(not dead, f"adapters with no finite nonzero gradient: {dead[:8]}")
    del g
    torch.cuda.reset_peak_memory_stats()
    data = batches(run.dcfg, 0, device=dev)
    st, losses, ms = timed_steps(run.step, st, data, TRAIN_QPEFT_STEPS)
    st, more, busy, dev_ms = profile_steps(run.step, st, data)
    peak = torch.cuda.max_memory_allocated() / gib
    with torch.no_grad():
        held1 = float(lm_loss(ctx, st.frozen, held))
    same = checksums(st.frozen) == sums
    out.update(step_summary(tag, "(a) qpeft", ms, losses + more, busy,
                            dev_ms, args.batch * args.seq, peak))
    log(tag, f"(a) held-out loss (batch 999) {held0:.4f} before, "
        f"{held1:.4f} after {len(ms) + len(more)} steps; frozen tensors "
        f"(codes, scale, gscale, norms, embedding, head: {len(sums)}) "
        f"{'bit-identical' if same else 'CHANGED'} by checksum")
    require(all(math.isfinite(v) for v in losses + more), "a non-finite loss")
    require(held1 < held0, "the held-out loss did not fall")
    require(same, "a frozen tensor changed in training")
    out.update(held_before=held0, held_after=held1)
    return run, st, pass_l, out


def serve_finetuned(dev, tag: str, run, st, pass_l) -> dict:
    """(d): the trained adapters merged into the model, served by phase
    4's engine through the kernels: K1–K4 launched, the served ``l`` of a
    projection the trained one (not the pass's), the prefill logits
    through the kernels against ``fused="off"``."""
    import torch
    from repro_torch.launch.serve import make_requests
    from repro_torch.models import Ctx, init_cache, prefill
    from repro_torch.models.quantize import merge_qpeft
    from repro_torch.serve import Engine

    cfg = run.cfg
    model = merge_qpeft(st.trainable, st.frozen)
    sc = main_serve_config()
    serve(Engine(model, cfg, sc, device=dev),
          make_requests(cfg, 2, seed=1, lengths=[40, 60]))     # warm-up
    eng = Engine(model, cfg, sc, device=dev)
    reqs = make_requests(cfg, 8, seed=0, lengths=MAIN_LENGTHS)
    reset_counts()
    results, steps, wall = serve(eng, reqs)
    counts = launch_counts()
    n_tok = sum(len(r.tokens) for r in results)
    step_ms = 1e3 * sum(steps) / len(steps)
    path = "blocks.0.mixer.wq"
    served = eng.model.get_submodule(path).l
    trained = bool(torch.equal(served, st.trainable[path]["l"]))
    moved = not torch.equal(served, pass_l[path])
    log(tag, f"(d) fine-tuned container served: {len(results)} requests, "
        f"{n_tok} tokens in {wall:.3f} s, {n_tok / wall:.1f} tok/s, decode "
        f"step {step_ms:.2f} ms; launches {counts}; {path}.l served = "
        f"trained: {trained}, differs from the pass's: {moved}")
    require(len(results) == 8 and all(len(r.tokens) == 32 for r in results),
            "expected 8 requests × 32 tokens")
    require(all(counts[k] > 0 for k in ("K1", "K2", "K3", "K4")),
            f"a kernel of the path never launched: {counts}")
    require(trained and moved, "the engine does not serve the trained "
            "adapters")
    tokens = torch.from_numpy(reqs[0].prompt).long()[None].to(dev)
    n = torch.tensor([tokens.shape[1]], dtype=torch.int32, device=dev)
    logit = {}
    for fused in ("auto", "off"):
        logit[fused] = prefill(Ctx(fused=fused), model, tokens,
                               init_cache(cfg, 1, 512, torch.bfloat16, dev),
                               lengths=n)[0].float()
    scale = float(logit["off"].abs().max())
    err = float((logit["auto"] - logit["off"]).abs().max())
    log(tag, f"(d) prefill logits, kernels vs fused=off: max |Δ| {err:.3e} "
        f"(max |logit| {scale:.3f}, tol {1e-3 * max(1.0, scale):.3e})")
    require(bool(torch.isfinite(logit["auto"]).all()), "non-finite logits")
    require(err <= 1e-3 * max(1.0, scale), "the fine-tuned container's "
            "kernel path disagrees with fused=off")
    return dict(counts=counts, tok_s=n_tok / wall, step_ms=step_ms,
                logit_err=err, logit_scale=scale)


def train_full(dev, tag: str) -> dict:
    """(b): full mode at full width, ``TRAIN_FULL_LAYERS`` layers, remat
    full: ``TRAIN_FULL_STEPS`` timed steps and 2 profiled ones; finite
    losses, the last below the first, the held-out loss (batch 999) lower
    after than before."""
    import torch
    from repro_torch.data import batches, host_batch
    from repro_torch.launch import train as launch_train
    from repro_torch.models import Ctx, lm_loss

    gib = 2.0 ** 30
    args = launch_train.parser().parse_args(
        ["--mode", "full", "--remat", "full", "--steps",
         str(TRAIN_FULL_STEPS)] + TRAIN_FULL_ARGS + TRAIN_ARGS)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run = launch_train.build(args, log=lambda m: print(m, flush=True))
    torch.cuda.synchronize()
    cfg = run.cfg
    require(cfg.n_layers == TRAIN_FULL_LAYERS, f"depth {cfg.n_layers}")
    n_params = sum(t.numel() for t in run.state.params.buffers())
    log(tag, f"(b) full mode, {cfg.n_layers} of {cfg.n_layers} layers (the "
        f"four f32 trees {4 * 4 * n_params / 1e9:.1f} GB fit the card), "
        f"remat full, batch {args.batch} × {args.seq}, lr {args.lr:g}: init "
        f"{time.perf_counter() - t0:.2f} s, {n_params / 1e9:.3f} B "
        f"parameters")
    ctx = Ctx(compute_dtype=run.sc.compute_dtype, fused="off")
    held = host_batch(run.dcfg, 999, device=dev)
    with torch.no_grad():
        held0 = float(lm_loss(ctx, run.state.params, held))
    data = batches(run.dcfg, 0, device=dev)
    st, losses, ms = timed_steps(run.step, run.state, data, TRAIN_FULL_STEPS)
    st, more, busy, dev_ms = profile_steps(run.step, st, data)
    peak = torch.cuda.max_memory_allocated() / gib
    with torch.no_grad():
        held1 = float(lm_loss(ctx, st.params, held))
    out = step_summary(tag, "(b) full", ms, losses + more, busy, dev_ms,
                       args.batch * args.seq, peak)
    log(tag, f"(b) held-out loss (batch 999) {held0:.4f} before, "
        f"{held1:.4f} after {len(ms) + len(more)} steps")
    require(all(math.isfinite(v) for v in losses + more), "a non-finite loss")
    require(losses[-1] < losses[0], f"the training loss did not fall: "
            f"{losses[0]:.4f} → {losses[-1]:.4f}")
    require(held1 < held0, f"the held-out loss did not fall: {held0:.4f} → "
            f"{held1:.4f}")
    out.update(layers=cfg.n_layers, params=n_params, held_before=held0,
               held_after=held1)
    del run, st, data
    return out


def train_card_vs_cpu(dev, tag: str) -> dict:
    """(c): reduced phi3 in f32, one state copied to the card and kept on
    the CPU, three QPEFT and three full steps on each: losses within
    ``TRAIN_LOSS_TOL``, the trained tensors within ``TRAIN_NORM_TOL`` of
    their update's norm."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.api import PTQConfig
    from repro_torch.data import data_config_for, host_batch
    from repro_torch.models import init_lm
    from repro_torch.models.quantize import quantize_model_params, split_qpeft
    from repro_torch.optim import AdamW, cosine_schedule
    from repro_torch.train import (StepConfig, init_qpeft_state,
                                   init_train_state, make_qpeft_step,
                                   make_train_step, trainable_params)

    cfg = get_config("phi3-mini-3.8b").reduced()
    dcfg = data_config_for(cfg, seq_len=16, global_batch=4, seed=0)
    sc = StepConfig(compute_dtype=torch.float32)
    cpu = torch.device("cpu")
    qmodel, _ = quantize_model_params(
        init_lm(cfg, 0, device=cpu),
        PTQConfig(method="srr", scaling="identity", rank=8, exact_svd=True),
        device=cpu)
    out = {}
    for mode in ("qpeft", "full"):
        res = []
        for d in (cpu, dev):
            model = copy.deepcopy(qmodel if mode == "qpeft" else
                                  init_lm(cfg, 0, device=cpu)).to(d)
            opt = AdamW(learning_rate=cosine_schedule(3e-3, 2, 10),
                        weight_decay=0.01)
            if mode == "qpeft":
                tr, fr = split_qpeft(model)
                state = init_qpeft_state(tr, fr, opt)
                step = make_qpeft_step(cfg, opt, sc)
                read = lambda s: {f"{p}.{k}": v for p, dd in  # noqa: E731
                                  s.trainable.items() for k, v in dd.items()}
            else:
                state = init_train_state(model, opt)
                step = make_train_step(cfg, opt, sc)
                read = lambda s: trainable_params(s.params)  # noqa: E731
            init = {k: v.detach().cpu().clone() for k, v in read(state).items()}
            losses = []
            for i in range(3):
                state, m = step(state, host_batch(dcfg, i, device=d))
                losses.append(float(m["loss"]))
            res.append((losses, init,
                        {k: v.cpu() for k, v in read(state).items()}))
        (lc, init, pc), (lg, _, pg) = res
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(lg, lc))
        worst = max(float((pg[k] - pc[k]).norm()
                          / (pc[k] - init[k]).norm().clamp_min(1e-30))
                    for k in pc)
        elem = max(float((pg[k] - pc[k]).abs().max()) for k in pc)
        log(tag, f"(c) {mode}, reduced phi3 f32, 3 steps card vs CPU: losses "
            f"{[round(v, 6) for v in lg]} / {[round(v, 6) for v in lc]}, "
            f"max relative Δ {loss_err:.2e} (tol {TRAIN_LOSS_TOL:g}); "
            f"trained tensors: worst ‖Δ‖/‖update‖ {worst:.2e} (tol "
            f"{TRAIN_NORM_TOL:g}), max |Δ| {elem:.2e}")
        require(loss_err <= TRAIN_LOSS_TOL, f"{mode}: card losses differ")
        require(worst <= TRAIN_NORM_TOL, f"{mode}: card training differs")
        out[mode] = dict(loss_err=loss_err, norm_err=worst, max_abs=elem)
    return out


def phase_train(dev) -> dict:
    """Phase "train" (module docstring): (a) QPEFT of phi3-mini-3.8b at
    full width and depth, (d) its fine-tuned container served through
    K1–K4, (b) full mode, (c) the card against the CPU."""
    import gc
    import torch

    tag = "train"
    t0 = time.perf_counter()
    run, st, pass_l, qpeft = train_qpeft(dev, tag)
    qpeft["serve"] = serve_finetuned(dev, tag, run, st, pass_l)
    del run, st, pass_l
    gc.collect()
    torch.cuda.empty_cache()
    qpeft["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    full = train_full(dev, tag)
    gc.collect()
    torch.cuda.empty_cache()
    full["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    vs_cpu = train_card_vs_cpu(dev, tag)
    log(tag, f"(a)+(d) {qpeft['seconds']:.1f} s, (b) {full['seconds']:.1f} s, "
        f"(c) {time.perf_counter() - t0:.1f} s")
    return dict(qpeft=qpeft, full=full, card_vs_cpu=vs_cpu,
                counts=qpeft["serve"]["counts"],
                k7_shapes=qpeft["k7_shapes"])


# ---------------------------------------------------------------------------
# phase 3's kernels of two trees, in turns on one card
# ---------------------------------------------------------------------------
_COMPARE_ROWS = """
import inspect, json, sys, torch
root = sys.argv[1]
sys.path[:0] = [root, root + "/src"]
import chip_smoke as cs
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda")
# K1 at phi3's main shape, the MoE router and the dense lead-in layer; K2
# at both M = 256 shapes and the router's prefill rows; K6 at decode and
# prefill rows, gate/up and down, and (where the tree has it) at the
# serving occupancy of a top-6 routing
rows = [cs.check_qlr(dev, m, k, n, 16, False)
        for m, k, n in ((8, 3072, 8192), (8, 2048, 64), (8, 2048, 10944),
                        (8, 10944, 2048), (256, 3072, 8192),
                        (256, 3072, 3072), (256, 2048, 64))]
# K1/K2 at the MLA projections
rows += [cs.check_qlr(dev, m, k, n, 16, False) for m, k, n in MLA_QLR]
rows += [cs.check_qlr_batched(dev, 64, m, k, n, 16) for m in (8, 30)
         for k, n in ((2048, 1408), (1408, 2048))]
if "top_k" in inspect.signature(cs.check_qlr_batched).parameters:
    rows.append(cs.check_qlr_batched(dev, 64, 8, 2048, 1408, 16, top_k=6))
rows += [cs.check_decode(dev, kind) for kind in ("bf16", "int8", "int4")]
rows.append(cs.check_decode(dev, "bf16", kvh=16, hd=128))
if "ragged" in inspect.signature(cs.check_decode).parameters:
    rows.append(cs.check_decode(dev, "bf16", ragged=True))
rows += [cs.check_flash(dev), cs.check_flash(dev, h=16, hd=128),
         cs.check_flash_chunk(dev)]
rows += [cs.check_paged(dev, kind) for kind in ("bf16", "int8", "int4")]
# K5 at deepseek-moe-16b's head (KV 16, hd 128)
rows.append(cs.check_paged(dev, "bf16", kvh=16, hd=128))
# K3/K5 at the dense variants' groups (G = 16 and 3), where the tree has
# them
if "g" in inspect.signature(cs.check_decode).parameters:
    for kvh, g, kind in cs.DENSE_DECODE:
        rows.append(cs.check_decode(dev, kind, kvh=kvh, hd=128, g=g))
        rows.append(cs.check_paged(dev, kind, kvh=kvh, hd=128, g=g))
# K3's latent instance (MLA), where the tree has it
if hasattr(cs, "check_decode_latent"):
    rows += [cs.check_decode_latent(dev, kind)
             for kind in cs.MLA_LATENT_KINDS]
# K3 and K4 at head dim 256 (recurrentgemma-9b), where the tree has them
if hasattr(cs, "HYBRID_DECODE"):
    rows += [cs.check_decode(dev, kind, kvh=1, hd=256, g=16, ragged=ragged)
             for kind, ragged in cs.HYBRID_DECODE]
    rows.append(cs.check_decode(dev, "bf16", b=2, kvh=1, s=2048, hd=256,
                                g=16, ring=cs.HYBRID_RING))
    rows += [cs.check_flash(dev, h=16, s=s_len, hd=256, g=16, dtype=dtype,
                            window=window)
             for s_len, dtype, window in cs.HYBRID_FLASH]
# K1/K2 at xlstm-125m's projections, where the tree has them (the N % 4
# != 0 case only where the launchers widen it)
if hasattr(cs, "XLSTM_QLR"):
    from repro_torch.kernels import mxint_matmul as mk
    cases = cs.XLSTM_QLR + ((cs.XLSTM_RAGGED,)
                            if hasattr(mk, "pad_cols") else ())
    rows += [cs.check_qlr(dev, m, k, n, r, False) for m in (8, 256)
             for k, n, r in cases]
# K7 at every shape of the SRR pass, a narrow last strip and N % 4 != 0
rows += [cs.check_quantize(dev, m, n) for m, n in K7_SHAPES]
print("ROWS " + json.dumps(rows))
# phase 4's serving over phi3 with a seeded int8 rank-16 container of
# phase 4's shapes: the decode step's launches and bytes, without the
# calibration and the pass
from repro_torch.configs import get_config
from repro_torch.models import init_lm
from repro_torch.models.linear import FpLinear, QLinear
cfg = get_config("phi3-mini-3.8b")
model = init_lm(cfg, 0, device=dev)
gen = torch.Generator(device=dev).manual_seed(5)
for path, p in list(model.named_modules()):
    if not isinstance(p, FpLinear) or path == "lm_head":
        continue
    m, n = p.w.shape
    owner, _, leaf = path.rpartition(".")
    setattr(model.get_submodule(owner), leaf, QLinear(
        torch.full((m // 32, n), 2.0 ** -6, device=dev),
        torch.randn((m, 16), generator=gen, device=dev) * 0.01,
        torch.randn((16, n), generator=gen, device=dev) * 0.01,
        codes=torch.randint(-4, 4, (m, n), generator=gen, device=dev,
                            dtype=torch.int8),
        gscale=torch.ones(16, device=dev), b=p.b))
torch.cuda.empty_cache()
run = cs.phase_main_path(dev, cfg, model)
print("STEP " + json.dumps(dict(step_ms=run["step_ms"], tok_s=run["tok_s"],
      busy_ms=run["profile"]["device_ms"])))
"""


def compare_kernels(parent: str) -> int:
    """Phase 3's Q+LR cases (K1 at its main, router and dense lead-in
    shapes, K2 at both M = 256 shapes and the router's prefill rows, K1
    and K2 at the MLA projections, K6 at its four full-occupancy shapes
    and, where the tree has it, the
    serving occupancy), its K3, K4 and K5 cases and K7's, from the tree at
    ``parent`` and from this one, in the order parent, change, change,
    parent, each turn in a process of its own (each tree builds its
    kernels into its own ``build/``), each turn ending with phase 4's
    serving (its decode step ms, tok/s and device busy ms). Prints one
    line per case, with the library yardstick's fastest and slowest turn,
    and writes ``build/compare_kernels.json``."""
    turns = [("parent", os.path.abspath(parent)), ("change", ROOT),
             ("change", ROOT), ("parent", os.path.abspath(parent))]
    runs, steps = [], []
    for who, root in turns:
        script = _COMPARE_ROWS.replace(
            "K7_SHAPES", repr(K7_SHAPES + MLA_K7 + XLSTM_K7)).replace(
            "MLA_QLR", repr(MLA_QLR))
        proc = subprocess.run([sys.executable, "-c", script, root],
                              capture_output=True, text=True)
        lines = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith(("ROWS ", "STEP "))]
        if proc.returncode or len(lines) < 2:
            print(proc.stdout[-4000:] + proc.stderr[-4000:], file=sys.stderr)
            return 1
        runs.append((who, {(r["name"], r["shape"]): r
                           for r in json.loads(lines[0][5:])}))
        steps.append(dict(turn=who, **json.loads(lines[1][5:])))
        log("compare", f"{who} turn done ({root}): phase 4's decode step "
            f"{steps[-1]['step_ms']:.2f} ms, {steps[-1]['tok_s']:.1f} tok/s, "
            f"device busy {steps[-1]['busy_ms']:.3f} ms a profiled step")
    for key, row in runs[1][1].items():
        ms = [run.get(key, {}).get("ms") for _, run in runs]
        parent_ms = [m for m in (ms[0], ms[3]) if m is not None]
        verdict = ("faster" if parent_ms and max(ms[1:3]) < min(parent_ms)
                   else "not faster" if parent_ms else "new case")
        lib = [run[key]["library_ms"] for _, run in runs if key in run
               and run[key]["library_ms"] is not None]
        log("compare", f"{key[0]:22s} {key[1]:40s} parent/change/change/"
            f"parent ms " + " / ".join("-" if m is None else f"{m:.4f}"
                                       for m in ms)
            + f"; bound {row['bound_ms']:.4f}"
            + (f" (f32 {row['f32_bound_ms']:.4f})"
               if "f32_bound_ms" in row else "")
            + (f"; x·L GEMM {row['xl_ms']:.4f}" if "xl_ms" in row else "")
            + (f"; copy_ {row['copy_ms']:.4f}" if "copy_ms" in row else "")
            + "; library " + (f"{min(lib):.4f}–{max(lib):.4f}" if lib else "-")
            + f"; err {row['max_abs_err']:.2e} (tol {row['tol']:.1e}): "
            f"{verdict}")
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "compare_kernels.json"), "w") as fh:
        json.dump([{"turn": who, "rows": list(run.values()), "step": step}
                   for (who, run), step in zip(runs, steps)], fh, indent=1)
    bad = [k for _, run in runs[1:3] for k, r in run.items()
           if not r["max_abs_err"] <= r["tol"]]
    return 1 if bad else 0


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "src", "repro_torch")):
        print(f"chip_smoke: no src/repro_torch beside {__file__}: the "
              f"script drives the port from a checkout of the repository",
              file=sys.stderr)
        return 1
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
    if len(sys.argv) == 3 and sys.argv[1] == "--compare":
        return compare_kernels(sys.argv[2])

    # (a) of phase "lowering" needs no card: it runs beside the build
    dryrun = start_dryrun()
    atexit.register(lambda: dryrun.poll() is None and dryrun.kill())
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
    k7_ms = {tuple(int(v[2:]) for v in r["shape"].split()[:2]): r["ms"]
             for r in rows if r["name"] == "K7 mxint_quantize"}
    model, t_quant, reports, calib = quantized_model(dev, cfg)
    main_run = phase_main_path(dev, cfg, model)
    main_run.update(quantize_s=t_quant, **calib)
    log("main", f"phase took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    paged_run = phase_paged(dev, cfg, model, main_run["step_ms"])
    log("paged", f"phase took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    surface_run = phase_surface(dev, cfg, model, main_run, paged_run)
    log("surface", f"phase took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    frontend_run = phase_frontend(dev, cfg, model, main_run, paged_run)
    log("frontend", f"phase took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    lowering_run = phase_lowering(dev, cfg, model, smi, dryrun)
    log("lowering", f"phase took {time.perf_counter() - t0:.1f} s")
    del model
    torch.cuda.empty_cache()
    main_run["srr_profile"] = profile_srr(dev, cfg, "main", t_quant, reports,
                                          k7_ms)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase_reduced(dev, dataclasses.replace(cfg, n_layers=2))
    log("reduced", f"phase took {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ptq_run = phase_ptq(dev, dataclasses.replace(cfg, n_layers=PTQ_LAYERS))
    log("ptq", f"phase took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    moe_run = phase_moe(dev)
    log("moe", f"phase took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    dense_run = phase_dense(dev)
    log("dense", f"phase took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    depth_run = phase_depth(dev)
    log("depth", f"phase took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    mla_run = phase_mla(dev)
    log("mla", f"phase took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    hybrid_run = phase_hybrid(dev)
    log("hybrid", f"phase took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    xlstm_run = phase_xlstm(dev)
    log("xlstm", f"phase took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    whisper_run = phase_whisper(dev)
    log("whisper", f"phase took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    vlm_run = phase_vlm(dev)
    log("vlm", f"phase took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    train_run = phase_train(dev)
    log("train", f"phase took {time.perf_counter() - t0:.1f} s")

    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as fh:
        json.dump({"device": name, "nvidia_smi": smi, "cases": rows,
                   "main_path": main_run, "paged_path": paged_run,
                   "surface": surface_run, "frontend": frontend_run,
                   "lowering": lowering_run,
                   "ptq": ptq_run,
                   "moe_path": moe_run, "dense": dense_run,
                   "depth": depth_run,
                   "mla": mla_run, "hybrid": hybrid_run,
                   "xlstm": xlstm_run, "whisper": whisper_run,
                   "vlm": vlm_run, "train": train_run}, fh, indent=1)

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
                    "src/repro/kernels/flash_attention.py:78"),
             "K5": ("K5 flash_decode_paged",
                    "B=8 KV=32 G=1 hd=96 ps=16 nb=32 P=296 bf16",
                    "src/repro_torch/kernels/csrc/decode_attention.cu",
                    "src/repro/kernels/decode_attention.py:201"),
             "K6": ("K6 qlr_batched_matmul", "E=64 M=8 K=2048 N=1408 r=16 int8",
                    "src/repro_torch/kernels/csrc/mxint_matmul.cu",
                    "src/repro/kernels/mxint_matmul.py:266"),
             "K7": ("K7 mxint_quantize", "M=2048 N=1408 bits=3",
                    "src/repro_torch/kernels/csrc/mxint_quantize.cu",
                    "src/repro/kernels/mxint_quantize.py:38")}
    # launches: K1–K4 from the unpaged main path (phase 4), K5 from the
    # paged one (phase 4b), K6 from the MoE one (phase 6) and K7 from its
    # PTQ pass, each read around its own run; the dense variants' rows
    # from their own arch's serving run or PTQ pass in phase "dense", and
    # qwen1.5-32b's from its 64-layer run in phase "depth" (b)
    runs = [(key, key, {"K5": paged_run["counts"], "K6": moe_run["counts"],
                        "K7": moe_run["ptq_counts"]}.get(key,
                                                         main_run["counts"]))
            for key in picks]
    glm, mini = dense_run["chatglm3-6b"], dense_run["minitron-4b"]
    qwen = depth_run["b"]
    for kvh, g, kind in DENSE_DECODE[:2]:
        arch = glm if g == 16 else mini
        picks[f"K3 G{g}"] = ("K3 flash_decode",
                             f"B=8 KV={kvh} G={g} S=512 hd=128 {kind}",
                             *picks["K3"][2:])
        picks[f"K5 G{g}"] = ("K5 flash_decode_paged",
                             f"B=8 KV={kvh} G={g} hd=128 ps=16 nb=32 P=296 "
                             f"{kind}", *picks["K5"][2:])
        runs += [(f"K3 G{g}", "K3", arch["unpaged"]["counts"]),
                 (f"K5 G{g}", "K5", arch["paged"]["counts"])]
    for k, n in DENSE_QLR:
        key = f"K1 {k}x{n}"
        picks[key] = ("K1 qlr_fused_matmul", f"M=8 K={k} N={n} r=16 int8",
                      *picks["K1"][2:])
        runs.append((key, "K1", (qwen if n == 27392 else glm)["unpaged"]
                     ["counts"]))
    for m, n in DENSE_K7:
        key = f"K7 {m}x{n}"
        picks[key] = ("K7 mxint_quantize", f"M={m} N={n} bits=3",
                      *picks["K7"][2:])
        runs.append((key, "K7", (qwen if m == 27392 else glm)["ptq_counts"]))
    # K3's latent instance, served by phase "mla" with bf16 latents (the
    # f32 row stays in build/chip_smoke.json: no phase serves f32 latents)
    picks["K3 latent"] = ("K3 flash_decode",
                          "B=8 KV=1 G=16 S=512 hd=576 dv=512 bf16",
                          *picks["K3"][2:])
    runs.append(("K3 latent", "K3", mla_run["counts"]))
    for m, k, n in MLA_QLR:
        kernel = "K1" if m <= 128 else "K2"
        key = f"{kernel} mla {m}x{k}x{n}"
        picks[key] = (picks[kernel][0], f"M={m} K={k} N={n} r=16 int8",
                      *picks[kernel][2:])
        runs.append((key, kernel, mla_run["counts"]))
    for m, n in MLA_K7:
        key = f"K7 mla {m}x{n}"
        picks[key] = ("K7 mxint_quantize", f"M={m} N={n} bits=3",
                      *picks["K7"][2:])
        runs.append((key, "K7", mla_run["ptq_counts"]))
    # phase "hybrid": K3 at head dim 256 (bf16 at the serving rows, served
    # by run (a); int8, by run (c)), on the wrapped ring (run (b)), K4 at
    # head dim 256 (f32: run (a)'s 256-token prefills, and under the
    # window: run (b)'s), K1/K2 at its projections (run (a)), K7 at its
    # matrices (its PTQ pass); the f32/int4 K3 and bf16 K4 rows stay in
    # build/chip_smoke.json (no run serves them)
    hyb = {"K3 hd256": ("K3 flash_decode",
                        "B=8 KV=1 G=16 S=512 hd=256 bf16 rows 150-282",
                        hybrid_run["counts"]),
           "K3 hd256 int8": ("K3 flash_decode",
                             "B=8 KV=1 G=16 S=512 hd=256 int8",
                             hybrid_run["counts_int8"]),
           "K3 ring": ("K3 flash_decode",
                       f"B=2 KV=1 G=16 S=2048 hd=256 bf16 ring "
                       f"{HYBRID_RING - 2048}-{HYBRID_RING - 1} window 2048",
                       hybrid_run["counts_ring"]),
           "K4 hd256": ("K4 flash_attention",
                        "H=16 KV=1 S=256 hd=256 causal f32",
                        hybrid_run["counts"]),
           "K4 window": ("K4 flash_attention",
                         "H=16 KV=1 S=2100 hd=256 causal f32 window 2048",
                         hybrid_run["counts_ring"])}
    for key, (kname, shape, counts) in hyb.items():
        kernel = kname.split()[0]
        picks[key] = (kname, shape, *picks[kernel][2:])
        runs.append((key, kernel, counts))
    for m, k, n in HYBRID_QLR:
        kernel = "K1" if m <= 128 else "K2"
        key = f"{kernel} hybrid {m}x{k}x{n}"
        picks[key] = (picks[kernel][0], f"M={m} K={k} N={n} r=16 int8",
                      *picks[kernel][2:])
        runs.append((key, kernel, hybrid_run["counts"]))
    for m, n in HYBRID_K7:
        key = f"K7 hybrid {m}x{n}"
        picks[key] = ("K7 mxint_quantize", f"M={m} N={n} bits=3",
                      *picks["K7"][2:])
        runs.append((key, "K7", hybrid_run["ptq_counts"]))
    # phase "xlstm": K1/K2 at its projections and at N = 85 (run (a)'s
    # counts: 66 a decode step, 66 a prefill), K7 at its matrices (its
    # PTQ pass)
    for m in (8, 256):
        kernel = "K1" if m <= 128 else "K2"
        for k, n, rank in XLSTM_QLR + (XLSTM_RAGGED,):
            key = f"{kernel} xlstm {m}x{k}x{n}"
            picks[key] = (picks[kernel][0],
                          f"M={m} K={k} N={n} r={rank} int8",
                          *picks[kernel][2:])
            runs.append((key, kernel, xlstm_run["counts"]))
    for m, n in XLSTM_K7:
        key = f"K7 xlstm {m}x{n}"
        picks[key] = ("K7 mxint_quantize", f"M={m} N={n} bits=3",
                      *picks["K7"][2:])
        runs.append((key, "K7", xlstm_run["ptq_counts"]))
    # phase "whisper": K4 at head dim 64 (the encoder's and the cross
    # prefill's non-causal attention, the decoder's causal prefill), K3 at
    # hd 64 over the self cache and the cross memory (bf16: run (a); the
    # self cache in int8: run (b)), K1/K2 at its projections (run (a)),
    # K7 at its matrices (its PTQ pass); the f32 cross-memory K3 row stays
    # in build/chip_smoke.json (no run serves an f32 cache)
    for sq, sk, causal in WHISPER_FLASH:
        shape = (f"H=20 Sq={sq} Sk={sk} hd=64 non-causal f32" if not causal
                 else f"H=20 S={sq} hd=64 causal f32")
        key = f"K4 whisper {shape}"
        picks[key] = ("K4 flash_attention", shape, *picks["K4"][2:])
        runs.append((key, "K4", whisper_run["counts"]))
    for s_len, kind in WHISPER_DECODE[:3]:
        shape = f"B=8 KV=20 G=1 S={s_len} hd=64 {kind}"
        key = f"K3 whisper {shape}"
        picks[key] = ("K3 flash_decode", shape, *picks["K3"][2:])
        runs.append((key, "K3", whisper_run["counts_int8" if kind == "int8"
                                            else "counts"]))
    for m, k, n in WHISPER_QLR:
        kernel = "K1" if m <= 128 else "K2"
        key = f"{kernel} whisper {m}x{k}x{n}"
        picks[key] = (picks[kernel][0], f"M={m} K={k} N={n} r=16 int8",
                      *picks[kernel][2:])
        runs.append((key, kernel, whisper_run["counts"]))
    for m, n in WHISPER_SHAPES:
        key = f"K7 whisper {m}x{n}"
        picks[key] = ("K7 mxint_quantize", f"M={m} N={n} bits=3",
                      *picks["K7"][2:])
        runs.append((key, "K7", whisper_run["ptq_counts"]))
    # phase "vlm": K1/K2 at its projections, K3 at G 2 over its serving
    # rows, K4 at its 512-row prefill (run (a)'s counts), K7 at its
    # matrices (its PTQ pass, by shape)
    for m, k, n in VLM_QLR:
        kernel = "K1" if m <= 128 else "K2"
        key = f"{kernel} vlm {m}x{k}x{n}"
        picks[key] = (picks[kernel][0], f"M={m} K={k} N={n} r=16 int8",
                      *picks[kernel][2:])
        runs.append((key, kernel, vlm_run["counts"]))
    vlm_attn = {"K3 vlm": ("K3 flash_decode",
                           f"B=8 KV=8 G=2 S={VLM_MAX_LEN} hd=128 bf16 rows "
                           f"{VLM_ROWS}-{VLM_ROWS + 132}"),
                "K4 vlm": ("K4 flash_attention",
                           f"H=16 KV=8 S={VLM_PREFILL} hd=128 causal f32")}
    for key, (kname, shape) in vlm_attn.items():
        kernel = kname.split()[0]
        picks[key] = (kname, shape, *picks[kernel][2:])
        runs.append((key, kernel, vlm_run["counts"]))
    for m, n in VLM_SHAPES:
        key = f"K7 vlm {m}x{n}"
        picks[key] = ("K7 mxint_quantize", f"M={m} N={n} bits=3",
                      *picks["K7"][2:])
        runs.append((key, "K7", {"K7": vlm_run["k7_shapes"].get(
            f"{m}x{n}", 0)}))
    # phase "train": K1–K4 at phi3's rows, launched by (d)'s serving of the
    # fine-tuned container; K7 at phi3's matrices, each row with the
    # launches (a)'s qpeft pass made at its shape
    for key in ("K1", "K2", "K3", "K4"):
        picks[f"{key} train"] = picks[key]
        runs.append((f"{key} train", key, train_run["counts"]))
    for m, n in K7_SHAPES[:3]:
        key = f"K7 train {m}x{n}"
        picks[key] = ("K7 mxint_quantize", f"M={m} N={n} bits=3",
                      *picks["K7"][2:])
        runs.append((key, "K7", {"K7": train_run["k7_shapes"].get(
            f"{m}x{n}", 0)}))
    kernels = []
    for key, kernel, counts in runs:
        kname, shape, source, replaces = picks[key]
        row = next(r for r in rows if r["name"] == kname
                   and r["shape"] == shape)
        entry = {"name": f"{kname} ({shape})", "route": "cuda",
                 "source": source, "replaces": replaces,
                 "launches": counts[kernel],
                 "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                 "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                 "bound_by": row["bound_by"],
                 "library_ms": row["library_ms"]}
        if "note" in row:
            entry["note"] = row["note"]
        for extra in ("f32_bound_ms", "copy_ms"):
            if extra in row:
                entry[extra] = row[extra]
        kernels.append(entry)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
