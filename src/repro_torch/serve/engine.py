"""Serving engine: continuous batching over a Q + LR model (port of
``repro/serve/engine.py``).

Two schedulers, as in the JAX package:

  * ``continuous`` (default): a slot-based KV cache (``serve.slots``)
    gives every batch row its own write position and slot map, so
    requests are admitted into free slots mid-flight: prefill-on-admit
    copies a freshly prefilled row into the live cache while the other
    slots keep decoding, and a request retires the moment it reaches its
    ``max_new_tokens`` or a stop token. Prompts are right-padded to one
    prefill width (``prefill_len``) and masked.
  * ``bucketed`` (baseline): requests grouped by prompt length, each
    bucket padded to ``decode_batch`` and decoded to its slowest member.
    It draws from the same counter-based streams, so the two schedulers
    agree token for token.

``ServeConfig(paged=True)`` serves from the paged cache instead
(``serve.pages``): a page pool shared by the lanes, one block table per
lane, radix-tree prefix reuse (``serve.prefix``: a prompt whose leading
blocks were prefilled before maps their pages and skips their compute),
and chunked prefill — a prompt of any length below ``max_len`` streams
in ``prefill_len``-wide chunks, one per engine step, interleaved with
the other lanes' decode. ``max_step_tokens`` arms the token-budget step
scheduler (``serve.scheduler.StepBudget``) under either cache.

An MLA model (``attn_kind="mla"``) serves over its latent cache with the
absorbed decode: its dense W_uk/W_uv are built once per engine, and its
decode attention runs through K3 at the latent head. A hybrid model
(``block_pattern`` with ``rglru``/``local`` blocks: recurrentgemma-9b)
serves its RG-LRU states and sliding-window rings from the same slot
cache, and an xLSTM model (xlstm-125m) its f32 mLSTM and sLSTM states,
each admission prefilled from the zero template. An encoder-decoder
(whisper-large-v3) encodes its ``frames`` at every admission, from
``extra_inputs={"frames": (N, enc_seq, d_frontend)}`` or zeros, and
keeps each lane's cross memory in the slot cache beside its K/V; as in
the JAX engine a continuous admission (a batch of one) takes
``frames[0]`` for every request and a bucketed run ``frames[:b]`` for
its ``b`` lanes. A VLM (internvl2-2b) puts its ``n_vision_tokens``-row
prefix, from ``extra_inputs={"vision": (N, n_vision_tokens,
d_frontend)}`` or zeros, in front of every prompt by the same rule
(``vision[0]`` at a continuous admission, ``vision[:b]`` in a bucketed
run): the prefix counts toward ``max_len`` and ``prefill_len`` and
toward each lane's positions, and a continuous admission pads the prompt
to ``prefill_len - n_vision_tokens`` so that its prefill, prefix
included, is ``prefill_len`` rows (JAX pads the prompt itself to
``prefill_len``; the valid rows are the same). As in the JAX engine none
of them takes the paged cache or speculative decoding: both are for
pure full-GQA-attention stacks.

``ServeConfig(speculative=True)`` decodes greedy lanes
self-speculatively: ``spec_k - 1`` draft steps through the quantized
base alone (``Ctx(draft=True)``: every ``QLinear`` at rank 0), then one
``verify_chunk`` per lane re-scores [last token ‖ drafts] with the full
Q + LR model, and the drafts it agrees with are emitted. Greedy output
is token-identical to plain decode.

Observability, as in the JAX engine: ``stats()`` / ``metrics()`` /
``prometheus()`` are one snapshot of a ``MetricsRegistry``
(``serve.telemetry``) that the scheduler, page pool and prefix cache
publish into; ``ServeConfig(telemetry=True)`` adds request and step
tracing (``write_trace``), latency and phase histograms and per-entry
dispatch accounting; ``sanitize=True`` audits the slot/page state after
every step (``serve.sanitizer``); ``drift_monitor=True`` compares a
sample of decode steps' logits against a reference lowering of the same
weights (``drift_ref_fused``, default the dequantize-then-matmul path),
leaving tokens and the cache bit for bit as they would be without it.

``fused="auto"`` (the default) runs every quantized projection through
K1/K2 (an MoE model's int8 expert stacks through K6) and attention
through K3/K4 (paged: K5 for decode, K4 for each chunk) on a CUDA
device, and through their plain versions on the CPU. ``fused="off"``
keeps the dequantize-then-matmul and dequantize-the-cache baselines.

Request surface (that of the JAX engine):

  * per-request :class:`~repro_torch.serve.sampling.SamplingParams` on
    ``Request.params`` — temperature / top-p / top-k / seed / stop ids /
    max_new_tokens / logprobs; mixed greedy and sampled lanes decode
    together, each lane drawing from its own counter-based stream
    (JAX's threefry, ``serve.prng``), so a request's tokens do not
    depend on scheduling. ``ServeConfig.temperature`` / ``eos_id`` are
    defaults only.
  * ``Result.finish_reason`` ∈ ``"stop" | "length" | "abort"``.
  * ``abort(uid)`` cancels a request anywhere in its lifecycle — queued,
    mid-chunked-prefill (pages decref'd, prefix match released) or
    decoding — and frees its slot at once.
  * ``on_token(uid, token, info)`` streams every generated token as it
    is recorded (``info``: the logprob record, when asked for).

API: ``submit()`` / ``step()`` / ``drain()`` / ``abort()`` for streaming
use, ``generate()`` for a batch of requests under either scheduler.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels.constraints import validate_page_size
from repro_torch.models.attention import (absorb_mla_weights,
                                          restore_step_writes,
                                          save_step_writes)
from repro_torch.models.linear import Ctx, QLinear
from repro_torch.models.transformer import (LM, decode_step, init_cache,
                                            prefill, prefill_chunk,
                                            verify_chunk)
from repro_torch.serve.pages import PagedKVCache, PagePool
from repro_torch.serve.prefix import RadixPrefixCache
from repro_torch.serve.sampling import (TOP_LOGPROBS, SamplingParams,
                                        lane_seed, sample_tokens)
from repro_torch.serve.sanitizer import Sanitizer
from repro_torch.serve.scheduler import (ContinuousScheduler, SchedulerStats,
                                         StepBudget)
from repro_torch.serve.slots import KV_DTYPES, SlotKVCache, SlotState
from repro_torch.serve.telemetry import (NULL_TELEMETRY, MetricsRegistry,
                                         Telemetry, log_buckets, named_scope)

COMPUTE_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


@dataclasses.dataclass
class ServeConfig:
    max_len: int = 512               # cache slots (prompt + generation)
    decode_batch: int = 8            # decode lanes (= slots, continuous)
    max_new_tokens: int = 64
    eos_id: int = -1                 # -1: never stop early. DEFAULT only:
    # per-request SamplingParams.stop ids extend it
    kv_dtype: str = "bf16"           # bf16 | f32 | int8 | int4
    temperature: float = 0.0         # 0 = greedy. DEFAULT only: a
    # request's SamplingParams.temperature overrides it per lane
    compute_dtype: str = "f32"       # f32 | bf16
    scheduler: str = "continuous"    # continuous | bucketed
    prefill_len: Optional[int] = None  # prompt pad width (default
    # max_len); under paged=True the chunk width, no prompt-length cap
    seed: int = 0                    # sampling stream base for submit()/
    # step(); generate(seed=) overrides it per run
    fused: str = "auto"              # Q+LR matmul / attention: auto|on|off
    # --- paged KV cache (serve.pages / serve.prefix) ---
    paged: bool = False              # block-granular pages + block tables
    page_size: int = 16              # logical slots per page (even)
    n_pages: Optional[int] = None    # pool size; default: full residency
    # of every lane + its parked page + one request of prefix headroom
    prefix_cache: bool = True        # radix-tree automatic prefix reuse
    # --- token-budget step scheduler ---
    max_step_tokens: Optional[int] = None  # per-step cap on prefill
    # tokens (dispatches at their padded width) + decode lanes; None =
    # unbudgeted. Must cover one prefill dispatch + 1
    max_pages_per_request: Optional[int] = None  # paged: page quota per
    # request, clamping its decode budget
    free_watermark: float = 0.0      # paged: fraction of the pool kept
    # free by evicting cold prefix pages ahead of demand each step
    # --- self-speculative decoding (Q-only draft, Q+LR verify) ---
    speculative: bool = False        # draft with the quantized base alone,
    # then score spec_k tokens in one full-model chunk a lane; greedy
    # lanes only (sampled lanes decode per token), token-identical
    spec_k: int = 4                  # tokens scored per verify chunk
    # (the last token + spec_k - 1 drafts); >= 2
    # --- telemetry (serve.telemetry) ---
    telemetry: bool = False          # request/step tracing + latency
    # histograms + dispatch accounting; the metrics registry itself is
    # always live (stats()/metrics()/prometheus() are one snapshot)
    trace_sync: bool = False         # torch.cuda.synchronize after each
    # device dispatch, so device time lands in the phase that launched it
    profile_dir: Optional[str] = None  # arm torch.profiler capture here
    profile_steps: int = 20          # engine steps to capture when armed
    # --- runtime invariant sanitizer (serve.sanitizer) ---
    sanitize: bool = False           # audit page refcounts, block tables,
    # pos/slot_pos and int4 alignment after every step(); read-only
    # (token-identical) but host-syncing: smokes and debugging
    # --- accuracy-drift monitor ---
    drift_monitor: bool = False      # sampled shadow comparison of the
    # serving logits against a reference lowering of the same quantized
    # model: per-lane KL / top-1 agreement / max-|Δlogit| histograms +
    # NaN/inf guard counters. Token- and cache-identical; costs one
    # extra decode pass per sampled step
    drift_sample_rate: float = 0.05  # fraction of plain decode steps
    # compared (deterministic in the step counter); 1.0 = every step
    drift_ref_fused: str = "off"     # fused mode of the reference
    # lowering (auto | on | off); "off" = dequantize-then-matmul, the
    # path the kernels are held against


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray               # (L,) int32
    max_new_tokens: Optional[int] = None  # deprecated shim — prefer
    # params.max_new_tokens (params wins when both are set)
    t_submit: float = 0.0
    params: Optional[SamplingParams] = None  # per-request sampling/stop;
    # submit() resolves None fields against the ServeConfig defaults


@dataclasses.dataclass
class Result:
    """Timings are ``None`` when the event never happened (a request
    retired without decoding has no ``decode_s``/``ttft_s``)."""
    uid: int
    tokens: np.ndarray               # generated tokens (without prompt)
    prefill_s: Optional[float] = None
    decode_s: Optional[float] = None   # first token → last token
    ttft_s: Optional[float] = None     # submit → first token
    latency_s: Optional[float] = None  # submit → done
    finish_reason: Optional[str] = None  # "stop" (EOS / stop id, token
    # included in tokens) | "length" (budget exhausted) | "abort"


@dataclasses.dataclass
class _PrefillJob:
    """A paged admission mid-chunked-prefill: the slot is allocated and
    its block table mapped, but the prompt is only prefilled up to
    ``next`` — one chunk advances per engine step, interleaved with the
    other slots' decode."""
    req: Request
    state: SlotState
    next: int                        # first not-yet-prefilled position
    matched_tokens: int              # prefix-cache tokens skipped
    prepaid: bool = False            # this step's chunk already charged
    # to the token budget at admission (don't double-charge)


def _has_lowrank(model: LM) -> bool:
    """True when any quantized projection carries a non-empty low-rank
    correction. Decides the speculative verify's storage mode: without
    one the Q-only draft IS the model, so the drafts' decode-step K/V
    are already exact and the verify can stay read-only."""
    return any(isinstance(m, QLinear) and m.l.shape[-1] > 0
               for m in model.modules())


def _logprobs(lg: torch.Tensor, tok: torch.Tensor) -> tuple:
    """(chosen logprob (B,), top-``TOP_LOGPROBS`` logprobs and ids (B, n))
    of f32 logits (B, V) and the sampled tokens (B,), on device."""
    lp = torch.log_softmax(lg, dim=-1)
    chosen = lp.gather(-1, tok[:, None])[:, 0]
    top_lp, top_ids = torch.topk(lp, TOP_LOGPROBS, dim=-1)
    return chosen, top_lp, top_ids


class Engine:
    def __init__(self, model: LM, cfg: ModelConfig, sc: ServeConfig, *,
                 device="cuda",
                 extra_inputs: Optional[Dict[str, np.ndarray]] = None):
        self.device = resolve_device(device)
        if model.device.type != self.device.type:
            raise ValueError(f"model lives on {model.device}, the engine "
                             f"was asked to serve on {self.device}")
        if sc.scheduler not in ("continuous", "bucketed"):
            raise ValueError(f"unknown scheduler {sc.scheduler!r}")
        if sc.fused not in ("auto", "on", "off"):
            raise ValueError(f"unknown fused mode {sc.fused!r}")
        if sc.kv_dtype not in KV_DTYPES:
            raise ValueError(f"unknown kv_dtype {sc.kv_dtype!r} "
                             f"(choose from {sorted(KV_DTYPES)})")
        if sc.compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"unknown compute_dtype {sc.compute_dtype!r}")
        continuous = sc.scheduler == "continuous"
        mla = cfg.attn_kind == "mla"
        # the paged cache and the chunked verify need every layer full GQA
        # attention, as the JAX engine's guards have it
        not_gqa = (any(k != "attn" for k in cfg.block_pattern) or mla
                   or cfg.is_encoder_decoder or bool(cfg.n_vision_tokens))
        if sc.paged:
            if not continuous:
                raise ValueError("paged KV needs scheduler='continuous'")
            if not_gqa:
                raise ValueError(
                    f"paged KV cache supports pure full-GQA-attention "
                    f"stacks (got pattern={cfg.block_pattern}, "
                    f"attn_kind={cfg.attn_kind!r}): recurrent states, MLA "
                    f"latents and encoder memories have no block-sharing "
                    f"story yet")
        if sc.speculative:
            if not continuous:
                raise ValueError("speculative decoding needs "
                                 "scheduler='continuous'")
            if sc.spec_k < 2:
                raise ValueError(
                    f"spec_k={sc.spec_k} must be >= 2 — one Q-only draft "
                    f"token plus the verify model's own next token")
            if not_gqa:
                raise ValueError(
                    f"speculative decoding verifies through the chunked "
                    f"attention path and needs a pure full-GQA-attention "
                    f"decoder (got pattern={cfg.block_pattern}, "
                    f"attn_kind={cfg.attn_kind!r})")
        if sc.drift_ref_fused not in ("auto", "on", "off"):
            raise ValueError(
                f"unknown drift_ref_fused {sc.drift_ref_fused!r}")
        if sc.drift_monitor:
            if not continuous:
                raise ValueError("drift_monitor shadows the continuous "
                                 "engine's decode dispatch — it needs "
                                 "scheduler='continuous'")
            if not 0.0 < sc.drift_sample_rate <= 1.0:
                raise ValueError(
                    f"drift_sample_rate={sc.drift_sample_rate} must be "
                    f"in (0, 1]")
        if sc.sanitize and not continuous:
            raise ValueError("sanitize=True audits the continuous "
                             "engine's slot/page state — it needs "
                             "scheduler='continuous'")
        self.model, self.cfg, self.sc = model, cfg, sc
        # an encoder-decoder's frames and a VLM's vision prefix, on the
        # device once; None: zeros
        extra = extra_inputs or {}

        def on_device(key: str, used: bool) -> Optional[torch.Tensor]:
            if extra.get(key) is None or not used:
                return None
            return torch.as_tensor(np.asarray(extra[key], np.float32),
                                   device=self.device)

        self._frames = on_device("frames", cfg.is_encoder_decoder)
        self._vision = on_device("vision", bool(cfg.n_vision_tokens))
        self._n_vis = cfg.n_vision_tokens or 0
        # MLA decode's dense W_uk/W_uv, built once for this engine (JAX's
        # absorbed_params) and shared by every context
        absorbed = ({blk.mixer: absorb_mla_weights(blk.mixer)
                     for blk in model.blocks} if mla else None)
        self.ctx = Ctx(compute_dtype=COMPUTE_DTYPES[sc.compute_dtype],
                       fused=sc.fused, absorbed=absorbed)
        self._dctx = dataclasses.replace(self.ctx, draft=True)
        # the drift monitor's reference lowering of the same weights
        self._rctx = dataclasses.replace(self.ctx, fused=sc.drift_ref_fused)
        self._drift_every = (max(1, round(1.0 / sc.drift_sample_rate))
                             if sc.drift_monitor else 0)
        self._drift_step = 0
        # the registry is always live (stats()/metrics()/prometheus() are
        # snapshots of it); the recorder — tracing, phase histograms,
        # dispatch accounting — is the no-op singleton unless asked for
        self.registry = MetricsRegistry()
        if sc.telemetry or sc.profile_dir:
            self.tel = Telemetry(registry=self.registry, sync=sc.trace_sync,
                                 profile_dir=sc.profile_dir,
                                 profile_steps=sc.profile_steps)
        else:
            self.tel = NULL_TELEMETRY
        # the verify writes full-model K/V over the drafts' only when the
        # draft differs from the model (see verify_chunk)
        self._spec_store = _has_lowrank(model)
        self.prefill_len = sc.prefill_len or sc.max_len
        if self.prefill_len > sc.max_len:
            raise ValueError(f"prefill_len={self.prefill_len} exceeds "
                             f"max_len={sc.max_len}: the prefill must fit "
                             f"the cache")
        # paged geometry: the chunk width is the (even) prefill width, and
        # chunk starts are page-aligned (matched prefixes are whole
        # pages), so int4 nibble pairs land whole
        self.page_size = sc.page_size + sc.page_size % 2
        if sc.paged:
            validate_page_size(self.page_size)
        self._chunk_len = (self.prefill_len + self.prefill_len % 2
                           if sc.paged else self.prefill_len)
        # the unit of prefill work is one dispatch at its padded width,
        # and an admission whose prefill completes at once also decodes
        # this step (+1)
        if sc.max_step_tokens is not None:
            if not continuous:
                raise ValueError("max_step_tokens needs "
                                 "scheduler='continuous'")
            if sc.max_step_tokens < self._chunk_len + 1:
                raise ValueError(
                    f"max_step_tokens={sc.max_step_tokens} cannot cover one "
                    f"prefill dispatch ({self._chunk_len} tokens) plus its "
                    f"first decode lane: an idle engine could never admit "
                    f"anything")
        if not 0.0 <= sc.free_watermark < 1.0:
            raise ValueError(f"free_watermark={sc.free_watermark} must be in "
                             f"[0, 1)")
        if sc.max_pages_per_request is not None \
                and sc.max_pages_per_request < 1:
            raise ValueError("max_pages_per_request must be >= 1")
        if (sc.max_pages_per_request is not None
                or sc.free_watermark > 0.0) and not sc.paged:
            raise ValueError("max_pages_per_request / free_watermark need "
                             "ServeConfig(paged=True)")
        self._base_seed = sc.seed        # sampling stream base for
        # submit()/step(); generate(seed=) overrides it per run
        # per-lane sampling state mirrored into every decode step
        b = sc.decode_batch
        self._lane_temp = np.zeros((b,), np.float32)
        self._lane_top_p = np.ones((b,), np.float32)
        self._lane_top_k = np.zeros((b,), np.int32)
        self._lane_seed = np.zeros((b,), np.int32)
        self._lane_lp = np.zeros((b,), bool)
        self._want_lp = False            # any live lane wants logprobs
        # streaming hook: on_token(uid, token, info) for every generated
        # token the moment it is recorded; info is the logprob record when
        # the request asked for logprobs, else None
        self.on_token: Optional[Callable[[int, int, Optional[Dict]],
                                         None]] = None
        self.sched: Optional[ContinuousScheduler] = None
        self.pool: Optional[PagePool] = None
        self.prefix: Optional[RadixPrefixCache] = None
        self._prefill_jobs: Dict[int, _PrefillJob] = {}
        self._h_accept = self.registry.histogram(
            "spec_accept_per_round",
            "accepted draft tokens per lane per speculative round")
        self._h_drift_kl = self.registry.histogram(
            "drift_kl",
            "per-lane KL(serving ‖ reference) at drift-sampled steps",
            buckets=log_buckets(1e-12, 100.0, 2))
        self._h_drift_delta = self.registry.histogram(
            "drift_logit_delta",
            "per-lane max |Δlogit| vs the reference lowering at "
            "drift-sampled steps",
            buckets=log_buckets(1e-12, 100.0, 2))
        self._reset_counters()
        self._bucket_stats = SchedulerStats(n_slots=b)
        self._san = Sanitizer() if sc.sanitize else None
        if continuous:
            self._reset()

    def _reset(self) -> None:
        sc = self.sc
        self.sched = ContinuousScheduler(sc.decode_batch, sc.eos_id,
                                         sc.max_new_tokens,
                                         max_step_tokens=sc.max_step_tokens)
        self._need_plain = False         # a rejection forces one plain
        # decode step (the correction token's source)
        self._tok = torch.zeros((sc.decode_batch, 1), dtype=torch.int64,
                                device=self.device)
        if not sc.paged:
            self.slots = SlotKVCache(self.cfg, sc.decode_batch, sc.max_len,
                                     sc.kv_dtype, self.device)
            return
        ps = self.page_size
        nb = -(-sc.max_len // ps)
        # full residency for every lane + its parked page + one request's
        # worth of prefix-retention headroom
        n_pages = sc.n_pages or (sc.decode_batch * (nb + 1) + nb)
        if n_pages < nb + sc.decode_batch:
            raise ValueError(
                f"n_pages={n_pages} cannot hold one parked page per slot "
                f"plus one full request ({nb} blocks at page_size={ps})")
        self.slots = PagedKVCache(self.cfg, sc.decode_batch, sc.max_len,
                                  sc.kv_dtype, ps, n_pages, self.device)
        self.pool = PagePool(n_pages, ps)
        self.prefix = RadixPrefixCache(self.pool) if sc.prefix_cache else None
        # one permanently-allocated private page per slot: retired (and
        # still-prefilling) rows point every unused block-table entry at
        # it, so the decode step's unconditional write never lands in a
        # page another request owns
        self._parked = self.pool.alloc(sc.decode_batch)
        self._row_pages: Dict[int, List[int]] = {}
        self._reset_paged_counters()
        for slot in range(sc.decode_batch):
            self.slots.set_row(slot, [self._parked[slot]] * nb, 0)

    def _reset_paged_counters(self) -> None:
        self._prefill_chunks = 0
        self._prefill_tokens_computed = 0
        self._prompt_tokens_total = 0
        self._prefix_hit_tokens = 0

    def _reset_counters(self) -> None:
        """The speculative and drift-monitor tallies (published always,
        zeros when the mode is off)."""
        self._spec_rounds = 0
        self._spec_draft_tokens = 0
        self._spec_accepted_tokens = 0
        self._drift_checks = 0
        self._drift_agree = 0
        self._drift_nonfinite = 0
        self._guard_oob = 0

    def reset_stats(self) -> None:
        """Start a fresh measurement window — histograms, counters,
        pool/prefix stats, trace — without touching scheduler state, the
        cache or the prefix tree. ``generate()`` calls this; callers
        driving ``submit()``/``step()`` directly call it between runs."""
        n = self.sc.decode_batch
        if self.sched is not None:
            self.sched.stats = SchedulerStats(n_slots=n)
        self._bucket_stats = SchedulerStats(n_slots=n)
        self._reset_counters()
        if self.sc.paged:
            self.pool.reset_stats()
            if self.prefix is not None:
                self.prefix.reset_stats()
            self._reset_paged_counters()
        # histogram samples reset even with telemetry off (the acceptance
        # and drift histograms are registry-resident either way); the
        # per-entry dispatch accounting survives: it describes the session
        self.registry.reset_histograms()
        self.tel.reset_run()

    def _to_device(self, t: torch.Tensor) -> torch.Tensor:
        """A host tensor on the engine's device; to a card from pinned
        memory, so the copy does not wait for the device."""
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    # ------------------------------------------------------------------
    def _req_budget(self, r: Request) -> int:
        """Per-request token budget; ``is not None`` (not truthiness) so
        an explicit max_new_tokens=0 stays 0."""
        if r.params is not None and r.params.max_new_tokens is not None:
            return r.params.max_new_tokens
        return (r.max_new_tokens if r.max_new_tokens is not None
                else self.sc.max_new_tokens)

    def _resolve(self, req: Request) -> SamplingParams:
        """Fill a request's ``SamplingParams`` None fields from the
        ServeConfig defaults (and the deprecated ``Request.
        max_new_tokens`` shim) — after this, every field is concrete."""
        sp = req.params or SamplingParams()
        t = (sp.temperature if sp.temperature is not None
             else self.sc.temperature)
        mnt = sp.max_new_tokens
        if mnt is None:
            mnt = req.max_new_tokens
        if mnt is None:
            mnt = self.sc.max_new_tokens
        return dataclasses.replace(sp, temperature=float(t),
                                   max_new_tokens=int(mnt))

    # --- per-lane sampling plumbing -----------------------------------
    @staticmethod
    def _lanes_for(state: SlotState, idx: int) -> tuple:
        """Single-row lane arrays for a prefill/chunk sampling this
        request's token number ``idx``."""
        sp = state.sampling
        return ([sp.temperature], [sp.top_p], [sp.top_k], [state.seed],
                [idx])

    def _decode_lanes(self) -> tuple:
        """(B,) lane arrays for the lockstep decode step; retired /
        mid-prefill lanes ride greedy (their draw is never read)."""
        idxs = np.zeros((self.sc.decode_batch,), np.int32)
        for s, st in self.sched.table.active.items():
            idxs[s] = len(st.tokens)
        return (self._lane_temp, self._lane_top_p, self._lane_top_k,
                self._lane_seed, idxs)

    def _set_lane(self, slot: int, state: SlotState) -> None:
        sp = state.sampling
        self._lane_temp[slot] = sp.temperature
        self._lane_top_p[slot] = sp.top_p
        self._lane_top_k[slot] = sp.top_k
        self._lane_seed[slot] = state.seed
        self._lane_lp[slot] = sp.logprobs is not None
        self._want_lp = bool(self._lane_lp.any())

    def _clear_lane(self, slot: int) -> None:
        self._lane_temp[slot] = 0.0
        self._lane_top_p[slot] = 1.0
        self._lane_top_k[slot] = 0
        self._lane_seed[slot] = 0
        self._lane_lp[slot] = False
        self._want_lp = bool(self._lane_lp.any())

    @staticmethod
    def _sample(logits: torch.Tensor, lanes: tuple, want_lp: bool) -> tuple:
        """(B, S, V) logits → ((B, 1) tokens of the last position, the
        logprob tensors or None), on device."""
        lg = logits[:, -1].float()
        tok = sample_tokens(lg, *lanes)
        return tok[:, None], (_logprobs(lg, tok) if want_lp else None)

    @staticmethod
    def _lp_entry(state: SlotState, chosen: float, top_lp: Sequence[float],
                  top_ids: Sequence[int]) -> Optional[Dict]:
        """One request-facing logprob record from host values: the
        sampled token's logprob plus the top-n alternatives the request
        asked for (computed at ``TOP_LOGPROBS``, trimmed here)."""
        n = state.sampling.logprobs
        if n is None:
            return None
        top = [(int(i), float(v)) for i, v in zip(top_ids[:n], top_lp[:n])]
        return {"logprob": float(chosen), "top_logprobs": top}

    def _record(self, slot: int, token: int, info=None) -> bool:
        """record_token + the streaming on_token fanout."""
        state = self.sched.table.active[slot]
        done = self.sched.record_token(slot, token)
        if self.on_token is not None:
            self.on_token(state.uid, int(token), info)
        return done

    @staticmethod
    def _read_first(tok: torch.Tensor, lpd) -> tuple:
        """A prefill's sampled token (and logprob rows) on the host: the
        admission must read it to schedule the lane."""
        with named_scope("first_token"):
            first = tok[0, 0].item()
            lp_host = [t[0].tolist() for t in lpd] if lpd is not None \
                else None
        return first, lp_host

    def _first_token(self, slot: int, state: SlotState, first: int,
                     lp_host) -> List[Result]:
        """Record a request's first token (its prefill's sample) and
        retire it if that already finishes it."""
        self._tok[slot, 0] = first
        info = self._lp_entry(state, *lp_host) if lp_host else None
        done = self._record(slot, first, info)
        self.tel.request_first_token(state.uid)
        if done:
            return [self._finish(slot)]
        return []

    def _sync(self) -> None:
        """The ``trace_sync`` fence: device time stays in the phase that
        launched it instead of the next host transfer."""
        if self.tel.sync and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------
    def _validate(self, req: Request) -> None:
        plen = len(req.prompt)
        eff = plen + self._n_vis
        if plen < 1:
            raise ValueError(f"request {req.uid}: empty prompt")
        if req.params is not None:
            try:
                req.params.validate()
            except ValueError as e:
                raise ValueError(f"request {req.uid}: {e}") from None
        if self.sc.max_pages_per_request is not None \
                and eff >= self.sc.max_pages_per_request * self.page_size:
            raise ValueError(
                f"request {req.uid}: prompt length {plen} fills the "
                f"max_pages_per_request={self.sc.max_pages_per_request} page "
                f"quota ({self.page_size} slots/page) with no decode budget "
                f"left")
        # the messages are the JAX engine's: the HTTP frontend returns them
        # in its error envelopes
        if eff >= self.sc.max_len:
            raise ValueError(
                f"request {req.uid}: prompt length {plen}"
                + (f" (+{self._n_vis} vision tokens)" if self._n_vis else "")
                + f" leaves no decode budget within max_len="
                f"{self.sc.max_len} — raise ServeConfig.max_len or shorten "
                f"the prompt")
        if self.sc.scheduler == "continuous" and not self.sc.paged \
                and eff > self.prefill_len:
            # the paged engine has no such cap: chunked prefill feeds any
            # prompt < max_len through the one chunk width
            raise ValueError(f"request {req.uid}: prompt length {plen} "
                             f"exceeds the compiled prefill shape prefill_len="
                             f"{self.prefill_len} (ServeConfig(paged=True) "
                             f"lifts this via chunked prefill)")

    def _need_continuous(self, what: str) -> None:
        if self.sc.scheduler != "continuous":
            raise RuntimeError(f"{what} needs "
                               f"ServeConfig(scheduler='continuous')")

    def submit(self, req: Request) -> int:
        """Queue a request; it is admitted on the next step() with a free
        slot. Returns the request uid."""
        self._need_continuous("submit()/step()/drain()")
        self._validate(req)
        req.params = self._resolve(req)
        req.t_submit = req.t_submit or time.perf_counter()
        self.sched.submit(req)
        self.tel.request_queued(req.uid)
        return req.uid

    # ------------------------------------------------------------------
    # Paged admission: map pages (prefix hits + fresh allocations) into
    # the slot's block table; the prompt then prefills chunk by chunk
    # across engine steps, interleaved with decode.
    # ------------------------------------------------------------------
    def _admit_paged(self, budget: StepBudget) -> Optional[List[Result]]:
        if not self.sched.queue or self.sched.table.n_free == 0:
            return None
        # the admission's first chunk runs this step (prepaid below);
        # cheap gate before touching the prefix tree — the exact cost
        # (is the first chunk final?) is re-checked after matching
        if not budget.can(self._chunk_len):
            self.sched.stats.budget_deferred_admissions += 1
            return None
        req, state = self.sched.next_admission()
        eff = state.prompt_len
        state.budget = min(state.budget, self.sc.max_len - eff)
        ps, nb = self.page_size, self.slots.n_blocks
        if self.sc.max_pages_per_request is not None:
            # page quota: prompt + generation never map more pages than
            # the quota (prompt-only overflow was rejected at submit)
            state.budget = min(state.budget,
                               self.sc.max_pages_per_request * ps - eff)
        matched: List[int] = []
        if self.prefix is not None:
            # cap: at least one prompt token is recomputed — the final
            # chunk's logits give the first token
            matched = self.prefix.match(req.prompt,
                                        max_blocks=(eff - 1) // ps)
        m_tok = len(matched) * ps
        # exact budget cost: one chunk at its padded width, +1 decode lane
        # if that chunk already completes the prompt
        cost = self._chunk_len + (1 if eff - m_tok <= self._chunk_len else 0)
        need = -(-(eff + max(state.budget, 0)) // ps) - len(matched)
        fresh = self.pool.alloc(need) if budget.can(cost) else None
        if fresh is None:
            # pool pressure (or the exact cost no longer fits): roll the
            # match back (refs and counters), put the request back at the
            # queue head, retry when a retirement frees pages / budget
            if self.prefix is not None:
                self.prefix.release_match(matched, (eff - 1) // ps)
            self.sched.queue.appendleft(req)
            if not budget.can(cost):
                self.sched.stats.budget_deferred_admissions += 1
            return None
        state.seed = lane_seed(state.sampling.seed, self._base_seed, req.uid)
        budget.take(cost)
        slot = self.sched.admit(state)
        self._set_lane(slot, state)
        self.tel.request_admitted(req.uid)
        row = matched + fresh
        self._row_pages[slot] = row
        self.slots.set_row(slot, row + [self._parked[slot]] * (nb - len(row)),
                           m_tok)
        self._prefill_jobs[slot] = _PrefillJob(req=req, state=state,
                                               next=m_tok,
                                               matched_tokens=m_tok,
                                               prepaid=True)
        self._prompt_tokens_total += eff
        self._prefix_hit_tokens += m_tok
        return []

    def _advance_prefill(self, slot: int) -> List[Result]:
        """Run one prefill chunk for a mid-admission slot; on the final
        chunk, sample the first token and (maybe) retire."""
        job = self._prefill_jobs[slot]
        eff = job.state.prompt_len
        c = self._chunk_len
        start = job.next
        length = min(c, eff - start)
        tokens = torch.zeros((1, c), dtype=torch.int64)
        tokens[0, :length] = torch.from_numpy(np.ascontiguousarray(
            job.req.prompt[start:start + length], dtype=np.int64))
        final = start + length >= eff
        t0 = time.perf_counter()
        with self.tel.entry("prefill_chunk", (1, c)):
            logits, self.slots.cache = prefill_chunk(
                self.ctx, self.model, tokens.to(self.device),
                self.slots.cache, slot, start, length)
            if final:
                first, lp_host = self._read_first(*self._sample(
                    logits, self._lanes_for(job.state, 0),
                    job.state.sampling.logprobs is not None))
            else:
                self._sync()
        t1 = time.perf_counter()
        job.state.t_prefill += t1 - t0
        self.tel.request_prefill(job.req.uid, start // c, t0, t1)
        job.next = start + length
        self._prefill_chunks += 1
        self._prefill_tokens_computed += length
        if not final:
            return []
        del self._prefill_jobs[slot]
        if self.prefix is not None:
            # register the prompt's *full* blocks (a partial tail block
            # also holds this request's decode tokens — unshareable)
            self.prefix.insert(job.req.prompt,
                               self._row_pages[slot][:eff // self.page_size])
        if job.state.budget <= 0:
            # max_new_tokens=0: the first token is dropped, as unpaged
            job.state.finish_reason = "length"
            return [self._finish(slot)]
        return self._first_token(slot, job.state, first, lp_host)

    def _admit_one(self, budget: StepBudget) -> Optional[List[Result]]:
        """Admit the next queued request into a free slot (if any):
        unpaged, prefill it at once."""
        if self.sc.paged:
            return self._admit_paged(budget)
        if not self.sched.queue or self.sched.table.n_free == 0:
            return None
        # one prefill dispatch at its padded width + the decode lane the
        # new slot occupies this very step
        if not budget.try_take(self.prefill_len + 1):
            self.sched.stats.budget_deferred_admissions += 1
            return None
        req, state = self.sched.next_admission()
        state.seed = lane_seed(state.sampling.seed, self._base_seed, req.uid)
        self.tel.request_admitted(req.uid)
        eff = state.prompt_len + self._n_vis
        state.budget = min(state.budget, self.sc.max_len - eff)
        prompts = torch.zeros((1, self.prefill_len - self._n_vis),
                              dtype=torch.int64)
        prompts[0, :state.prompt_len] = torch.from_numpy(
            np.ascontiguousarray(req.prompt, dtype=np.int64))
        lengths = torch.tensor([eff], dtype=torch.int32, device=self.device)
        t0 = time.perf_counter()
        with self.tel.entry("prefill", tuple(prompts.shape)):
            logits, pf_cache = prefill(self.ctx, self.model,
                                       prompts.to(self.device),
                                       self.slots.prefill_cache,
                                       lengths=lengths,
                                       frames=self._frames_for(1),
                                       vision=self._vision_for(1))
            first, lp_host = self._read_first(*self._sample(
                logits, self._lanes_for(state, 0),
                state.sampling.logprobs is not None))
        t1 = time.perf_counter()
        self.tel.request_prefill(req.uid, 0, t0, t1)
        slot = self.sched.admit(state)
        self._set_lane(slot, state)
        state.t_prefill = t1 - t0
        if state.budget <= 0:
            # max_new_tokens=0: the prefill token is dropped and the slot
            # frees on the same step
            state.finish_reason = "length"
            return [self._finish(slot)]
        self.slots.admit(pf_cache, slot)
        return self._first_token(slot, state, first, lp_host)

    def _frames_for(self, b: int) -> Optional[torch.Tensor]:
        """The first ``b`` rows of ``extra_inputs["frames"]`` (JAX's
        ``frames[:b]``; an admission's b is 1), or None: zeros, which
        ``prefill`` makes."""
        return None if self._frames is None else self._frames[:b]

    def _vision_for(self, b: int) -> Optional[torch.Tensor]:
        """A VLM's prefix for ``b`` rows: the first ``b`` rows of
        ``extra_inputs["vision"]`` or zeros, as JAX's ``_batch_for``
        gives them; None for any other model."""
        if not self._n_vis:
            return None
        if self._vision is not None:
            return self._vision[:b]
        return torch.zeros((b, self._n_vis,
                            self.cfg.d_frontend or self.cfg.d_model),
                           device=self.device)

    def _finish(self, slot: int) -> Result:
        state = self.sched.retire(slot)
        self._clear_lane(slot)
        if self.sc.paged:
            # release the slot's pages (tree-registered prompt blocks go
            # cold; private blocks free) and park the row so the lockstep
            # decode write stays harmless
            self.pool.decref(self._row_pages.pop(slot, []))
            self.slots.set_row(slot, [self._parked[slot]] * self.slots.n_blocks,
                               0)
        now = time.perf_counter()
        ft = state.t_first_token or None
        decode_s = now - ft if ft else None
        ttft_s = ft - state.t_submit if ft and state.t_submit else None
        latency_s = now - state.t_submit if state.t_submit else None
        self.tel.request_retired(state.uid, len(state.tokens), ttft_s,
                                 latency_s, decode_s)
        return Result(
            uid=state.uid,
            tokens=np.fromiter(state.tokens, dtype=np.int32,
                               count=len(state.tokens)),
            prefill_s=state.t_prefill or None, decode_s=decode_s,
            ttft_s=ttft_s, latency_s=latency_s,
            finish_reason=state.finish_reason)

    def abort(self, uid: int) -> Optional[Result]:
        """Cancel a request anywhere in its lifecycle and free its
        resources at once. Queued: removed before admission.
        Mid-chunked-prefill: the job is dropped and the slot's pages
        decref'd — prefix-matched pages lose the reference the match
        took, fresh pages free — so a cancel before the first token leaks
        no refcount. Decoding: the slot retires with the tokens generated
        so far. Returns the (partial) :class:`Result` with
        ``finish_reason="abort"``, or ``None`` for an unknown uid (already
        finished or never submitted)."""
        self._need_continuous("abort()")
        for i, req in enumerate(self.sched.queue):
            if req.uid == uid:
                del self.sched.queue[i]
                self.sched.stats.aborted += 1
                self.tel.request_retired(uid, 0, None, None, None)
                return Result(uid=uid, tokens=np.zeros((0,), np.int32),
                              finish_reason="abort")
        for slot, state in list(self.sched.table.active.items()):
            if state.uid == uid:
                # a mid-prefill cancel: the job dies here; _finish
                # releases the mapped pages and re-parks the row
                self._prefill_jobs.pop(slot, None)
                self.sched.stats.aborted += 1
                state.finish_reason = "abort"
                return self._finish(slot)
        return None

    def step(self) -> List[Result]:
        """Open this step's token budget, admit queued requests while
        budget and slots allow, advance in-flight chunked prefills
        (paged; oldest admission first, each chunk charged against the
        budget), then run one decode step — or, under ``speculative``,
        one speculative round — over the decoding slots. Returns the
        requests finished now."""
        self._need_continuous("step()")
        tel = self.tel
        tel.step_begin()
        finished: List[Result] = []
        paged = self.sc.paged
        with tel.phase("budget"):
            # charge the lanes already decoding (active minus mid-
            # prefill): they run regardless
            budget = self.sched.begin_step(self.sched.table.n_active
                                           - len(self._prefill_jobs))
            if paged and self.sc.free_watermark > 0.0:
                self.pool.ensure_free(
                    int(self.sc.free_watermark * self.pool.n_pages))
        with tel.phase("admission"):
            while True:
                done = self._admit_one(budget)
                if done is None:
                    break
                finished.extend(done)
        if paged:
            # one chunk per prefilling slot per step, oldest admission
            # first, each charged at its padded width (+1 when the final
            # chunk promotes the slot to decode this step); jobs the
            # budget cannot cover resume on a later step
            with tel.phase("prefill"):
                jobs = sorted(self._prefill_jobs.items(),
                              key=lambda kv: kv[1].state.t_admit)
                for slot, job in jobs:
                    if job.prepaid:
                        job.prepaid = False
                    else:
                        left = job.state.prompt_len - job.next
                        cost = self._chunk_len + (
                            1 if left <= self._chunk_len else 0)
                        if not budget.try_take(cost):
                            self.sched.stats.budget_capped_chunks += 1
                            continue
                    finished.extend(self._advance_prefill(slot))
        decoding = [s for s in self.sched.table.active_slots()
                    if s not in self._prefill_jobs]
        if not decoding:
            tel.step_end(0)
            self._sanitize()
            return finished
        k_round = (self._spec_k_for(decoding, budget)
                   if self.sc.speculative else 0)
        if k_round:
            finished.extend(self._spec_round(decoding, k_round))
            self.sched.note_decode_step(len(decoding))
            tel.step_end(len(decoding))
            self._sanitize()
            return finished
        # drift monitor: the reference pass runs over the pre-step cache
        # and leaves it as it found it, before the serving pass writes
        ref = self._drift_reference() if self._drift_due() else None
        with tel.phase("decode"), tel.entry("decode", tuple(self._tok.shape)):
            logits, self.slots.cache = decode_step(self.ctx, self.model,
                                                   self._tok, self.slots.cache)
            self._tok, lpd = self._sample(logits, self._decode_lanes(),
                                          self._want_lp)
            self._sync()
        self.sched.note_decode_step(len(decoding))
        with tel.phase("transfer"):
            toks = self._tok[:, 0].tolist()
            lp_host = [t.tolist() for t in lpd] if lpd is not None else None
        self._host_guard(toks, decoding)
        if ref is not None:
            self._observe_drift(logits[:, -1].float(), ref, decoding)
        active = self.sched.table.active
        for slot in decoding:
            info = None
            if lp_host is not None:
                info = self._lp_entry(active[slot], lp_host[0][slot],
                                      lp_host[1][slot], lp_host[2][slot])
            if self._record(slot, toks[slot], info):
                finished.append(self._finish(slot))
        tel.step_end(len(decoding))
        self._sanitize()
        return finished

    def _sanitize(self) -> None:
        """Post-step invariant audit (``ServeConfig(sanitize=True)``):
        raises :class:`~repro_torch.serve.sanitizer.SanitizerError` when
        the host bookkeeping and the device state disagree. Read-only."""
        if self._san is not None:
            self._san.check(self)

    # ------------------------------------------------------------------
    # Accuracy-drift monitor (ServeConfig(drift_monitor=True))
    # ------------------------------------------------------------------
    def _drift_due(self) -> bool:
        """Deterministic sampling cadence over plain decode steps: the
        decision depends only on the step counter, never on tokens."""
        if not self._drift_every:
            return False
        due = self._drift_step % self._drift_every == 0
        self._drift_step += 1
        return due

    def _drift_reference(self) -> torch.Tensor:
        """(B, V) f32 logits of this step's decode under the reference
        lowering (``drift_ref_fused``), over the pre-step cache. The port's
        decode writes the cache in place, so every tensor the pass writes
        is copied first and put back after it, bit for bit: the serving
        pass that follows finds the cache as it would without the
        monitor."""
        saved = [save_step_writes(layer, blk.kind == "local")
                 for layer, blk in zip(self.slots.cache, self.model.blocks)]
        logits, _ = decode_step(self._rctx, self.model, self._tok,
                                self.slots.cache)
        for layer, sv in zip(self.slots.cache, saved):
            restore_step_writes(layer, sv)
        return logits[:, -1].float()

    def _observe_drift(self, s: torch.Tensor, r: torch.Tensor,
                       decoding: List[int]) -> None:
        """Fold this step's per-lane divergence of the serving logits
        ``s`` from the reference ``r`` into the registry: KL(serving ‖
        reference), argmax agreement, max |Δlogit| and the non-finite
        element count."""
        logp_s = torch.log_softmax(s, dim=-1)
        logp_r = torch.log_softmax(r, dim=-1)
        kl = torch.sum(torch.exp(logp_s) * (logp_s - logp_r), dim=-1)
        agree = torch.argmax(s, dim=-1) == torch.argmax(r, dim=-1)
        delta = torch.amax(torch.abs(s - r), dim=-1)
        bad = (torch.sum(~torch.isfinite(s), dim=-1)
               + torch.sum(~torch.isfinite(r), dim=-1))
        with named_scope("drift_probe"):
            # the probe's sync is the sampled monitoring cost, not part of
            # the serving step's transfer
            kl, agree, delta, bad = torch.stack(
                [kl, agree.float(), delta, bad.float()]).tolist()
        for slot in decoding:
            self._drift_checks += 1
            self._drift_agree += int(agree[slot])
            self._drift_nonfinite += int(bad[slot])
            if math.isfinite(kl[slot]):
                # a tiny negative KL is f32 round-off: clamp it into the
                # histogram's domain
                self._h_drift_kl.observe(max(kl[slot], 0.0))
            if math.isfinite(delta[slot]):
                self._h_drift_delta.observe(delta[slot])

    def _host_guard(self, toks: List[int], decoding: List[int]) -> None:
        """Sanity count over the tokens just sampled: a token outside
        [0, vocab) means the logits went bad upstream. Host arithmetic
        on the transferred tokens."""
        self._guard_oob += sum(1 for s in decoding
                               if not 0 <= toks[s] < self.cfg.vocab)

    # ------------------------------------------------------------------
    # Self-speculative decoding: Q-only draft, full Q+LR verify
    # ------------------------------------------------------------------
    def _spec_k_for(self, decoding: List[int], budget: StepBudget) -> int:
        """The speculative round's window width k (0 = run plain decode
        this step). Needs every decoding lane greedy (sampled lanes decode
        per token, whose counter-based draws are per-token by
        construction), no pending post-rejection correction
        (``_need_plain``), budget for the up-to-(k-1) emitted drafts of
        every lane, and step-budget room for the extra passes: (k-1)
        draft steps over n lanes plus n verify chunks of width k, beyond
        the decode step already charged at begin_step."""
        if self._need_plain:
            self._need_plain = False
            return 0
        active = self.sched.table.active
        k = self.sc.spec_k
        for s in decoding:
            st = active[s]
            if st.sampling.temperature > 0.0:
                return 0
            # a round emits at most k-1 tokens for this lane
            k = min(k, st.budget - len(st.tokens) + 1)
        if k < 2:
            return 0
        n = len(decoding)
        if not budget.try_take((k - 1) * n + k * n):
            return 0
        return k

    def _verify_lane(self, state: SlotState) -> tuple:
        """Lane arrays for one verify chunk: the request's sampling
        controls at every chunk position, position j sampling with
        counter key ``len(tokens) + j``."""
        sp, kk, idx0 = state.sampling, self.sc.spec_k, len(state.tokens)
        return ([sp.temperature] * kk, [sp.top_p] * kk, [sp.top_k] * kk,
                [state.seed] * kk, list(range(idx0, idx0 + kk)))

    def _rewind(self, mask: np.ndarray, newpos: np.ndarray) -> None:
        """Set every layer's ``pos[mask] = newpos[mask]`` on the device:
        the verified rows restart after their emitted tokens; the rows
        left out (finished this round, or not decoding) keep theirs."""
        packed = self._to_device(torch.from_numpy(
            np.stack([mask.astype(np.int32), newpos.astype(np.int32)])))
        m, p = packed[0].bool(), packed[1]
        for layer in self.slots.cache:
            layer["pos"] = torch.where(m, p, layer["pos"])

    def _spec_round(self, decoding: List[int], k: int) -> List[Result]:
        """One self-speculative round over the (all-greedy) decoding
        lanes: k-1 Q-only draft steps through the lockstep decode step,
        then one full-model verify chunk per lane re-scores [last token ‖
        drafts], and the longest draft prefix matching the verify
        model's predictions is accepted. Only those accepted drafts are
        emitted; the verify model's own next token (the correction or
        bonus token) is not taken from the chunk: a chunk reduces in
        another order than the decode step, so its argmax can flip on a
        near tie. Instead a round in which any lane rejected marks the
        engine for one plain decode step (``_need_plain``), whose token is
        the correction; a fully accepting lane lets the next round's
        verify position 0 re-score its would-be bonus token. Positions
        rewind to p + n_emitted; a rejected tail's K/V lies in pages (or
        slots) the request already owns, masked by ``pos`` until
        overwritten, so no page is allocated or released in a round.

        The draft tokens never visit the host before the verify: each
        lane's chunk [last token ‖ drafts] is cut from the device tensors,
        and one transfer at the end brings drafts, verify targets and
        logprobs back together."""
        sc = self.sc
        active = self.sched.table.active
        states = {s: active[s] for s in decoding}
        # next-write slot per lane: pos = prompt (+ vision) + generated - 1
        p0 = {s: states[s].prompt_len + self._n_vis
              + len(states[s].tokens) - 1 for s in decoding}
        lanes = self._decode_lanes()
        tel = self.tel
        with tel.phase("decode"), \
                tel.entry("draft", (k - 1,) + tuple(self._tok.shape)):
            tok, drafts = self._tok, []
            for _ in range(k - 1):
                logits, self.slots.cache = decode_step(
                    self._dctx, self.model, tok, self.slots.cache)
                tok, _ = self._sample(logits, lanes, False)
                drafts.append(tok)
            fed_all = torch.cat([self._tok] + drafts, dim=1)   # (B, k)
            if k < sc.spec_k:
                fed_all = torch.nn.functional.pad(fed_all,
                                                  (0, sc.spec_k - k))
            self._sync()
        verify = {}
        with tel.phase("verify"):
            for s in decoding:
                st = states[s]
                with tel.entry("verify", (1, sc.spec_k)):
                    logits, self.slots.cache = verify_chunk(
                        self.ctx, self.model, fed_all[s:s + 1],
                        self.slots.cache, s, p0[s], k, store=self._spec_store)
                    lg = logits[0].float()
                    tv = sample_tokens(lg, *self._verify_lane(st))
                    verify[s] = (tv, _logprobs(lg, tv)
                                 if st.sampling.logprobs is not None
                                 else None)
        with tel.phase("transfer"):
            fed_host = fed_all.tolist()
            hosted = {s: (tv.tolist(),
                          [t.tolist() for t in lpd] if lpd is not None
                          else None)
                      for s, (tv, lpd) in verify.items()}
        b = sc.decode_batch
        tok_host = [row[0] for row in fed_host]
        mask = np.zeros((b,), bool)
        newpos = np.zeros((b,), np.int32)
        results: List[Result] = []
        n_accepted = 0
        for s in decoding:
            st = states[s]
            tgt, lp_host = hosted[s]
            draft = fed_host[s][1:k]
            # draft j survives while it matches the verify model's
            # prediction at the same position (the greedy rule); an
            # accepted draft IS the verify token, so emitting tgt[j]
            # emits the draft with the chunk's logprob row
            n_acc = 1
            while n_acc < k and draft[n_acc - 1] == tgt[n_acc - 1]:
                n_acc += 1
            n_accepted += n_acc - 1
            self._h_accept.observe(n_acc - 1)
            if n_acc < k:
                # a rejected draft would be proposed again next round
                # (drafting is deterministic): the correction must come
                # from a plain decode step
                self._need_plain = True
            rec, done = 0, False
            for j in range(n_acc - 1):
                info = None
                if lp_host is not None:
                    info = self._lp_entry(st, lp_host[0][j], lp_host[1][j],
                                          lp_host[2][j])
                rec += 1
                # a stop token inside the accepted window truncates here,
                # as plain decode would retire
                if self._record(s, tgt[j], info):
                    done = True
                    break
            if rec:
                tok_host[s] = tgt[rec - 1]
            if done:
                # _finish re-parks the row at pos 0: keep the lane out of
                # the rewind so that sticks
                results.append(self._finish(s))
            else:
                mask[s] = True
                newpos[s] = p0[s] + rec
        with tel.phase("verify"):
            self._tok = self._to_device(
                torch.tensor(tok_host, dtype=torch.int64)[:, None])
            self._rewind(mask, newpos)
        self._spec_rounds += 1
        self._spec_draft_tokens += (k - 1) * len(decoding)
        self._spec_accepted_tokens += n_accepted
        return results

    def drain(self) -> List[Result]:
        """Run step() until queue and slots are empty; results by uid."""
        self._need_continuous("drain()")
        results: List[Result] = []
        while self.sched.has_work:
            results.extend(self.step())
        results.sort(key=lambda r: r.uid)
        return results

    # ==================================================================
    # Bucketed baseline
    # ==================================================================
    def _bucket_lanes(self, reqs: List[Request], seeds: List[int],
                      idx: int) -> tuple:
        """(B,) lane arrays for one bucket step at token ``idx`` — the
        continuous engine's counter-based streams, so the two schedulers
        agree token for token per request. Padding lanes ride greedy."""
        b = self.sc.decode_batch
        temps = np.zeros((b,), np.float32)
        top_ps = np.ones((b,), np.float32)
        top_ks = np.zeros((b,), np.int32)
        sds = np.zeros((b,), np.int32)
        for i, r in enumerate(reqs):
            temps[i] = r.params.temperature
            top_ps[i] = r.params.top_p
            top_ks[i] = r.params.top_k
            sds[i] = seeds[i]
        return temps, top_ps, top_ks, sds, np.full((b,), idx, np.int32)

    def _run_bucket(self, reqs: List[Request],
                    base_seed: int) -> List[Result]:
        sc = self.sc
        b = sc.decode_batch
        plen = len(reqs[0].prompt)
        prompts = torch.zeros((b, plen), dtype=torch.int64)
        stops: List[frozenset] = []
        seeds: List[int] = []
        for i, r in enumerate(reqs):
            prompts[i] = torch.from_numpy(np.ascontiguousarray(
                r.prompt, dtype=np.int64))
            st = frozenset(r.params.stop)
            if sc.eos_id >= 0:
                st = st | {sc.eos_id}
            stops.append(st)
            seeds.append(lane_seed(r.params.seed, base_seed, r.uid))

        t0 = time.perf_counter()
        cache = init_cache(self.cfg, b, sc.max_len, KV_DTYPES[sc.kv_dtype],
                           self.device)
        # the first token takes the decode steps' per-lane sampling path
        # (token index 0, as the continuous engine's prefill)
        logits, cache = prefill(self.ctx, self.model, prompts.to(self.device),
                                cache, frames=self._frames_for(b),
                                vision=self._vision_for(b))
        tok, _ = self._sample(logits, self._bucket_lanes(reqs, seeds, 0),
                              False)
        budget = min(max(self._req_budget(r) for r in reqs),
                     sc.max_len - plen - self._n_vis)
        out = np.zeros((b, budget), np.int32)
        done = np.zeros((b,), bool)
        n = 0
        t1 = None
        for step in range(budget):
            out[:, step] = tok[:, 0].tolist()
            t1 = t1 or time.perf_counter()
            for i in range(len(reqs)):
                done[i] |= int(out[i, step]) in stops[i]
            n = step + 1
            if done[:len(reqs)].all():
                break
            # a lane is useful only while its request still needs tokens:
            # padding rows and early-stop rows ride along wasted
            self._bucket_stats.decode_steps += 1
            self._bucket_stats.decode_slot_steps += sum(
                1 for i, r in enumerate(reqs)
                if not done[i] and step < self._req_budget(r))
            # token index step+1: out[:, step] was token `step`
            logits, cache = decode_step(self.ctx, self.model, tok, cache)
            tok, _ = self._sample(
                logits, self._bucket_lanes(reqs, seeds, step + 1), False)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t2 = time.perf_counter()
        t1 = t1 or t2

        results = []
        self._bucket_stats.admitted += len(reqs)
        self._bucket_stats.retired += len(reqs)
        for i, r in enumerate(reqs):
            toks = out[i, :n]
            # stop truncation first (a stop wins over the budget on the
            # same token, as in the continuous engine), then the budget
            cut = next((j for j in range(len(toks))
                        if int(toks[j]) in stops[i]), None)
            if cut is not None:
                toks = toks[:cut + 1]
            lim = min(self._req_budget(r),
                      sc.max_len - plen - self._n_vis)
            toks = toks[:lim]
            stopped = cut is not None and cut < lim
            if stopped and sc.eos_id >= 0 and toks[-1] == sc.eos_id:
                self._bucket_stats.eos_retired += 1
            since = r.t_submit or t0     # queue wait counts toward latency
            results.append(Result(uid=r.uid, tokens=toks, prefill_s=t1 - t0,
                                  decode_s=t2 - t1, ttft_s=t1 - since,
                                  latency_s=t2 - since,
                                  finish_reason="stop" if stopped
                                  else "length"))
        return results

    def _generate_bucketed(self, requests: Sequence[Request],
                           seed: int) -> List[Result]:
        buckets: Dict[int, List[Request]] = {}
        for r in requests:
            buckets.setdefault(len(r.prompt), []).append(r)
        results: List[Result] = []
        for plen in sorted(buckets):
            queue = buckets[plen]
            for i in range(0, len(queue), self.sc.decode_batch):
                results.extend(self._run_bucket(
                    queue[i:i + self.sc.decode_batch], seed))
        results.sort(key=lambda r: r.uid)
        return results

    # ==================================================================
    def generate(self, requests: Sequence[Request],
                 seed: int = 0) -> List[Result]:
        """Run all requests through the configured scheduler as a fresh
        run: sampling streams re-seeded from ``seed``, stats and
        submission timestamps reset. The paged cache's prefix tree
        persists across calls, as in the JAX engine."""
        now = time.perf_counter()
        for r in requests:
            self._validate(r)
            r.params = self._resolve(r)
            r.t_submit = now
        self.reset_stats()
        if self.sc.scheduler == "bucketed":
            return self._generate_bucketed(requests, seed)
        self._base_seed = seed
        for r in requests:
            self.submit(r)
        out = self.drain()
        self.tel.stop_profiler()     # a short run may never reach
        # profile_steps; do not leave the capture open
        return out

    def warmup(self) -> None:
        """Serve one dummy request so that kernel builds and first
        launches (prefill, decode; draft and verify under speculative
        mode) leave the measured window; counters reset afterwards, so
        the dummy never shows in ``stats()``."""
        if self.sc.scheduler != "continuous":
            return
        # speculative: spec_k + 1 tokens cover one full-k round plus a
        # clamped one for the leftover token
        mnt = self.sc.spec_k + 1 if self.sc.speculative else 2
        self.submit(Request(uid=-1, prompt=np.zeros((1,), np.int32),
                            max_new_tokens=mnt))
        while self.sched.has_work:
            self.step()
        if self.sc.speculative:
            # each clamped k's draft span, and the plain decode a rejection
            # falls back to, on the idle lanes: their writes land in the
            # lanes' own (unpaged) rows or parked pages, which admission
            # resets
            lanes = self._decode_lanes()
            for kk in range(2, self.sc.spec_k + 1):
                tok = self._tok
                for _ in range(kk - 1):
                    logits, self.slots.cache = decode_step(
                        self._dctx, self.model, tok, self.slots.cache)
                    tok, _ = self._sample(logits, lanes, False)
            logits, self.slots.cache = decode_step(
                self.ctx, self.model, self._tok, self.slots.cache)
            self._sample(logits, lanes, False)
        self.reset_stats()

    def _collect(self) -> MetricsRegistry:
        """Publish every live component's series into the registry and
        return it: the one collection path behind ``stats()``,
        ``metrics()`` and ``prometheus()``. Both schedulers emit the same
        common keys; the paged engine adds the page-pool, prefix-cache
        and chunked-prefill series, an enabled recorder the latency and
        phase histograms and the per-entry dispatch accounting."""
        reg = self.registry
        s = (self._bucket_stats if self.sc.scheduler == "bucketed"
             else self.sched.stats)
        s.publish(reg)
        if self.sc.paged:
            self.pool.publish(reg)
            if self.prefix is not None:
                self.prefix.publish(reg)
            hit = self._prefix_hit_tokens
            total = self._prompt_tokens_total
            reg.counter("prefill_chunks", "chunked-prefill dispatches"
                        ).set(self._prefill_chunks)
            reg.counter("prefill_tokens_computed",
                        "prompt tokens actually prefilled"
                        ).set(self._prefill_tokens_computed)
            reg.counter("prompt_tokens_total", "prompt tokens submitted"
                        ).set(total)
            reg.counter("prefix_hit_tokens",
                        "prompt tokens served from the prefix cache"
                        ).set(hit)
            reg.gauge("prefix_hit_rate", "prefix_hit_tokens / "
                      "prompt_tokens_total"
                      ).set(round(hit / total, 4) if total else 0.0)
        # the speculative and drift series are part of the uniform key set
        # (zeros when the mode is off)
        reg.counter("spec_rounds", "self-speculative rounds executed"
                    ).set(self._spec_rounds)
        reg.counter("spec_draft_tokens", "Q-only draft tokens proposed"
                    ).set(self._spec_draft_tokens)
        reg.counter("spec_accepted_tokens",
                    "draft tokens accepted by the Q+LR verify"
                    ).set(self._spec_accepted_tokens)
        reg.gauge("spec_acceptance_rate",
                  "spec_accepted_tokens / spec_draft_tokens").set(
            round(self._spec_accepted_tokens / self._spec_draft_tokens, 4)
            if self._spec_draft_tokens else 0.0)
        reg.counter("drift_checks", "per-lane shadow comparisons executed"
                    ).set(self._drift_checks)
        reg.counter("drift_top1_agree",
                    "shadow comparisons whose argmax matched the "
                    "reference lowering").set(self._drift_agree)
        reg.counter("drift_nonfinite",
                    "non-finite logit elements seen by the drift probe"
                    ).set(self._drift_nonfinite)
        reg.counter("guard_token_oob",
                    "sampled tokens outside [0, vocab) — upstream "
                    "logit corruption").set(self._guard_oob)
        reg.gauge("drift_top1_agreement_rate",
                  "drift_top1_agree / drift_checks").set(
            round(self._drift_agree / self._drift_checks, 4)
            if self._drift_checks else 1.0)
        self.tel.publish()
        return reg

    def stats(self) -> Dict[str, float]:
        """One registry snapshot, key for key with the JAX engine's:
        ``admitted``/``retired``/``eos_retired``/``aborted``/
        ``decode_steps``/``occupancy`` and the budget counters in every
        mode, the speculative and drift series always (the
        ``spec_accept_per_round``, ``drift_kl`` and ``drift_logit_delta``
        histograms nested as summaries), the page-pool, prefix and chunk
        series under the paged cache, and under telemetry the
        ``step_<phase>_seconds`` and latency histograms and the per-entry
        dispatch accounting."""
        return self._collect().snapshot()

    # ``metrics()`` is the serving-convention alias
    metrics = stats

    def prometheus(self) -> str:
        """Prometheus text exposition of the same registry snapshot."""
        return self._collect().prometheus()

    def write_trace(self, path: str, jsonl_path: Optional[str] = None) -> str:
        """Export the Chrome trace-event JSON (Perfetto-loadable); with
        ``jsonl_path``, also the JSONL event stream. Needs
        ``ServeConfig(telemetry=True)``."""
        if not self.tel.enabled:
            raise RuntimeError("trace export needs ServeConfig("
                               "telemetry=True)")
        out = self.tel.tracer.write_chrome(path)
        if jsonl_path:
            self.tel.tracer.write_jsonl(jsonl_path)
        return out
