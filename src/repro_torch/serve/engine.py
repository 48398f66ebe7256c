"""Serving engine: continuous batching over a Q + LR model (port of the
continuous path of ``repro/serve/engine.py``).

A slot-based KV cache (``serve.slots``) gives every batch row its own
write position and slot map, so requests are admitted into free slots
mid-flight: prefill-on-admit copies a freshly prefilled row into the
live cache while the other slots keep decoding, and a request retires
the moment it reaches its ``max_new_tokens`` or its stop token. Prompts
are right-padded to one prefill width (``prefill_len``) and masked.

``ServeConfig(paged=True)`` serves from the paged cache instead
(``serve.pages``): a page pool shared by the lanes, one block table per
lane, radix-tree prefix reuse (``serve.prefix``: a prompt whose leading
blocks were prefilled before maps their pages and skips their compute),
and chunked prefill — a prompt of any length below ``max_len`` streams
in ``prefill_len``-wide chunks, one per engine step, interleaved with
the other lanes' decode. ``max_step_tokens`` arms the token-budget step
scheduler (``serve.scheduler.StepBudget``) under either cache.

``fused="auto"`` (the default) runs every quantized projection through
K1/K2 (an MoE model's int8 expert stacks through K6) and attention
through K3/K4 (paged: K5 for decode, K4 for each chunk) on a CUDA device, and through their plain versions on the CPU.
``fused="off"`` keeps the dequantize-then-matmul and dequantize-the-cache
baselines.

Decoding is greedy in this slice: a request asking for temperature > 0
raises, since per-request sampling (``serve/sampling.py``) is not ported
yet. API: ``submit()`` / ``step()`` / ``drain()`` for streaming use,
``generate()`` for a batch of requests.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels.constraints import validate_page_size
from repro_torch.models.linear import Ctx
from repro_torch.models.transformer import (LM, decode_step, prefill,
                                            prefill_chunk)
from repro_torch.serve.pages import PagedKVCache, PagePool
from repro_torch.serve.prefix import RadixPrefixCache
from repro_torch.serve.scheduler import (ContinuousScheduler, SchedulerStats,
                                         StepBudget)
from repro_torch.serve.slots import KV_DTYPES, SlotKVCache, SlotState

COMPUTE_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


@dataclasses.dataclass
class ServeConfig:
    max_len: int = 512               # cache slots (prompt + generation)
    decode_batch: int = 8            # decode lanes (= slots)
    max_new_tokens: int = 64
    eos_id: int = -1                 # -1: never stop early
    kv_dtype: str = "bf16"           # bf16 | f32 | int8 | int4
    temperature: float = 0.0         # 0 = greedy, the only mode ported
    compute_dtype: str = "f32"       # f32 | bf16
    prefill_len: Optional[int] = None  # prompt pad width (default
    # max_len); under paged=True the chunk width, no prompt-length cap
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


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray               # (L,) int32
    max_new_tokens: Optional[int] = None  # None → ServeConfig default
    t_submit: float = 0.0
    temperature: Optional[float] = None   # None → ServeConfig.temperature


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
    finish_reason: Optional[str] = None  # "stop" | "length"


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


class Phases:
    """Host wall time per engine phase. ``phase("transfer")`` fences the
    only places the step loop waits for the device: copying sampled
    tokens to the host."""

    def __init__(self):
        self.seconds: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds[name] = (self.seconds.get(name, 0.0)
                                  + time.perf_counter() - t0)


def _greedy(logits: torch.Tensor) -> torch.Tensor:
    """(B, S, V) logits → (B, 1) argmax of the last position, on device."""
    return logits[:, -1].float().argmax(dim=-1, keepdim=True)


class Engine:
    def __init__(self, model: LM, cfg: ModelConfig, sc: ServeConfig, *,
                 device="cuda"):
        self.device = resolve_device(device)
        if model.device.type != self.device.type:
            raise ValueError(f"model lives on {model.device}, the engine "
                             f"was asked to serve on {self.device}")
        if sc.fused not in ("auto", "on", "off"):
            raise ValueError(f"unknown fused mode {sc.fused!r}")
        if sc.kv_dtype not in KV_DTYPES:
            raise ValueError(f"unknown kv_dtype {sc.kv_dtype!r} "
                             f"(choose from {sorted(KV_DTYPES)})")
        if sc.compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"unknown compute_dtype {sc.compute_dtype!r}")
        self._check_temperature(sc.temperature)
        self.model, self.cfg, self.sc = model, cfg, sc
        self.ctx = Ctx(compute_dtype=COMPUTE_DTYPES[sc.compute_dtype],
                       fused=sc.fused)
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
        if sc.max_step_tokens is not None \
                and sc.max_step_tokens < self._chunk_len + 1:
            raise ValueError(
                f"max_step_tokens={sc.max_step_tokens} cannot cover one "
                f"prefill dispatch ({self._chunk_len} tokens) plus its first "
                f"decode lane: an idle engine could never admit anything")
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
        self._reset()

    @staticmethod
    def _check_temperature(t: float) -> None:
        if t > 0:
            raise NotImplementedError(
                "temperature > 0 needs per-request sampling "
                "(repro/serve/sampling.py), which the port has not ported "
                "yet; this slice decodes greedily")

    def _reset(self) -> None:
        sc = self.sc
        self.sched = ContinuousScheduler(sc.decode_batch, sc.eos_id,
                                         sc.max_new_tokens,
                                         max_step_tokens=sc.max_step_tokens)
        self._tok = torch.zeros((sc.decode_batch, 1), dtype=torch.int64,
                                device=self.device)
        self.tel = Phases()
        self.pool: Optional[PagePool] = None
        self.prefix: Optional[RadixPrefixCache] = None
        self._prefill_jobs: Dict[int, _PrefillJob] = {}
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

    def _reset_stats(self) -> None:
        """A fresh measurement window: counters and phase times, not the
        scheduler, the cache or the prefix tree."""
        self.sched.stats = SchedulerStats(n_slots=self.sc.decode_batch)
        self.tel = Phases()
        if self.sc.paged:
            self.pool.reset_stats()
            if self.prefix is not None:
                self.prefix.reset_stats()
            self._reset_paged_counters()

    # ------------------------------------------------------------------
    def _validate(self, req: Request) -> None:
        plen = len(req.prompt)
        if plen < 1:
            raise ValueError(f"request {req.uid}: empty prompt")
        if self.sc.max_pages_per_request is not None \
                and plen >= self.sc.max_pages_per_request * self.page_size:
            raise ValueError(
                f"request {req.uid}: prompt length {plen} fills the "
                f"max_pages_per_request={self.sc.max_pages_per_request} page "
                f"quota ({self.page_size} slots/page) with no decode budget "
                f"left")
        if plen >= self.sc.max_len:
            raise ValueError(f"request {req.uid}: prompt length {plen} "
                             f"leaves no decode budget within max_len="
                             f"{self.sc.max_len}")
        if not self.sc.paged and plen > self.prefill_len:
            # the paged engine has no such cap: chunked prefill feeds any
            # prompt < max_len through the one chunk width
            raise ValueError(f"request {req.uid}: prompt length {plen} "
                             f"exceeds prefill_len={self.prefill_len} "
                             f"(ServeConfig(paged=True) lifts this via "
                             f"chunked prefill)")
        self._check_temperature(req.temperature if req.temperature is not None
                                else self.sc.temperature)

    def submit(self, req: Request) -> int:
        """Queue a request; it is admitted on the next step() with a free
        slot. Returns the request uid."""
        self._validate(req)
        req.t_submit = req.t_submit or time.perf_counter()
        self.sched.submit(req)
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
        budget.take(cost)
        slot = self.sched.admit(state)
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
        chunk, take the first token and (maybe) retire."""
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
        logits, self.slots.cache = prefill_chunk(
            self.ctx, self.model, tokens.to(self.device), self.slots.cache,
            slot, start, length)
        if final:
            first_dev = _greedy(logits)
            with self.tel.phase("transfer"):
                first = int(first_dev[0, 0].item())
        job.state.t_prefill += time.perf_counter() - t0
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
        self._tok[slot, 0] = first
        if self.sched.record_token(slot, first):
            return [self._finish(slot)]
        return []

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
        state.budget = min(state.budget, self.sc.max_len - state.prompt_len)
        prompts = torch.zeros((1, self.prefill_len), dtype=torch.int64)
        prompts[0, :state.prompt_len] = torch.from_numpy(
            np.ascontiguousarray(req.prompt, dtype=np.int64))
        lengths = torch.tensor([state.prompt_len], dtype=torch.int32,
                               device=self.device)
        t0 = time.perf_counter()
        with self.tel.phase("prefill"):
            logits, pf_cache = prefill(self.ctx, self.model,
                                       prompts.to(self.device),
                                       self.slots.prefill_cache,
                                       lengths=lengths)
            first_dev = _greedy(logits)
        with self.tel.phase("transfer"):
            first = int(first_dev[0, 0].item())
        t1 = time.perf_counter()
        slot = self.sched.admit(state)
        state.t_prefill = t1 - t0
        if state.budget <= 0:
            # max_new_tokens=0: the prefill token is dropped and the slot
            # frees on the same step
            state.finish_reason = "length"
            return [self._finish(slot)]
        self.slots.admit(pf_cache, slot)
        self._tok[slot, 0] = first
        if self.sched.record_token(slot, first):
            return [self._finish(slot)]
        return []

    def _finish(self, slot: int) -> Result:
        state = self.sched.retire(slot)
        if self.sc.paged:
            # release the slot's pages (tree-registered prompt blocks go
            # cold; private blocks free) and park the row so the lockstep
            # decode write stays harmless
            self.pool.decref(self._row_pages.pop(slot, []))
            self.slots.set_row(slot, [self._parked[slot]] * self.slots.n_blocks,
                               0)
        now = time.perf_counter()
        ft = state.t_first_token or None
        return Result(
            uid=state.uid,
            tokens=np.fromiter(state.tokens, dtype=np.int32,
                               count=len(state.tokens)),
            prefill_s=state.t_prefill or None,
            decode_s=now - ft if ft else None,
            ttft_s=ft - state.t_submit if ft and state.t_submit else None,
            latency_s=now - state.t_submit if state.t_submit else None,
            finish_reason=state.finish_reason)

    def step(self) -> List[Result]:
        """Open this step's token budget, admit queued requests while
        budget and slots allow, advance in-flight chunked prefills
        (paged; oldest admission first, each chunk charged against the
        budget), then run one decode step over the decoding slots.
        Returns the requests finished now."""
        finished: List[Result] = []
        paged = self.sc.paged
        with self.tel.phase("budget"):
            # charge the lanes already decoding (active minus mid-
            # prefill): they run regardless
            budget = self.sched.begin_step(self.sched.table.n_active
                                           - len(self._prefill_jobs))
            if paged and self.sc.free_watermark > 0.0:
                self.pool.ensure_free(
                    int(self.sc.free_watermark * self.pool.n_pages))
        with self.tel.phase("admission"):
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
            with self.tel.phase("prefill"):
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
            return finished
        with self.tel.phase("decode"):
            logits, self.slots.cache = decode_step(self.ctx, self.model,
                                                   self._tok, self.slots.cache)
            self._tok = _greedy(logits)
        self.sched.note_decode_step(len(decoding))
        with self.tel.phase("transfer"):
            toks = self._tok[:, 0].tolist()
        for slot in decoding:
            if self.sched.record_token(slot, toks[slot]):
                finished.append(self._finish(slot))
        return finished

    def drain(self) -> List[Result]:
        """Run step() until queue and slots are empty; results by uid."""
        results: List[Result] = []
        while self.sched.has_work:
            results.extend(self.step())
        results.sort(key=lambda r: r.uid)
        return results

    def generate(self, requests: Sequence[Request]) -> List[Result]:
        """Run all requests through the scheduler as a fresh measurement
        window: stats and submission timestamps reset. The paged cache's
        prefix tree persists across calls, as in the JAX engine."""
        for r in requests:
            self._validate(r)
        self._reset_stats()
        now = time.perf_counter()
        for r in requests:
            r.t_submit = now
            self.submit(r)
        return self.drain()

    def stats(self) -> Dict[str, float]:
        """Scheduler counters and host phase seconds; under the paged
        cache also the chunked-prefill, prefix-cache and page-pool
        counters, under the JAX engine's names."""
        s = self.sched.stats
        out = {"admitted": s.admitted, "retired": s.retired,
               "eos_retired": s.eos_retired, "decode_steps": s.decode_steps,
               "decode_slot_steps": s.decode_slot_steps,
               "occupancy": round(s.occupancy, 4),
               "budget_deferred_admissions": s.budget_deferred_admissions,
               "budget_capped_chunks": s.budget_capped_chunks}
        if self.sc.paged:
            hit, total = self._prefix_hit_tokens, self._prompt_tokens_total
            out.update(self.pool.stats())
            if self.prefix is not None:
                out.update(self.prefix.stats())
            out.update(prefill_chunks=self._prefill_chunks,
                       prefill_tokens_computed=self._prefill_tokens_computed,
                       prompt_tokens_total=total, prefix_hit_tokens=hit,
                       prefix_hit_rate=round(hit / total, 4) if total else 0.0)
        out.update({f"{k}_s": v for k, v in sorted(self.tel.seconds.items())})
        return out
