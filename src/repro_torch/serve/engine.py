"""Serving engine: continuous batching over a Q + LR model (port of the
continuous path of ``repro/serve/engine.py``).

A slot-based KV cache (``serve.slots``) gives every batch row its own
write position and slot map, so requests are admitted into free slots
mid-flight: prefill-on-admit copies a freshly prefilled row into the
live cache while the other slots keep decoding, and a request retires
the moment it reaches its ``max_new_tokens`` or its stop token. Prompts
are right-padded to one prefill width (``prefill_len``) and masked.

``fused="auto"`` (the default) runs every quantized projection through
K1/K2 and attention through K3/K4 on a CUDA device, and through their
plain versions on the CPU. ``fused="off"`` keeps the dequantize-then-
matmul and dequantize-the-cache baselines.

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
from repro_torch.models.linear import Ctx
from repro_torch.models.transformer import LM, decode_step, prefill
from repro_torch.serve.scheduler import ContinuousScheduler
from repro_torch.serve.slots import KV_DTYPES, SlotKVCache

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
    prefill_len: Optional[int] = None  # prompt pad width (default max_len)
    fused: str = "auto"              # Q+LR matmul / attention: auto|on|off


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
                                         sc.max_new_tokens)
        self.slots = SlotKVCache(self.cfg, sc.decode_batch, sc.max_len,
                                 sc.kv_dtype, self.device)
        self._tok = torch.zeros((sc.decode_batch, 1), dtype=torch.int64,
                                device=self.device)
        self.tel = Phases()

    # ------------------------------------------------------------------
    def _validate(self, req: Request) -> None:
        plen = len(req.prompt)
        if plen < 1:
            raise ValueError(f"request {req.uid}: empty prompt")
        if plen >= self.sc.max_len:
            raise ValueError(f"request {req.uid}: prompt length {plen} "
                             f"leaves no decode budget within max_len="
                             f"{self.sc.max_len}")
        if plen > self.prefill_len:
            raise ValueError(f"request {req.uid}: prompt length {plen} "
                             f"exceeds prefill_len={self.prefill_len}")
        self._check_temperature(req.temperature if req.temperature is not None
                                else self.sc.temperature)

    def submit(self, req: Request) -> int:
        """Queue a request; it is admitted on the next step() with a free
        slot. Returns the request uid."""
        self._validate(req)
        req.t_submit = req.t_submit or time.perf_counter()
        self.sched.submit(req)
        return req.uid

    def _admit_one(self) -> Optional[List[Result]]:
        """Prefill the next queued request into a free slot (if any)."""
        nxt = self.sched.next_admission()
        if nxt is None:
            return None
        req, state = nxt
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
        """Admit queued requests while slots are free, then run one decode
        step over every slot. Returns the requests finished now."""
        finished: List[Result] = []
        with self.tel.phase("admission"):
            while True:
                done = self._admit_one()
                if done is None:
                    break
                finished.extend(done)
        decoding = self.sched.table.active_slots()
        if not decoding:
            return finished
        with self.tel.phase("decode"):
            logits, self.slots.cache = decode_step(self.ctx, self.model,
                                                   self._tok, self.slots.cache)
            self._tok = _greedy(logits)
        self.sched.note_decode_step()
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
        """Run all requests through the scheduler as a fresh run (stats
        and submission timestamps reset)."""
        for r in requests:
            self._validate(r)
        self._reset()
        now = time.perf_counter()
        for r in requests:
            r.t_submit = now
            self.submit(r)
        return self.drain()

    def stats(self) -> Dict[str, float]:
        s = self.sched.stats
        out = {"admitted": s.admitted, "retired": s.retired,
               "eos_retired": s.eos_retired, "decode_steps": s.decode_steps,
               "occupancy": round(s.occupancy, 4)}
        out.update({f"{k}_s": v for k, v in sorted(self.tel.seconds.items())})
        return out
