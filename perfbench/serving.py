"""Drive the port's serving engine from a traffic mix and record each step.

The traffic generators (``generators/closed_backlog.py``,
``generators/open_poisson.py``) decide what is submitted when; this
module builds the engine on the raw weights, runs engine steps with the
host clock around each, counts every output token as the engine records
it, traces a stretch of the window on request, and after the window
frees the engine and has the plain reference judge a sample of the
finished requests.

The spans are the benchmark's own, taken around calls into the engine:
a step's start and end, the requests it admitted and the decode lanes
and prefill chunks it ran (from the engine's counters), and each token's
arrival (``Engine.on_token``).
"""
from __future__ import annotations

import dataclasses
import gc
import math
import statistics
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from perfbench import registry, trace


@dataclasses.dataclass
class Step:
    t0: float
    t1: float
    admitted: int        # requests admitted in the step
    lanes: int           # decode lanes that produced a token (0: no decode)
    chunks: int          # prefill chunks run (paged engine)
    traced: bool


@dataclasses.dataclass
class Req:
    uid: int
    prompt: np.ndarray
    max_new: int
    due: Optional[float] = None       # open loop: when it was due
    admitted: Optional[float] = None  # start of the step that admitted it
    tokens: List[float] = dataclasses.field(default_factory=list)
    lp: List[tuple] = dataclasses.field(default_factory=list)  # per token:
    # (ids, logprobs) the engine reported, the token's own first
    served: Optional[np.ndarray] = None   # its tokens once finished
    finished: Optional[float] = None


def lognormal_strata(median: float, sigma: float, lo: int, hi: int,
                     n: int) -> List[int]:
    """``n`` lengths at the midpoints of ``n`` equal-probability strata of
    a log-normal (``median``, ``sigma``), clipped to ``[lo, hi]``."""
    nd = statistics.NormalDist()
    return [int(min(hi, max(lo, round(median * math.exp(
        sigma * nd.inv_cdf((i + 0.5) / n)))))) for i in range(n)]


def uniform_strata(lo: int, hi: int, n: int) -> List[int]:
    return [int(round(lo + (hi - lo) * (i + 0.5) / n)) for i in range(n)]


def lengths(spec: Dict, n: int) -> List[int]:
    """A traffic file's length distribution, ``n`` strata."""
    if "median" in spec:
        return lognormal_strata(spec["median"], spec["sigma"], spec["min"],
                                spec["max"], n)
    return uniform_strata(spec["min"], spec["max"], n)


class Session:
    """One run of a serving cell: the raw weights, the engine on them, and
    what the window recorded."""

    def __init__(self, bench: "registry.Bench"):
        from repro_torch.serve.engine import Engine, ServeConfig

        self.bench = bench
        cfg, tr = bench.config, bench.traffic
        self.rng = np.random.default_rng(bench.seed)
        family = registry.family(cfg)
        self.raw = family.draw(cfg, bench.seed, bench.device)
        model = family.build(self.raw, cfg)
        self.sc = ServeConfig(**tr["engine"], **cfg["serve"])
        self.engine = Engine(model, model.cfg, self.sc, device=bench.device)
        self.engine.warmup()
        self.engine.on_token = self._on_token
        self.reqs: Dict[int, Req] = {}
        self.steps: List[Step] = []
        self.next_uid = 0
        self.tracer: Optional[trace.DeviceTrace] = None
        self.trace_summary = None
        self.window = (0.0, 0.0)

    # --- requests -------------------------------------------------------
    def make(self, prompt_len: int, max_new: int, due: Optional[float] = None
             ) -> Req:
        v = self.bench.config["model"]["vocab"]
        prompt = self.rng.integers(0, v, size=prompt_len, dtype=np.int32)
        r = Req(self.next_uid, prompt, max_new, due)
        self.next_uid += 1
        return r

    def submit(self, r: Req) -> None:
        from repro_torch.serve.engine import Request
        from repro_torch.serve.sampling import SamplingParams

        self.reqs[r.uid] = r
        self.engine.submit(Request(
            uid=r.uid, prompt=r.prompt, t_submit=r.due or 0.0,
            params=SamplingParams(max_new_tokens=r.max_new,
                                  logprobs=self.bench.traffic.get(
                                      "logprobs"))))

    def _on_token(self, uid: int, token: int, info) -> None:
        r = self.reqs[uid]
        r.tokens.append(time.perf_counter())
        if info is None:                    # the request asked for none
            return
        top = info["top_logprobs"]
        r.lp.append(([token] + [i for i, _ in top],
                     [info["logprob"]] + [v for _, v in top]))

    @property
    def queued(self) -> int:
        return len(self.engine.sched.queue)

    @property
    def busy(self) -> bool:
        return self.engine.sched.has_work

    # --- steps ----------------------------------------------------------
    def step(self) -> None:
        eng = self.engine
        st = eng.sched.stats
        adm0, lanes0 = st.admitted, st.decode_slot_steps
        chunks0 = getattr(eng, "_prefill_chunks", 0)
        t0 = time.perf_counter()
        done = eng.step()
        t1 = time.perf_counter()
        for state in eng.sched.table.active.values():
            if self.reqs[state.uid].admitted is None:
                self.reqs[state.uid].admitted = t0
        for res in done:
            r = self.reqs[res.uid]
            r.served, r.finished = res.tokens, t1
            if r.admitted is None:
                r.admitted = t0
        self.steps.append(Step(t0, t1, st.admitted - adm0,
                               st.decode_slot_steps - lanes0,
                               getattr(eng, "_prefill_chunks", 0) - chunks0,
                               self.tracer is not None and self.tracer.on))

    def start_window(self) -> float:
        if self.bench.trace:
            self.tracer = trace.DeviceTrace(self.bench.device)
            self.tracer.start()
        t0 = time.perf_counter()
        self.window = (t0, t0)
        return t0

    def tick(self, now: float) -> None:
        """Stop the trace once its stretch of the window has passed."""
        if self.tracer is not None and self.tracer.on and \
                now - self.window[0] >= self.bench.traffic["trace_seconds"]:
            self.tracer.stop()

    def end_window(self, t1: float) -> None:
        self.window = (self.window[0], t1)
        if self.tracer is not None and self.tracer.on:
            self.tracer.stop()

    def read_trace(self) -> None:
        """Parse the traced stretch, after the window and its grace."""
        if self.tracer is not None:
            self.trace_summary = self.tracer.summary()

    def step_kind(self, t: float) -> str:
        """What the host was doing at host time ``t``: which kind of engine
        step ran then, or the harness between steps."""
        for st in self.steps:                  # the traced stretch is short
            if st.t0 <= t < st.t1:
                if st.admitted:
                    return "admission step"
                if st.chunks:
                    return "prefill chunk step"
                return "decode step" if st.lanes else "empty step"
        return "harness between steps"

    def describe(self) -> str:
        """One line on the window's steps, for standard error."""
        from perfbench import readers
        steps = readers.window_steps(self)
        adm = [st for st in steps if st.admitted]
        dec = readers.decode_only(steps)
        out = (f"window {self.window[1] - self.window[0]:.3f} s: "
               f"{len(steps)} steps, {len(adm)} admitting "
               f"{sum(st.admitted for st in adm)} requests "
               f"({readers.mean_ms(adm) or 0:.2f} ms each), {len(dec)} "
               f"decode-only ({readers.mean_ms(dec) or 0:.2f} ms each), "
               f"{sum(st.chunks for st in steps)} chunks")
        traced = readers.traced(self, dec)
        if self.trace_summary is not None and traced:
            spans = [(st.t0, st.t1) for st in traced]
            busy = sum(d for _, s0, d in self.trace_summary.ops
                       if any(a <= s0 < b for a, b in spans))
            out += (f"; traced decode-only steps: {len(traced)}, "
                    f"{readers.mean_ms(traced):.2f} ms host, "
                    f"{1e3 * busy / len(traced):.2f} ms device each")
        return out

    def breakdown(self) -> Optional[Dict[str, List]]:
        ts = self.trace_summary
        if ts is None:
            return None
        return {"device_ops": ts.top_ops(), "idle_gaps": ts.idle_gaps(
            self.step_kind)}

    # --- after the window -----------------------------------------------
    def in_window(self, t: float) -> bool:
        return self.window[0] <= t <= self.window[1]

    def release(self) -> None:
        """Free the engine, its cache and the model's modules; the raw
        weights stay for the reference."""
        self.engine = None
        gc.collect()
        if self.bench.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, finished: List[Req]):
        """The reference's readings on a sample of ``finished`` drawn from
        the seed, the longest in it (``perfbench.checks.judge``)."""
        from perfbench import checks
        pick = checks.sample_requests(
            finished, self.bench.traffic["check"]["requests"], self.bench.seed)
        return checks.judge(self, pick)
