"""Serve-side telemetry: metrics registry, lifecycle tracing, torch hooks
(port of ``repro/serve/telemetry.py``).

Three pieces, as in the JAX package:

  * **Metrics registry** (:class:`MetricsRegistry`): named counters,
    gauges and fixed log-spaced-bucket histograms. ``snapshot()`` returns
    one flat JSON-serializable dict (the engine, scheduler, page pool and
    prefix cache *publish* into it at collection time, so the snapshot is
    uniform across bucketed/continuous/paged modes); ``prometheus()``
    renders the standard text exposition format.
  * **Request-lifecycle + step tracing** (:class:`Tracer`,
    :class:`Telemetry`): every request emits spans (queued → admitted →
    prefill-chunk[i] → first-token → decode → retired) on its own
    Chrome-trace thread lane, and every engine ``step()`` emits a phase
    breakdown (budget, admission, chunk prefill, decode, verify, host
    transfer). Exported as Chrome trace-event JSON (Perfetto /
    ``chrome://tracing``) and as a JSONL event stream. An opt-in ``sync``
    fence (``torch.cuda.synchronize`` after a device dispatch) puts device
    time in the phase that launched it instead of the next host transfer.
  * **Torch hooks** in place of JAX's: :meth:`Telemetry.entry` labels
    each prefill / chunk / decode / draft / verify dispatch with
    ``torch.profiler.record_function("serve/<name>")`` and keeps JAX's
    per-entry accounting — ``compiled_shapes_<name>`` (distinct shape
    keys), ``dispatches_<name>`` and ``first_call_seconds_<name>`` (wall
    seconds of first-seen-shape calls). The port has no XLA compile:
    ``compile_seconds_<name>`` counts the seconds ``kernels/_build.py``
    spent in ``nvcc`` during that entry's calls, which is 0 once the
    kernels are built. ``profile_dir`` arms a ``torch.profiler.profile``
    over the first ``profile_steps`` engine steps, written there as a
    Chrome trace (``serve_steps.trace.json``).

Telemetry is near-zero-cost when disabled: the engine holds
:data:`NULL_TELEMETRY`, whose methods are no-ops and whose context
managers are a shared null object.

Also here: the shared interpolating :func:`percentile` (numpy's
"linear" method) and :func:`named_scope`, the labelled region around a
deliberate host read of device values (the drift probe, the sanitizer).
"""
from __future__ import annotations

import bisect
import contextlib
import json
import math
import os
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from torch.profiler import record_function

from repro_torch.kernels import _build


def named_scope(name: str):
    """A ``torch.profiler`` range around a deliberate host read of device
    values, so the wait shows under its own name in a profile."""
    return record_function(name)


# ==========================================================================
# Percentiles
# ==========================================================================
def percentile(values: Sequence[float], q: float) -> float:
    """Linear-interpolating percentile of ``values`` at quantile ``q`` in
    [0, 1] — numpy's default method, so ``percentile(v, q) ==
    np.percentile(v, 100 * q)``."""
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"quantile {q} outside [0, 1]")
    vals = sorted(float(v) for v in values)
    if not vals:
        raise ValueError("percentile of empty sequence")
    pos = q * (len(vals) - 1)
    lo = math.floor(pos)
    hi = min(lo + 1, len(vals) - 1)
    frac = pos - lo
    return vals[lo] * (1.0 - frac) + vals[hi] * frac


def latency_summary(values: Sequence[float], scale: float = 1.0
                    ) -> Dict[str, float]:
    """p50/p95/p99 + mean/max of ``values`` (× ``scale``, e.g. 1e3 for
    ms). Empty input → zeros."""
    vals = [float(v) for v in values]
    if not vals:
        return {"p50": 0.0, "p95": 0.0, "p99": 0.0, "mean": 0.0, "max": 0.0}
    return {"p50": percentile(vals, 0.50) * scale,
            "p95": percentile(vals, 0.95) * scale,
            "p99": percentile(vals, 0.99) * scale,
            "mean": sum(vals) / len(vals) * scale,
            "max": max(vals) * scale}


# ==========================================================================
# Metrics registry
# ==========================================================================
def log_buckets(lo: float = 1e-5, hi: float = 100.0,
                per_decade: int = 4) -> List[float]:
    """Geometric bucket upper bounds: ``per_decade`` boundaries per decade
    from ``lo`` to ``hi`` inclusive."""
    if lo <= 0 or hi <= lo:
        raise ValueError(f"need 0 < lo < hi, got lo={lo} hi={hi}")
    n = int(round(math.log10(hi / lo) * per_decade))
    bounds = [lo * 10 ** (i / per_decade) for i in range(n + 1)]
    bounds[-1] = hi             # snap the last boundary onto hi exactly
    return bounds


def _scalar(v: float):
    return int(v) if v == int(v) else v


class Counter:
    """Monotonic counter: ``inc()`` for events, ``set()`` to publish an
    absolute tally at collection time."""
    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def set(self, v: float) -> None:
        self.value = float(v)

    def snapshot(self):
        return _scalar(self.value)


class Gauge(Counter):
    """Point-in-time value (occupancy, pool residency, hit rate)."""
    kind = "gauge"


class Histogram:
    """Fixed-bucket histogram over log-spaced boundaries. ``counts[i]``
    tallies observations ``<= bounds[i]``; the last slot is the +Inf
    overflow. Quantiles interpolate geometrically within the containing
    bucket, clamped to the observed min/max."""
    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: Optional[Sequence[float]] = None):
        self.name = name
        self.help = help
        self.bounds = list(buckets) if buckets is not None else log_buckets()
        if sorted(self.bounds) != self.bounds \
                or len(set(self.bounds)) != len(self.bounds):
            raise ValueError(f"{name}: bucket bounds must be strictly "
                             f"increasing")
        self.reset()

    def observe(self, v: float) -> None:
        v = float(v)
        self.counts[bisect.bisect_left(self.bounds, v)] += 1
        self.sum += v
        self.count += 1
        self.min = min(self.min, v)
        self.max = max(self.max, v)

    def quantile(self, q: float) -> Optional[float]:
        """Bucket-interpolated quantile estimate (None when empty)."""
        if self.count == 0:
            return None
        target = q * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if cum + c >= target:
                lo = self.bounds[i - 1] if i > 0 else min(self.min,
                                                          self.bounds[0])
                hi = self.bounds[i] if i < len(self.bounds) else self.max
                lo = max(lo, self.min)
                hi = min(hi, self.max)
                if lo <= 0 or hi <= lo:
                    return hi
                return lo * (hi / lo) ** ((target - cum) / c)
            cum += c
        return self.max

    def reset(self) -> None:
        self.counts = [0] * (len(self.bounds) + 1)
        self.sum = 0.0
        self.count = 0
        self.min = math.inf
        self.max = -math.inf

    def snapshot(self) -> Dict[str, Optional[float]]:
        if self.count == 0:
            return {"count": 0, "sum": 0.0, "min": None, "max": None,
                    "p50": None, "p95": None, "p99": None}
        return {"count": self.count, "sum": self.sum,
                "min": self.min, "max": self.max,
                "p50": self.quantile(0.50), "p95": self.quantile(0.95),
                "p99": self.quantile(0.99)}


def _fmt(v: float) -> str:
    return f"{v:.9g}"


class MetricsRegistry:
    """Name → metric map with typed get-or-create accessors. Asking for a
    registered name as another metric type raises."""

    def __init__(self):
        self._metrics: Dict[str, Any] = {}

    def _get(self, cls, name: str, help: str, **kw):
        m = self._metrics.get(name)
        if m is None:
            m = cls(name, help, **kw)
            self._metrics[name] = m
        elif type(m) is not cls:
            raise TypeError(f"metric {name!r} already registered as "
                            f"{m.kind}, requested {cls.kind}")
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        return self._get(Histogram, name, help, buckets=buckets)

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def snapshot(self) -> Dict[str, Any]:
        return {name: m.snapshot() for name, m in self._metrics.items()}

    def prometheus(self) -> str:
        """Prometheus text exposition (histograms in the cumulative
        ``_bucket{le=...}`` / ``_sum`` / ``_count`` form)."""
        lines: List[str] = []
        for name, m in self._metrics.items():
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {m.kind}")
            if isinstance(m, Histogram):
                cum = 0
                for bound, c in zip(m.bounds, m.counts):
                    cum += c
                    lines.append(f'{name}_bucket{{le="{_fmt(bound)}"}} {cum}')
                lines.append(f'{name}_bucket{{le="+Inf"}} {m.count}')
                lines.append(f"{name}_sum {_fmt(m.sum)}")
                lines.append(f"{name}_count {m.count}")
            else:
                lines.append(f"{name} {_fmt(m.value)}")
        return "\n".join(lines) + "\n"

    def reset_histograms(self) -> None:
        """Clear histogram samples (counters and gauges are absolutes
        published at collection time)."""
        for m in self._metrics.values():
            if isinstance(m, Histogram):
                m.reset()


# ==========================================================================
# Chrome trace-event tracer
# ==========================================================================
PID_REQUESTS = 1      # request-lifecycle lanes (tid = request uid)
PID_ENGINE = 2        # engine step/phase timeline (tid 0)


class Tracer:
    """Chrome trace-event buffer. Timestamps are microseconds from the
    tracer's birth (one ``time.perf_counter`` origin; :meth:`us` converts
    an absolute reading)."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.events: List[Dict[str, Any]] = []
        self._metadata()

    def _metadata(self) -> None:
        for pid, name in ((PID_REQUESTS, "requests"), (PID_ENGINE, "engine")):
            self.events.append({"ph": "M", "pid": pid, "tid": 0, "ts": 0,
                                "name": "process_name",
                                "args": {"name": name}})

    def now_us(self) -> float:
        return (time.perf_counter() - self.t0) * 1e6

    def us(self, t_perf: float) -> float:
        return (t_perf - self.t0) * 1e6

    def complete(self, name: str, ts_us: float, dur_us: float, pid: int,
                 tid: int, args: Optional[Dict] = None) -> None:
        ev = {"ph": "X", "name": name, "ts": round(ts_us, 3),
              "dur": round(max(dur_us, 0.0), 3), "pid": pid, "tid": tid}
        if args:
            ev["args"] = args
        self.events.append(ev)

    def instant(self, name: str, ts_us: float, pid: int, tid: int,
                args: Optional[Dict] = None) -> None:
        ev = {"ph": "i", "name": name, "ts": round(ts_us, 3), "pid": pid,
              "tid": tid, "s": "t"}
        if args:
            ev["args"] = args
        self.events.append(ev)

    def chrome(self) -> Dict[str, Any]:
        return {"traceEvents": list(self.events), "displayTimeUnit": "ms"}

    def write_chrome(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.chrome(), f)
            f.write("\n")
        return path

    def write_jsonl(self, path: str) -> str:
        with open(path, "w") as f:
            for ev in self.events:
                f.write(json.dumps(ev) + "\n")
        return path

    def reset(self) -> None:
        """Drop buffered events; the time origin is kept."""
        self.events = []
        self._metadata()


# ==========================================================================
# Telemetry facade
# ==========================================================================
STEP_PHASES = ("budget", "admission", "prefill", "decode", "verify",
               "transfer")
PROFILE_TRACE = "serve_steps.trace.json"


class Telemetry:
    """Live recorder the engine drives; owns the tracer and publishes
    request/step histograms and per-entry dispatch accounting into the
    (shared) registry. ``sync=True`` asks the engine to fence device
    dispatches; ``profile_dir`` arms ``torch.profiler`` for the first
    ``profile_steps`` engine steps."""

    enabled = True

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 sync: bool = False, profile_dir: Optional[str] = None,
                 profile_steps: int = 20):
        self.registry = registry if registry is not None else MetricsRegistry()
        self.tracer = Tracer()
        self.sync = sync
        self.profile_dir = profile_dir
        self.profile_steps = profile_steps
        self._profiler = None
        self._profile_done = False
        self._step_idx = 0
        self._step_t0: Optional[float] = None
        self._requests: Dict[int, Dict[str, float]] = {}
        # entry point → dispatch/build accounting
        self.compiles: Dict[str, Dict[str, Any]] = {}
        reg = self.registry
        self._h_step = reg.histogram("step_seconds", "engine step wall time")
        self._h_phase = {p: reg.histogram(f"step_{p}_seconds",
                                          f"step {p} phase wall time")
                         for p in STEP_PHASES}
        self._h_ttft = reg.histogram("ttft_seconds", "submit to first token")
        self._h_latency = reg.histogram("request_latency_seconds",
                                        "submit to retirement")
        self._h_itl = reg.histogram("itl_seconds",
                                    "inter-token latency (decode span / "
                                    "(tokens - 1))")
        self._h_chunk = reg.histogram("prefill_chunk_seconds",
                                      "one chunked-prefill dispatch")

    # ------------------------------------------------------------------
    # Request lifecycle
    # ------------------------------------------------------------------
    def request_queued(self, uid: int) -> None:
        self._requests[uid] = {"queued": self.tracer.now_us()}

    def request_admitted(self, uid: int) -> None:
        now = self.tracer.now_us()
        r = self._requests.setdefault(uid, {})
        q = r.get("queued", now)
        r["admitted"] = now
        self.tracer.complete("queued", q, now - q, PID_REQUESTS, uid)

    def request_prefill(self, uid: int, index: int, t0: float,
                        t1: float) -> None:
        """One prefill dispatch for ``uid`` (chunk ``index``; the unpaged
        prefill-on-admit is chunk 0); ``t0``/``t1`` are perf_counter."""
        self._h_chunk.observe(t1 - t0)
        self.tracer.complete(f"prefill_chunk[{index}]", self.tracer.us(t0),
                             (t1 - t0) * 1e6, PID_REQUESTS, uid)

    def request_first_token(self, uid: int) -> None:
        now = self.tracer.now_us()
        r = self._requests.setdefault(uid, {})
        a = r.get("admitted", now)
        r["first_token"] = now
        self.tracer.complete("prefill", a, now - a, PID_REQUESTS, uid)
        self.tracer.instant("first_token", now, PID_REQUESTS, uid)

    def request_retired(self, uid: int, n_tokens: int,
                        ttft_s: Optional[float], latency_s: Optional[float],
                        decode_s: Optional[float]) -> None:
        now = self.tracer.now_us()
        r = self._requests.pop(uid, {})
        ft = r.get("first_token")
        if ft is not None:
            self.tracer.complete("decode", ft, now - ft, PID_REQUESTS, uid,
                                 args={"tokens": n_tokens})
        elif "admitted" in r:
            # retired without sampling (max_new_tokens=0): close the
            # prefill span so the lane still covers queued → retired
            self.tracer.complete("prefill", r["admitted"],
                                 now - r["admitted"], PID_REQUESTS, uid)
        self.tracer.instant("retired", now, PID_REQUESTS, uid,
                            args={"tokens": n_tokens})
        if ttft_s is not None:
            self._h_ttft.observe(ttft_s)
        if latency_s is not None:
            self._h_latency.observe(latency_s)
        if decode_s is not None and n_tokens > 1:
            self._h_itl.observe(decode_s / (n_tokens - 1))

    # ------------------------------------------------------------------
    # Engine step phases
    # ------------------------------------------------------------------
    def step_begin(self) -> None:
        self._step_t0 = time.perf_counter()
        if self.profile_dir and not self._profile_done \
                and self._profiler is None:
            from torch.profiler import ProfilerActivity, profile
            import torch
            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self._profiler = profile(activities=acts)
            self._profiler.start()

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            self._h_phase[name].observe(t1 - t0)
            self.tracer.complete(name, self.tracer.us(t0), (t1 - t0) * 1e6,
                                 PID_ENGINE, 0)

    def step_end(self, n_decoding: int) -> None:
        t0, self._step_t0 = self._step_t0, None
        if t0 is not None:
            t1 = time.perf_counter()
            self._h_step.observe(t1 - t0)
            self.tracer.complete("step", self.tracer.us(t0),
                                 (t1 - t0) * 1e6, PID_ENGINE, 0,
                                 args={"step": self._step_idx,
                                       "decoding": n_decoding})
        self._step_idx += 1
        if self._profiler is not None and self._step_idx >= self.profile_steps:
            self.stop_profiler()

    # ------------------------------------------------------------------
    # Torch hooks: dispatch accounting + profiler labels
    # ------------------------------------------------------------------
    @contextlib.contextmanager
    def entry(self, name: str, shape_key: Tuple):
        """Wrap one dispatch of an engine entry point (prefill, chunk,
        decode, draft, verify): tracks the distinct ``shape_key``
        signatures, counts the seconds ``nvcc`` spends building kernels
        during the call (``compile_seconds``), times first-seen-signature
        calls, and labels the region ``serve/<name>`` for
        ``torch.profiler``."""
        info = self.compiles.setdefault(
            name, {"shapes": set(), "compiles": 0, "calls": 0,
                   "compile_seconds": 0.0, "first_call_seconds": 0.0})
        info["calls"] += 1
        first = shape_key not in info["shapes"]
        built0 = _build.BUILD_SECONDS.total
        t0 = time.perf_counter()
        try:
            with record_function(f"serve/{name}"):
                yield
        finally:
            info["compile_seconds"] += _build.BUILD_SECONDS.total - built0
            if first:
                dt = time.perf_counter() - t0
                info["shapes"].add(shape_key)
                info["compiles"] += 1
                info["first_call_seconds"] += dt
                self.tracer.instant(f"compile:{name}", self.tracer.now_us(),
                                    PID_ENGINE, 0,
                                    args={"shape": str(shape_key),
                                          "first_call_s": round(dt, 6)})

    def stop_profiler(self) -> None:
        if self._profiler is not None:
            prof, self._profiler = self._profiler, None
            prof.stop()
            os.makedirs(self.profile_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(self.profile_dir,
                                                  PROFILE_TRACE))
            self._profile_done = True

    # ------------------------------------------------------------------
    def publish(self) -> None:
        """Push the per-entry accounting into the registry (histograms
        live there already)."""
        reg = self.registry
        for name, info in self.compiles.items():
            reg.gauge(f"compiled_shapes_{name}",
                      f"distinct dispatched shapes for {name}"
                      ).set(len(info["shapes"]))
            reg.counter(f"dispatches_{name}",
                        f"total {name} dispatches").set(info["calls"])
            reg.gauge(f"compile_seconds_{name}",
                      f"nvcc kernel-build seconds during {name} calls"
                      ).set(round(info["compile_seconds"], 6))
            reg.gauge(f"first_call_seconds_{name}",
                      f"wall seconds of first-seen-shape {name} calls"
                      ).set(round(info["first_call_seconds"], 6))

    def reset_run(self) -> None:
        """Start a fresh measured run: drop trace events, open request
        spans and histogram samples. The per-entry accounting survives —
        it describes the engine session, not one run."""
        self.tracer.reset()
        self._requests.clear()
        self._step_idx = 0
        self._step_t0 = None
        self.registry.reset_histograms()

    def close(self) -> None:
        self.stop_profiler()


# ==========================================================================
# Disabled recorder: shared no-op singletons
# ==========================================================================
class _NullContext:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_CTX = _NullContext()


class NullTelemetry:
    """No-op recorder; ``Engine`` holds this when telemetry is off."""

    enabled = False
    sync = False
    registry = None
    tracer = None

    def request_queued(self, uid):
        pass

    def request_admitted(self, uid):
        pass

    def request_prefill(self, uid, index, t0, t1):
        pass

    def request_first_token(self, uid):
        pass

    def request_retired(self, uid, n_tokens, ttft_s, latency_s, decode_s):
        pass

    def step_begin(self):
        pass

    def phase(self, name):
        return _NULL_CTX

    def entry(self, name, shape_key):
        return _NULL_CTX

    def step_end(self, n_decoding):
        pass

    def publish(self):
        pass

    def reset_run(self):
        pass

    def stop_profiler(self):
        pass

    def close(self):
        pass


NULL_TELEMETRY = NullTelemetry()
