"""What the per-layer metric readers (``metrics/<name>.py``) share: the
window's steps by kind, the device time of a kernel function in chosen
steps, a step's bound by the frozen formulas, and the window's model
FLOPs. A reader returns None when its cell gives it nothing to read."""
from __future__ import annotations

import bisect
from typing import Iterable, List, Optional

from perfbench.models.decoder import layout
from perfbench.work import formulas, model_flops, peaks


def window_steps(s) -> list:
    w0, w1 = s.window
    return [st for st in s.steps if st.t0 >= w0 and st.t1 <= w1]


def decode_only(steps: Iterable) -> list:
    return [st for st in steps if st.lanes and not st.admitted
            and not st.chunks]


def mean_ms(steps: List) -> Optional[float]:
    if not steps:
        return None
    return 1e3 * sum(st.t1 - st.t0 for st in steps) / len(steps)


def share(part: float, whole: float) -> Optional[float]:
    return 100.0 * part / whole if whole > 0 else None


def device_seconds(s, cls: str, steps: List) -> float:
    """Device seconds of kernel function ``cls`` launched inside ``steps``
    (on the trace's timeline, a step's kernels run within its span: each
    engine step ends by reading its tokens back)."""
    ts = s.trace_summary
    spans = sorted((st.t0, st.t1) for st in steps)
    starts = [a for a, _ in spans]
    total = 0.0
    for start, dur in ts.by_class.get(cls, []):
        j = bisect.bisect_right(starts, start) - 1
        if j >= 0 and start < spans[j][1]:
            total += dur
    return total


def traced(s, steps: List) -> list:
    return [st for st in steps if st.traced]


def _quant(s):
    return s.bench.config["quant"]


def decode_bound_s(s, cls: str) -> float:
    """Least time of one decode step's ``cls`` work on this chip: K1 for
    every plain projection at ``decode_batch`` rows, K6 for each routed
    stack (every expert live, the lanes' ``top_k`` assignments)."""
    model, rank = s.bench.config["model"], _quant(s)["rank"]
    b = s.sc.decode_batch
    total = 0.0
    for _, e, m, n, _ in layout(model):
        if e and cls == "K6":
            w = formulas.qlr_batched_work(e, b, m, n, rank,
                                          rows=b * model["top_k"])
        elif not e and cls == "K1":
            w = formulas.qlr_work(b, m, n, rank)
        else:
            continue
        total += peaks.bound_s(w.flops, w.bytes)
    return total


def roofline(s, cls: str, steps: List, bound_per_step: float
             ) -> Optional[float]:
    if s.trace_summary is None or not steps:
        return None
    dev = device_seconds(s, cls, steps)
    return share(bound_per_step * len(steps), dev) if dev > 0 else None


def window_flops(s) -> float:
    """Useful model FLOPs in the window: every token decoded in it (its
    projections, head and attention over its context) and every prompt
    admitted in it (prefilled causally)."""
    model, rank = s.bench.config["model"], _quant(s)["rank"]
    w0, w1 = s.window
    per_tok = model_flops.token_flops(model, rank)
    keys = 0
    n_tok = 0
    prompts = 0.0
    for r in s.reqs.values():
        p = len(r.prompt)
        for j, t in enumerate(r.tokens):
            if j and w0 <= t <= w1:
                n_tok += 1
                keys += p + j
        if r.admitted is not None and w0 <= r.admitted <= w1:
            prompts += model_flops.prompt_flops(model, rank, p)
    return n_tok * per_tok + model_flops.attention_flops(model, keys) + prompts


def idle_share(s) -> Optional[float]:
    ts = s.trace_summary
    if ts is None:
        return None
    return 100.0 * (1.0 - ts.busy_s / ts.window_s)
