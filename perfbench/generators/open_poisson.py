"""An open loop: requests arrive on a Poisson schedule at a fixed rate,
whether or not earlier ones have finished.

Traffic file keys: ``engine``, ``prompt``, ``output``, ``strata``,
``trace_seconds`` and ``check`` as in ``closed_backlog``; ``rate``
(requests a second), ``grace_seconds`` (how long past the window's close
the requests due in it may take to answer).

The gaps between arrivals are the midpoints of ``strata``
equal-probability strata of the exponential distribution, each block of
them shuffled, as are the lengths; the schedule is the same for every
seed, which draws the weights and the prompts' tokens. Each request is timed from its
due time (``Request.t_submit``), so a stall delays the requests behind it
in their TTFT. When the window closes nothing more is submitted; the
engine runs on until every request due in the window has its first
token and has finished, for at most ``grace_seconds``. One that has not
answered by then counts as failed, with its TTFT taken at that limit.
"""
from __future__ import annotations

import math
import time

import numpy as np

from perfbench import registry
from perfbench.outcome import Outcome
from perfbench.serving import Session, lengths


def schedule(tr, seconds: float):
    """[(offset s, prompt length, output length)] of every request due in
    a window of ``seconds``."""
    rng = np.random.default_rng(1)
    n = tr["strata"]
    gaps = [-math.log(1.0 - (i + 0.5) / n) / tr["rate"] for i in range(n)]
    prompts, outputs = lengths(tr["prompt"], n), lengths(tr["output"], n)
    out, t = [], 0.0
    while True:
        for g, p, o in zip(rng.permutation(gaps), rng.permutation(prompts),
                           rng.permutation(outputs)):
            t += g
            if t >= seconds:
                return out
            out.append((t, int(p), int(o)))


def run(bench: registry.Bench) -> Outcome:
    s = Session(bench)
    tr = bench.traffic
    plan = schedule(tr, bench.seconds)
    due = [s.make(p, o) for _, p, o in plan]
    setup_end = time.perf_counter()
    t0 = s.start_window()
    for r, (off, _, _) in zip(due, plan):
        r.due = t0 + off
    nxt, lag = 0, 0.0
    now = t0
    while now - t0 < bench.seconds:
        now = time.perf_counter()
        while nxt < len(due) and due[nxt].due <= now:
            lag = max(lag, now - due[nxt].due)
            s.submit(due[nxt])
            nxt += 1
        if s.busy:
            s.step()
            now = s.steps[-1].t1
        elif nxt < len(due):
            time.sleep(max(0.0, min(due[nxt].due - now, 1e-3)))
        s.tick(now)
    s.end_window(max(now, s.steps[-1].t1 if s.steps else now))
    limit = s.window[1] + tr["grace_seconds"]
    for r in due[nxt:]:                        # due before the close
        s.submit(r)
    while s.busy and time.perf_counter() < limit:
        s.step()
    end = min(time.perf_counter(), limit)
    ttft = [1e3 * ((r.tokens[0] if r.tokens else end) - r.due) for r in due]
    wait = [1e3 * (r.admitted - r.due) for r in due if r.admitted is not None]
    done = [r for r in due if r.served is not None]
    s.lag_s = lag
    return Outcome(setup_end, {}, {"ttft_ms": ttft, "queue_wait_ms": wait},
                   attempted=len(due),
                   failed=sum(not r.tokens or r.served is None for r in due),
                   session=s, done=done)
