"""A closed offline batch: a backlog that always holds more requests than
the engine has lanes, so every lane that frees is refilled at once.

Traffic file keys: ``engine`` (the ``ServeConfig`` fields of the cell),
``prompt`` and ``output`` (log-normal ``median``/``sigma`` clipped to
``min``/``max``, or uniform ``min``/``max``), ``strata`` (lengths come
in blocks of that many equal-probability strata, each block shuffled;
the order is the same for every seed, so every seed serves the same
work: the seed draws the weights and the prompts' tokens),
``backlog`` (requests kept queued beyond the lanes), ``trace_seconds``
(the traced stretch of a ``--trace 1`` window) and ``check.requests``
(finished requests the reference judges).

Set-up fills every lane before the window opens, as a batch that has run
for a while has them: the first ``decode_batch`` requests are admitted
together, each with the part of its output that a lane in the steady
state still has to go (its length times a stratum of (0, 1]).
"""
from __future__ import annotations

import math
import time
from typing import Iterator, Tuple

import numpy as np

from perfbench import registry
from perfbench.outcome import Outcome
from perfbench.serving import Session, lengths


def _sizes(tr) -> Iterator[Tuple[int, int]]:
    rng = np.random.default_rng(1)
    n = tr["strata"]
    prompts, outputs = lengths(tr["prompt"], n), lengths(tr["output"], n)
    while True:
        for p, o in zip(rng.permutation(prompts), rng.permutation(outputs)):
            yield int(p), int(o)


def run(bench: registry.Bench) -> Outcome:
    s = Session(bench)
    tr = bench.traffic
    lanes = s.sc.decode_batch
    sizes = _sizes(tr)
    left = np.random.default_rng(2).permutation(lanes)
    for j in range(lanes):
        p, o = next(sizes)
        s.submit(s.make(p, max(1, math.ceil((left[j] + 0.5) / lanes * o))))
    s.step()                                   # admits every lane

    def top_up():
        while s.queued < tr["backlog"]:
            s.submit(s.make(*next(sizes)))

    top_up()
    setup_end = time.perf_counter()
    t0 = s.start_window()
    while True:
        top_up()
        s.step()
        now = s.steps[-1].t1
        s.tick(now)
        if now - t0 >= bench.seconds:
            break
    s.end_window(now)
    w0, w1 = s.window
    toks = [t for r in s.reqs.values() for t in r.tokens if w0 <= t <= w1]
    gaps = [b - a for r in s.reqs.values()
            for a, b in zip(r.tokens, r.tokens[1:]) if w0 <= a and b <= w1]
    done = [r for r in s.reqs.values()
            if r.finished is not None and w0 <= r.finished <= w1]
    return Outcome(setup_end, {"out_tok_s": len(toks) / (w1 - w0)},
                   {"itl_ms": [1e3 * g for g in gaps]}, attempted=len(done),
                   failed=sum(len(r.served) != r.max_new for r in done),
                   session=s, done=done)
