"""The offline pass: the port's ``models/quantize.py`` (qera-exact
scalings, then SRR through K7) over a dense decoder's blocks, block after
block, wrapping round to the first.

Traffic file keys: ``calib_rows`` (rows behind each block's calibration
moments), ``planted_rank`` and ``planted`` (each weight is Gaussian at
the JAX package's init scale plus a rank-``planted_rank`` term of
``planted`` times its norm, the structure SRR preserves), ``outliers``
(the log-normal spread of the input channels' scales),
``trace_blocks`` (how many of the window's first blocks a ``--trace 1``
run records) and ``check.matrices`` (how many of the window's matrices
the reference redoes).

Set-up draws every block's f32 weights and the four autocorrelation sums
a block's inputs give (the attention input, ``wo``'s, the MLP input,
``down``'s) from the seed on the card, and runs one block's pass to
build and warm everything. The window then quantizes block after block;
each block gets fresh statistics, so its scalings are built anew. The
benchmark's spans: each block's scalings (``CalibStats.scaling``, built
before the block's pass asks for them) and its pass, each closed by a
synchronize. A ``--trace 1`` run records the card during the passes of
the first ``trace_blocks`` blocks and not during their scalings
(``torch.profiler`` slows cuSOLVER's ``eigh`` by orders of magnitude),
and reads the recordings after the window; its set-up starts and stops
the profiler once, so that the window does not pay its first start.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List

import numpy as np
import torch

from perfbench import registry, trace
from perfbench.outcome import Outcome

GROUPS = {"wq": "attn", "wk": "attn", "wv": "attn", "wo": "o", "up": "mlp",
          "gate": "mlp", "down": "down"}


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@dataclasses.dataclass
class Done:
    """One matrix quantized in the window: where it came from and the
    port's container."""
    block: int
    name: str
    index: int            # the pass's running matrix index (its seed)
    k: int
    codes: torch.Tensor
    l: torch.Tensor
    r: torch.Tensor


class Pass:
    """One run of the pass cell."""

    def __init__(self, bench: registry.Bench):
        from repro_torch.core.api import PTQConfig
        from repro_torch.quant import QuantizerConfig

        self.bench = bench
        cfg, tr = bench.config, bench.traffic
        model, q = cfg["model"], cfg["quant"]
        if model.get("moe"):
            raise ValueError("the pass cell quantizes dense decoders")
        self.model, dev = model, bench.device
        self.ptq = PTQConfig(method=q["method"], scaling=q["scaling"],
                             quantizer=QuantizerConfig(kind="mxint",
                                                       bits=q["bits"],
                                                       block_size=q["block"]),
                             rank=q["rank"], seed=int(bench.seed))
        gen = torch.Generator(device=dev).manual_seed(int(bench.seed))
        d, hd = model["d_model"], model["head_dim"]
        qd, kvd, ff = model["n_heads"] * hd, model["n_kv_heads"] * hd, \
            model["d_ff"]
        shapes = {"wq": (d, qd), "wk": (d, kvd), "wv": (d, kvd),
                  "wo": (qd, d), "up": (d, ff), "gate": (d, ff),
                  "down": (ff, d)}
        widths = {"attn": d, "o": qd, "mlp": d, "down": ff}
        self.blocks: List[Dict[str, torch.Tensor]] = []
        self.moments: List[Dict[str, tuple]] = []
        rows, pr = tr["calib_rows"], tr["planted_rank"]
        for _ in range(model["n_layers"]):
            mats = {}
            for name, (m, n) in shapes.items():
                w = torch.randn((m, n), generator=gen, device=dev) * m ** -0.5
                u = torch.randn((m, pr), generator=gen, device=dev)
                v = torch.randn((pr, n), generator=gen, device=dev)
                w += (u @ v) * (tr["planted"] * m ** -0.5 / math.sqrt(pr))
                mats[name] = w
            self.blocks.append(mats)
            mom = {}
            for g, m in widths.items():
                scale = torch.exp(tr["outliers"] * torch.randn(
                    (m,), generator=gen, device=dev))
                x = torch.randn((rows, m), generator=gen, device=dev) * scale
                mom[g] = (x.abs().sum(0), (x * x).sum(0), x.T @ x)
            self.moments.append(mom)
        self.count = rows
        self.walk = None
        self.done: List[Done] = []
        self.scaling_spans: List[tuple] = []   # (t0, t1) host clock
        self.traces: List[trace.DeviceTrace] = []
        self.trace_summary = None
        if bench.trace:
            warm = trace.DeviceTrace(dev)
            warm.start()
            warm.stop()
            warm.summary()
        self.window = (0.0, 0.0)
        self.quantize_block(0, record=False)          # build and warm

    def _stats(self, i: int):
        from repro_torch.core.api import CalibStats
        mom = self.moments[i]
        by_group = {g: CalibStats(self.count, *mom[g]) for g in mom}
        return {f"L{i}.{'attn.' if n in ('wq', 'wk', 'wv', 'wo') else '.'}{n}":
                by_group[GROUPS[n]] for n in GROUPS}, by_group

    def quantize_block(self, i: int, record: bool = True) -> None:
        from repro_torch.models.attention import Attention
        from repro_torch.models.layers import MLP, RMSNorm
        from repro_torch.models.linear import FpLinear
        from repro_torch.models.quantize import ModelPass
        from repro_torch.models.transformer import Block

        stats, groups = self._stats(i)
        if self.walk is None or not record:
            self.walk = ModelPass(self.ptq, "int8", stats=stats)
        else:
            self.walk.stats = stats
        dev = self.bench.device
        t0 = time.perf_counter()
        for st in groups.values():
            st.scaling(self.ptq.scaling)
        _sync(dev)
        t1 = time.perf_counter()
        w = self.blocks[i]
        one = torch.ones((self.model["d_model"],), device=dev)
        blk = Block(RMSNorm(one), Attention(*(FpLinear(w[n]) for n in
                                              ("wq", "wk", "wv", "wo"))),
                    RMSNorm(one), MLP(FpLinear(w["up"]), FpLinear(w["gate"]),
                                      FpLinear(w["down"])), "attn")
        tracer = None
        if record and self.bench.trace and \
                len(self.traces) < self.bench.traffic["trace_blocks"]:
            tracer = trace.DeviceTrace(dev)
            tracer.start()
        first = self.walk.index
        self.walk.decoder_block(i, blk)
        _sync(dev)
        if tracer is not None:
            tracer.stop()
            self.traces.append(tracer)
        if not record:
            self.walk = None
            return
        self.scaling_spans.append((t0, t1))
        reps = self.walk.reports[-7:]
        for j, (name, p) in enumerate(
                [(n, getattr(blk.mixer, n)) for n in ("wq", "wk", "wv", "wo")]
                + [(n, getattr(blk.mlp, n)) for n in ("up", "gate", "down")]):
            self.done.append(Done(i, name, first + j + 1, reps[j].k_star,
                                  p.codes, p.l, p.r))

    def release(self) -> None:
        self.walk = None
        if self.bench.device.type == "cuda":
            torch.cuda.empty_cache()

    def read_trace(self) -> None:
        s = [t.summary() for t in self.traces]
        if s:
            self.trace_summary = trace.Summary(
                (s[0].window[0], s[0].window[0] + sum(x.window_s for x in s)),
                [o for x in s for o in x.ops],
                {}, sum(x.busy_s for x in s))

    def describe(self) -> str:
        sc = sum(b - a for a, b in self.scaling_spans)
        return (f"window {self.window[1] - self.window[0]:.3f} s: "
                f"{len(self.done) // 7} blocks, {len(self.done)} matrices, "
                f"scalings {sc:.3f} s")

    def breakdown(self):
        ts = self.trace_summary
        if ts is None:
            return None
        return {"device_ops": ts.top_ops(), "idle_gaps": []}

    def check(self, done: List[Done]):
        from perfbench import checks
        return checks.judge_pass(self, done)


def run(bench: registry.Bench) -> Outcome:
    p = Pass(bench)
    setup_end = time.perf_counter()
    t0 = time.perf_counter()
    p.window = (t0, t0)
    i = 0
    while time.perf_counter() - t0 < bench.seconds:
        p.quantize_block(i % len(p.blocks))
        i += 1
    t1 = time.perf_counter()
    p.window = (t0, t1)
    weights = sum(d.codes.numel() for d in p.done)
    rng = np.random.default_rng([bench.seed, 4])
    n = bench.traffic["check"]["matrices"]
    last = [d for d in p.done if d.name == "down"][-1:]
    rest = [d for d in p.done if d not in last]
    pick = last + [rest[j] for j in sorted(rng.choice(
        len(rest), size=min(n - 1, len(rest)), replace=False))]
    return Outcome(setup_end, {"ptq_weights_per_s": weights / (t1 - t0)}, {},
                   attempted=len(p.done), failed=0, session=p, done=pick)
