"""The device trace of a stretch of the window (``--trace 1``).

``torch.profiler`` records the card's activity only (kernels, copies,
fills): a host op traced costs its parse far more than a kernel, and no
reader needs one. The benchmark's own spans (engine steps, pass stages)
are host-clock records; to place them on the trace's timeline, the
trace's first device event is a marker kernel launched on an idle card
right after the host clock is read, so the marker's start less that
reading is the offset between the two clocks (to a launch's latency).

The summary keeps each device operation as (start, duration) in seconds
on the host clock, grouped by the kernel function it belongs to (K1–K7,
from the kernel's name; K1 and K2 share ``qlr_tc_kernel`` and differ in
its ``FUSED`` template argument), and the busy time as the union of all
of them.
"""
from __future__ import annotations

import dataclasses
import re
import time
from typing import Dict, List, Optional, Tuple

import torch

# K1 and K2: qlr_tc_kernel<(anonymous namespace)::Tile<…>, PACKED, FUSED, XT>
_QLR = re.compile(r"qlr_tc_kernel<[^<>]*Tile<[^<>]*>\s*,\s*(true|false)\s*,"
                  r"\s*(true|false)")
KERNELS = (("K6", "qlr_stacked_kernel"), ("K3", "flash_decode_kernel"),
           ("K3", "decode_combine_kernel"), ("K4", "flash_attention_kernel"),
           ("K7", "mxint_quantize_kernel"))


def kernel_class(name: str) -> Optional[str]:
    """K1…K7 for a kernel of the port, None for any other device op
    (cuBLAS, cuSOLVER, PyTorch's own kernels, copies)."""
    if "qlr_tc_kernel" in name:
        m = _QLR.search(name)
        if m is None:
            return "K1/K2"
        return "K1" if m.group(2) == "true" else "K2"
    for cls, needle in KERNELS:
        if needle in name:
            return cls
    return None


@dataclasses.dataclass
class Summary:
    window: Tuple[float, float]                 # host clock, seconds
    ops: List[Tuple[str, float, float]]         # (name, start, duration)
    by_class: Dict[str, List[Tuple[float, float]]]
    busy_s: float

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def top_ops(self, n: int = 10) -> List[List]:
        tot: Dict[str, float] = {}
        for name, _, d in self.ops:
            tot[name] = tot.get(name, 0.0) + d
        return [[k[:120], v] for k, v in
                sorted(tot.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, label, n: int = 10) -> List[List]:
        """The ``n`` longest stretches with no device operation, each named
        by ``label(host_time)``: what the host was doing then."""
        gaps = []
        t = self.window[0]
        for _, s, d in sorted(self.ops, key=lambda o: o[1]):
            if s > t:
                gaps.append((s - t, t))
            t = max(t, s + d)
        if self.window[1] > t:
            gaps.append((self.window[1] - t, t))
        gaps.sort(reverse=True)
        return [[label(t0 + g / 2), g] for g, t0 in gaps[:n]]


def _union(intervals: List[Tuple[float, float]]) -> float:
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


class DeviceTrace:
    """``start()`` … ``stop()`` around a stretch of the window, at points
    where the card is idle (between engine steps or pass stages)."""

    def __init__(self, device):
        self.device = device
        self.on = False
        self._prof = None
        self._t0 = self._t1 = 0.0

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize(self.device)
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.start()
        torch.cuda.synchronize(self.device)
        self._t0 = time.perf_counter()
        torch.cuda._sleep(1000)                  # the clock marker
        torch.cuda.synchronize(self.device)
        self.on = True

    def stop(self) -> None:
        """End the recording; its events are read by ``summary()``, once
        the window has closed."""
        torch.cuda.synchronize(self.device)
        self._t1 = time.perf_counter()
        self._prof.stop()
        self.on = False

    def summary(self) -> Summary:
        t1 = self._t1
        cuda = torch.autograd.DeviceType.CUDA
        evs = sorted(((e.name, e.time_range.start, e.time_range.elapsed_us())
                      for e in self._prof.events()
                      if e.device_type == cuda and e.time_range.elapsed_us() > 0),
                     key=lambda e: e[1])
        self._prof = None
        if not evs:
            raise RuntimeError("the device trace holds no device operation: "
                               "torch.profiler recorded nothing on the card")
        marker = next((e for e in evs if "spin_kernel" in e[0]), evs[0])
        off = marker[1] / 1e6 - self._t0
        ops = [(n, s / 1e6 - off, d / 1e6) for n, s, d in evs
               if (n, s, d) != marker]
        by_class: Dict[str, List[Tuple[float, float]]] = {}
        for n, s, d in ops:
            cls = kernel_class(n)
            if cls is not None:
                by_class.setdefault(cls, []).append((s, d))
        busy = _union([(s, s + d) for _, s, d in ops])
        return Summary((self._t0, t1), ops, by_class, busy)
