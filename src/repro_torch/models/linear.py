"""Linear layers of the port: every projection routes through :func:`linear`.

The layer's module type is its execution mode, as the params-dict schema
is in ``repro/models/linear.py``:

  FpLinear : ``w`` (m, n) [, ``b`` (n,)]                  — full precision
  QLinear  : ``codes`` int8 (m_pad, n) or ``packed`` uint8 (m_pad/2, n),
             ``scale`` (m_pad/32, n), ``l`` (m, r), ``r`` (r, n),
             ``gscale`` (r,) [, ``b``]                      — Q + LR serving

``m_pad`` rounds the input dim up to the MXINT block; ``l`` keeps the
true row count, and the padding rows are zero-padded on the fly.

An expert stack (``models.moe``) is the same two modules with a leading
expert axis on every buffer: ``w`` (E, m, n); ``codes`` (E, m_pad, n) or
``packed`` (E, m_pad/2, n), ``scale`` (E, m_pad/32, n), ``l`` (E, m, r),
``r`` (E, r, n), ``gscale`` (E, r) [, ``b`` (E, n)]. :func:`linear_stack`
applies one to an (E, C, m) dispatch buffer.

``Ctx.tap`` turns on calibration capture: every ``FpLinear`` then
records its input's moments under ``ctx.prefix + name`` (the tap names
of ``repro/models/linear.py``), and projections fed the very same input
tensor share one :class:`~repro_torch.core.api.CalibStats`.

``Ctx.fused`` picks the Q + LR path: ``"auto"`` and ``"on"`` both go
through :func:`repro_torch.kernels.mxint_matmul.qlr_matmul`, which
launches K1/K2 on a CUDA tensor and runs their plain version on a CPU
tensor (an int8 expert stack: :func:`~repro_torch.kernels.mxint_matmul.
qlr_matmul_batched`, K6); ``"off"`` keeps the dequantize-then-matmul
baseline. Either way the call is one K1/K2 (K6) function to
:func:`repro_torch.launch.cost.count`, recorded around both routes.

``Ctx.draft`` is self-speculative decoding's Q-only draft: :func:`linear`
slices a ``QLinear``'s ``l``/``r`` to rank 0, so the draft runs the same
code on the same resident weights with the low-rank correction skipped.
:func:`linear_stack` does not slice, as the JAX expert path never reads
the flag: an MoE model's routed experts keep their LR in the draft.
``step_parity`` and ``chunk_store`` steer chunk attention for the
speculative verify (``models.attention.attention_chunk``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional

import torch
from torch import nn

from repro_torch.core.api import CalibStats
from repro_torch.kernels import work
from repro_torch.kernels.mxint_matmul import (dequant_blockwise, qlr_matmul,
                                              qlr_matmul_batched)
from repro_torch.quant.mxint import unpack_codes_4bit


@dataclasses.dataclass
class Ctx:
    """Per-call model context."""

    compute_dtype: torch.dtype = torch.float32
    fused: str = "auto"                           # Q+LR matmul: auto|on|off
    draft: bool = False                           # Q-only (skip the LR sliver)
    step_parity: bool = False                     # chunk attention reads its
    # own K/V through the storage quantizer round trip, as a decode step
    chunk_store: bool = True                      # False: chunk attention
    # writes nothing into the cache (a read-only speculative verify)
    # MoE routing probes (``models.moe``): each MoE layer appends its
    # (T, top_k) expert choice to ``route_log``, and takes it from
    # ``route_replay`` instead of its own top-k when that is set — so two
    # lowerings can be compared under one routing
    route_log: Optional[List[torch.Tensor]] = None
    route_replay: Optional[Iterator[torch.Tensor]] = None
    # each MoE layer appends its load-balance term (``lm_loss``)
    aux_log: Optional[List[torch.Tensor]] = None
    # MLA decode's dense up-projections, {mixer: (W_uk, W_uv)} f32, built
    # once per engine (``models.attention.absorb_mla_weights``); a mixer
    # not in it materializes them in the step
    absorbed: Optional[Dict[nn.Module, tuple]] = None
    tap: Optional[Dict[str, CalibStats]] = None   # calibration capture
    prefix: str = ""                              # per-layer tap namespace
    autocorr: bool = True                         # capture Σxxᵀ moments
    # the input last recorded and the moments it went into
    _last: Optional[tuple] = dataclasses.field(default=None, init=False,
                                               repr=False)

    def record(self, name: str, x: torch.Tensor, m: int) -> None:
        """Add ``x`` (..., m) to the moments of ``prefix + name``. An
        input that is the very tensor the last record took (wq/wk/wv,
        up/gate) shares that record's moments instead of summing the
        same rows again."""
        if self.tap is None:
            return
        name = self.prefix + name
        st = self.tap.get(name)
        if self._last is not None and self._last[0] is x \
                and st in (None, self._last[1]):
            self.tap[name] = self._last[1]
            return
        if st is None:
            st = self.tap[name] = CalibStats.init(m, self.autocorr, x.device)
        self._last = (x, st.update(x))


class FpLinear(nn.Module):
    """Full-precision projection ``y = x @ w (+ b)``."""

    def __init__(self, w: torch.Tensor, b: Optional[torch.Tensor] = None):
        super().__init__()
        self.register_buffer("w", w)
        self.register_buffer("b", b)


class QLinear(nn.Module):
    """Q + LR projection: MXINT codes (int8 or packed4) with per-block
    power-of-two scales, plus the rank-r correction ``l @ r``."""

    def __init__(self, scale: torch.Tensor, l: torch.Tensor, r: torch.Tensor,
                 *, codes: Optional[torch.Tensor] = None,
                 packed: Optional[torch.Tensor] = None,
                 gscale: Optional[torch.Tensor] = None,
                 b: Optional[torch.Tensor] = None):
        super().__init__()
        if (codes is None) == (packed is None):
            raise ValueError("QLinear takes exactly one of codes / packed")
        self.register_buffer("codes", codes)
        self.register_buffer("packed", packed)
        self.register_buffer("scale", scale)
        self.register_buffer("l", l)
        self.register_buffer("r", r)
        self.register_buffer("gscale", gscale)
        self.register_buffer("b", b)


def fused_mode(ctx: Ctx) -> str:
    """Resolve ``ctx.fused``: ``"kernel"`` (the kernel wrappers — K1/K2 on
    CUDA tensors, their plain version on CPU tensors) or ``"off"``."""
    if ctx.fused == "off":
        return "off"
    if ctx.fused not in ("auto", "on"):
        raise ValueError(f"ctx.fused must be auto|on|off, got {ctx.fused!r}")
    return "kernel"


def dequant_weight(p: QLinear, dtype) -> torch.Tensor:
    """Materialize the quantized backbone (the ``fused="off"`` path),
    sliced back to the true input dim; an expert stack dequantizes over
    its leading axis."""
    codes = unpack_codes_4bit(p.packed) if p.packed is not None else p.codes
    w = dequant_blockwise(codes, p.scale, dtype)
    return w[..., : p.l.shape[-2], :]


def weight_of(p: nn.Module, dtype) -> torch.Tensor:
    """The matrix ``W ≈ dequant(Q) + L·R`` of any projection (``w`` of an
    ``FpLinear``), as ``repro/models/linear.py::weight_of``: where an
    algorithm needs the matrix itself (MLA's absorbed decode)."""
    if isinstance(p, FpLinear):
        return p.w.to(dtype)
    w = dequant_weight(p, dtype)
    if p.l.shape[-1] > 0:
        w = w + p.l.to(dtype) @ p.r.to(dtype)
    return w


def _fused_qlr(p: QLinear, x: torch.Tensor, l: torch.Tensor,
               r: torch.Tensor) -> torch.Tensor:
    """One quantized projection through the Q + LR matmul, padding x and
    l with zeros up to the MXINT-padded code rows."""
    if p.packed is not None:
        codes, rows = p.packed, p.packed.shape[0] * 2
    else:
        codes, rows = p.codes, p.codes.shape[0]
    pad = rows - x.shape[-1]
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
        l = torch.nn.functional.pad(l, (0, 0, 0, pad))
    return qlr_matmul(x, codes, p.scale, l, r)


def linear(ctx: Ctx, p: nn.Module, x: torch.Tensor,
           name: str = "") -> torch.Tensor:
    """``y = x @ W (+ b)``, dispatching on the layer type; with
    ``ctx.tap`` set an ``FpLinear`` records ``x`` under ``name``; under
    ``ctx.draft`` a ``QLinear`` runs at rank 0 (Q alone)."""
    dt = ctx.compute_dtype
    if isinstance(p, FpLinear):
        if ctx.tap is not None:
            ctx.record(name, x, p.w.shape[0])
        y = x.to(dt) @ p.w.to(dt)
    else:
        l, r = (p.l[:, :0], p.r[:0]) if ctx.draft else (p.l, p.r)
        y = work.kernel(lambda: _qlr_work(p, x, r.shape[0], dt), _qlr, ctx,
                        p, x, l, r)
    if p.b is not None:
        y = y + p.b.to(dt)
    return y


def _qlr(ctx: Ctx, p: QLinear, x: torch.Tensor, l: torch.Tensor,
         r: torch.Tensor) -> torch.Tensor:
    """K1/K2's function by the route ``ctx.fused`` picks: the kernel
    wrapper, or dequantize-then-matmul."""
    dt = ctx.compute_dtype
    if fused_mode(ctx) != "off":
        return _fused_qlr(p, x.to(dt), l, r)
    y = x.to(dt) @ dequant_weight(p, dt)
    if l.shape[1] > 0:
        y = y + (x.to(dt) @ l.to(dt)) @ r.to(dt)
    return y


def _qlr_work(p: QLinear, x: torch.Tensor, rank: int, dt) -> work.Work:
    """K1/K2's work for ``x`` through ``p`` (the MXINT-padded rows)."""
    packed = p.packed is not None
    rows = p.packed.shape[-2] * 2 if packed else p.codes.shape[-2]
    return work.qlr_work(x.numel() // x.shape[-1], rows, p.scale.shape[-1],
                         rank, x_itemsize=dt.itemsize, packed=packed)


def _fused_qlr_stack(p: QLinear, x: torch.Tensor,
                     counts: Optional[torch.Tensor]) -> torch.Tensor:
    """An int8 expert stack through the batched Q + LR matmul, padding x
    and l with zeros up to the MXINT-padded code rows."""
    l = p.l
    pad = p.codes.shape[-2] - x.shape[-1]
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
        l = torch.nn.functional.pad(l, (0, 0, 0, pad))
    return qlr_matmul_batched(x, p.codes, p.scale, l, p.r, counts)


def linear_stack(ctx: Ctx, p: nn.Module, x: torch.Tensor,
                 counts: Optional[torch.Tensor]) -> torch.Tensor:
    """``y[e] = x[e] @ W[e] (+ b[e])`` for an expert stack and ``x`` (E, C,
    m). int8 stacks under the kernel mode take the batched Q + LR matmul
    (K6 on the card), which skips the rows of entry ``e`` at or past
    ``counts[e]`` ((E,) int32: rows that hold no token, zero in ``x``) and
    returns them as zeros (plus the bias); fp stacks, packed4 stacks and
    ``fused="off"`` ignore ``counts`` and take one batched matmul on the
    dequantized stack, as the JAX package's ``vmap`` of
    dequantize-then-matmul does. ``ctx.draft`` is ignored: the stack
    keeps its low-rank correction, as in the JAX expert path."""
    dt = ctx.compute_dtype
    xd = x.to(dt)
    if isinstance(p, FpLinear):
        y = torch.bmm(xd, p.w.to(dt))
    elif p.codes is not None:
        y = work.kernel(lambda: work.qlr_batched_work(
            *xd.shape[:2], p.codes.shape[-2], p.codes.shape[-1],
            p.r.shape[-2], x_itemsize=dt.itemsize,
            counts=counts is not None), _int8_stack, ctx, p, xd, counts)
    else:
        y = _dequant_stack(p, xd, dt)
    if p.b is not None:
        y = y + p.b.to(dt)[:, None, :]
    return y


def _int8_stack(ctx: Ctx, p: QLinear, xd: torch.Tensor,
                counts: Optional[torch.Tensor]) -> torch.Tensor:
    """K6's function by the route ``ctx.fused`` picks."""
    if fused_mode(ctx) != "off":
        return _fused_qlr_stack(p, xd, counts)
    return _dequant_stack(p, xd, ctx.compute_dtype)


def _dequant_stack(p: QLinear, xd: torch.Tensor, dt) -> torch.Tensor:
    y = torch.bmm(xd, dequant_weight(p, dt))
    if p.l.shape[-1] > 0:
        y = y + torch.bmm(torch.bmm(xd, p.l.to(dt)), p.r.to(dt))
    return y
