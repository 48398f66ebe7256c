"""Count one step's work: FLOPs, bytes, collective bytes, and each kernel
function's own (the port's counterpart of ``repro/launch/hlo_cost.py``).

The port has no HLO to parse: :func:`count` runs the step once under a
``TorchDispatchMode`` and adds up what it sees.

  * **aten ops**: FLOPs by ``torch.utils.flop_counter``'s formulas
    (matmuls, convolutions and attention; elementwise ops count no FLOP
    there). Bytes are each op's tensor operands plus its results — the
    *unfused* traffic, since eager PyTorch fuses nothing; a view moves no
    byte and an ``empty`` writes none. An op that reads or writes through
    an index (an embedding lookup, a cache write ``cache[rows, :, slot] =
    kv``) counts the rows it moves and its indices, not the whole tensor
    it indexes, as XLA counts a gather and a dynamic-update-slice.
    Backward ops are aten ops like any other.
  * **collectives** (``c10d`` / ``_c10d_functional`` ops): the result bytes
    of each, by kind, all-reduce counted twice in ``collective_bytes``
    (ring = reduce-scatter + all-gather), as ``repro/launch/roofline.py``
    counts them. They are not HBM bytes.
  * **kernel functions** K1–K7: each call is counted once by its own
    formula (:mod:`repro_torch.kernels.work`, re-exported here), and the
    aten ops inside it are not counted. The model records the call around
    *both* of its routes — the kernel wrapper (the CUDA kernel, or its
    plain version) and the ``fused="off"`` path — through
    ``kernels.work.kernel``, so the count is the same whichever route
    computes the function. The formulas read shapes and dtypes only,
    never a device value: where the work depends on the data (valid cache
    slots, expert rows that hold a token) the model's call counts every
    slot and every row, and ``chip_smoke.py`` passes the counts its data
    needs.

While no count runs, the hook on the serving path is one ``None`` check
before the call. Under a count that holds fake tensors (``launch.specs``),
every route computes nothing: the wrappers send fake and meta tensors to
their plain versions.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import work as _work
from repro_torch.kernels.work import (  # noqa: F401  (the formulas, here too)
    Work, attention_pairs, decode_attention_work, decode_slot_bytes,
    flash_attention_work, latent_decode_work, mxint_quantize_work,
    paged_decode_work, qlr_batched_work, qlr_work)

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")
_COLLECTIVE_NAMES = (("reduce_scatter", "reduce-scatter"),
                     ("allreduce", "all-reduce"), ("all_reduce", "all-reduce"),
                     ("allgather", "all-gather"), ("all_gather", "all-gather"),
                     ("alltoall", "all-to-all"), ("all_to_all", "all-to-all"),
                     ("send", "collective-permute"),
                     ("recv", "collective-permute"))
_NO_DATA = frozenset({"empty", "empty_like", "empty_strided", "new_empty",
                      "new_empty_strided", "lift_fresh"})
# ops that read or write a tensor through an index: the rows they move are
# their bytes, not the whole tensor they index (XLA's accounting of a
# gather and of a dynamic-update-slice); position of the index argument
_GATHERS = {"embedding": 1, "index": 1, "index_select": 2, "gather": 2}
_PUTS = {"index_put_": 1, "_index_put_impl_": 1, "index_copy_": 2,
         "scatter_": 2}


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _moved_bytes(name: str, args, out) -> int:
    """Bytes of an indexed op: its indices, and the rows it moves read
    once and written once (a gather's output; a put's region, the values
    broadcast over it)."""
    index = args[_GATHERS.get(name, _PUTS.get(name))]
    if name in _GATHERS:
        return _nbytes(index) + 2 * _nbytes(out)
    self = args[0]
    if name == "scatter_":
        region = index.numel()
    elif name == "index_copy_":
        region = args[3].numel()
    else:                       # index_put_: the indexed dims' broadcast
        lead = torch.broadcast_shapes(*(i.shape for i in index
                                        if i is not None))
        kept = [d for k, d in enumerate(self.shape)
                if k >= len(index) or index[k] is None]
        region = lead.numel() * max(1, torch.Size(kept).numel())
    return _nbytes(index) + 2 * region * self.element_size()


def _collective_kind(func) -> Optional[str]:
    """The collective kind of a ``c10d`` op ("" for one of no kind, such
    as a barrier or a broadcast); None for any other op."""
    if func.namespace not in ("c10d", "_c10d_functional"):
        return None
    name = func._schema.name.split("::")[-1]
    return next((kind for key, kind in _COLLECTIVE_NAMES if key in name), "")


class _Count(TorchDispatchMode):
    """The dispatch mode :func:`count` runs a step under."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.coll = {k: 0 for k in COLLECTIVES}
        self.by_kernel: Dict[str, Dict[str, float]] = {}
        self._inside = 0

    def kernel(self, work: Work, fn: Callable, args, kw):
        if self._inside:                 # a kernel function within one
            return fn(*args, **kw)
        rec = self.by_kernel.setdefault(
            work.name, {"calls": 0, "flops": 0.0, "bytes": 0.0})
        rec["calls"] += 1
        rec["flops"] += work.flops
        rec["bytes"] += work.bytes
        self.flops += work.flops
        self.bytes += work.bytes
        self._inside += 1
        try:
            return fn(*args, **kw)
        finally:
            self._inside -= 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._inside:
            return out
        kind = _collective_kind(func)
        if kind is not None:
            if kind:
                self.coll[kind] += _nbytes(out)
            return out
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        name = packet.__name__
        if name in _GATHERS or name in _PUTS:
            self.bytes += _moved_bytes(name, args, out)
        elif not func.is_view and name not in _NO_DATA:
            self.bytes += _nbytes((args, kwargs)) + _nbytes(out)
        return out


def fake_mode_of(tree):
    """The fake mode of the fake tensors in ``tree`` (models, dicts,
    lists, NamedTuples of tensors), or None where it holds none."""
    from torch._guards import detect_fake_mode

    from repro_torch.optim.tree import tree_leaves as model_leaves
    return detect_fake_mode([t for t in model_leaves(tree)
                             if isinstance(t, torch.Tensor)])


def count(fn: Callable, *args, **kwargs) -> Dict[str, Any]:
    """Run ``fn(*args, **kwargs)`` once and count its work: ``flops``,
    ``bytes``, ``coll_by_kind`` (result bytes of each collective kind),
    ``collective_bytes`` (their sum, all-reduce twice) — the keys of
    ``repro.launch.hlo_cost.analyze_text`` — and ``by_kernel``: each
    kernel function's calls, FLOPs and bytes. Arguments that hold fake
    tensors (``launch.specs``) run under their fake mode, so nothing is
    allocated or computed."""
    fake = fake_mode_of((args, kwargs))
    counter = _Count()
    before = _work.RECORDER
    with (fake if fake is not None else contextlib.nullcontext()), counter:
        _work.RECORDER = counter
        try:
            fn(*args, **kwargs)
        finally:
            _work.RECORDER = before
    return {"flops": counter.flops, "bytes": counter.bytes,
            "coll_by_kind": dict(counter.coll),
            "collective_bytes": sum(counter.coll.values())
            + counter.coll["all-reduce"],
            "by_kernel": counter.by_kernel}
