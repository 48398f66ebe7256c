"""Runtime invariant sanitizer (port of ``repro/serve/sanitizer.py``).

``ServeConfig(sanitize=True)`` (CLI ``--sanitize``) audits the engine's
host bookkeeping against the device state it mirrors after every
``step()``. The invariants and their names are the JAX package's:

  * **committed** (``pos-monotonic``) — a request's committed token count
    never decreases (speculative rollback never un-commits a token);
  * **page-refcount conservation** (``refcount``) — every pool page is in
    exactly one of free/hot/cold, ``free + hot + cold == n_pages``, and
    each page's refcount equals its appearances across live block-table
    rows plus its parked reservation;
  * **block-table validity** (``block-table``) — each slot's device table
    row is its host page list padded with the slot's parked page, every
    entry a live page id, and a page shared by two rows is
    prefix-registered;
  * **prefix-cache agreement** (``prefix-cache``) — the radix tree and
    the pool's cached flags name the same page set;
  * **pos / slot_pos** (``pos``) — a decoding lane's device write position
    equals ``prompt_len + n_vision_tokens + generated - 1`` (a VLM's
    prefix holds the first positions), a mid-prefill lane's is at or
    past its chunk frontier, and (unpaged) no slot holds a position beyond
    it. (The JAX sanitizer wants a mid-prefill lane exactly at its
    frontier, which the lockstep decode of the other lanes breaks in any
    step that follows a non-final chunk with a decode: a false alarm.)
  * **packed4 alignment** (``int4-align``) — packed4 cache leaves hold
    ``page_size / 2`` (or, unpaged, half the layer's even-rounded slot
    count: ``max_len``, or ``min(window, max_len)`` on a local ring) byte
    rows on the slot axis.

The port's cache is a list of per-layer dicts (``models.attention``),
each layer with its own copy of the block table and positions; an
RG-LRU, mLSTM or sLSTM layer holds a ``pos`` and no K/V, so the ``pos``
checks read every layer and the K/V checks the layers with ``k``. Reads
only — a sanitized engine is token-identical to a bare one — but each
check copies the small block-table/pos tensors to the host, so it is a
smoke/debug tool. Violations raise :class:`SanitizerError` naming the
invariant.
"""
from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from repro_torch.kernels.constraints import PACKED4_ALIGN
from repro_torch.serve.telemetry import named_scope


class SanitizerError(AssertionError):
    """A serve-state invariant did not survive an engine step."""


def _fail(invariant: str, msg: str) -> None:
    raise SanitizerError(f"[sanitize:{invariant}] {msg}")


def _pos_layers(cache) -> Iterator[Tuple[str, Dict]]:
    """(path, layer dict) for every cache layer that carries a write
    position (attention, MLA and RG-LRU layers alike)."""
    for i, layer in enumerate(cache):
        if "pos" in layer:
            yield f"layers[{i}]", layer


def _attn_layers(cache) -> Iterator[Tuple[str, Dict]]:
    """(path, layer dict) for every cache layer that holds K/V pages."""
    for i, layer in enumerate(cache):
        if "k" in layer:
            yield f"layers[{i}]", layer


def _host(t: torch.Tensor) -> np.ndarray:
    with named_scope("sanitize"):
        return t.cpu().numpy()


class Sanitizer:
    """Stateful checker: holds per-request committed-token watermarks so
    rollback can never un-commit an emitted token."""

    def __init__(self):
        self._committed: Dict[int, int] = {}

    def check(self, engine) -> None:
        """Audit one engine against its device state; raises
        :class:`SanitizerError` on the first violated invariant."""
        if engine.sched is None:
            return
        self._check_committed(engine)
        if engine.sc.paged:
            self._check_pool(engine)
            self._check_tables(engine)
            self._check_prefix_cache(engine)
        self._check_pos(engine)
        if engine.sc.kv_dtype == "int4":
            self._check_packed4(engine)

    # ------------------------------------------------------------------
    def _check_committed(self, engine) -> None:
        live = {}
        for state in engine.sched.table.active.values():
            n = len(state.tokens)
            prev = self._committed.get(state.uid, 0)
            if n < prev:
                _fail("pos-monotonic",
                      f"request {state.uid}: committed tokens fell "
                      f"{prev} -> {n} (speculative rollback un-committed "
                      f"an emitted token)")
            live[state.uid] = n
        self._committed = live          # retired uids drop out

    # ------------------------------------------------------------------
    def _check_pool(self, engine) -> None:
        pool = engine.pool
        free = list(pool._free)
        cold = set(pool._cold)
        hot = [p for p in range(pool.n_pages) if pool._ref[p] > 0]
        if len(free) + len(hot) + len(cold) != pool.n_pages:
            _fail("refcount",
                  f"page partition leaks: free={len(free)} hot={len(hot)} "
                  f"cold={len(cold)} != n_pages={pool.n_pages}")
        for name, group in (("free", free), ("cold", cold)):
            for p in group:
                if pool._ref[p] != 0:
                    _fail("refcount",
                          f"{name} page {p} has refcount {pool._ref[p]}")
        for p in cold:
            if not pool._cached[p]:
                _fail("refcount", f"cold page {p} is not prefix-registered")
        if cold & set(free):
            _fail("refcount", f"pages both free and cold: {cold & set(free)}")
        # conservation: refcount == row occurrences + parked reservation
        expect = [0] * pool.n_pages
        for row in engine._row_pages.values():
            for p in row:
                expect[p] += 1
        for p in engine._parked:
            expect[p] += 1
        for p in range(pool.n_pages):
            if pool._ref[p] != expect[p]:
                _fail("refcount",
                      f"page {p}: refcount {pool._ref[p]} != {expect[p]} "
                      f"(block-table rows + parked)")

    # ------------------------------------------------------------------
    def _check_tables(self, engine) -> None:
        nb = engine.slots.n_blocks
        n_pages = engine.pool.n_pages
        shared: Dict[int, int] = {}
        for row in engine._row_pages.values():
            for p in set(row):
                shared[p] = shared.get(p, 0) + 1
        for p, owners in shared.items():
            if owners > 1 and not engine.pool._cached[p]:
                _fail("block-table",
                      f"page {p} aliased by {owners} rows without a "
                      f"prefix-cache registration")
        for path, layer in _attn_layers(engine.slots.cache):
            if "block_table" not in layer:
                continue
            bt = _host(layer["block_table"])
            if bt.min() < 0 or bt.max() >= n_pages:
                _fail("block-table",
                      f"{path}: entry out of range [0, {n_pages}): "
                      f"min={bt.min()} max={bt.max()}")
            for slot in range(bt.shape[0]):
                row = engine._row_pages.get(slot, [])
                want = row + [engine._parked[slot]] * (nb - len(row))
                got = bt[slot].tolist()
                if got != want:
                    _fail("block-table",
                          f"{path} slot {slot}: device row {got} != host "
                          f"mapping {want}")

    # ------------------------------------------------------------------
    def _check_prefix_cache(self, engine) -> None:
        """Radix tree ↔ ``PagePool._cached``: both sides name the same
        page set. A cached flag with no tree node can never be released;
        a node over an un-flagged page maps out pages the pool may
        recycle."""
        prefix, pool = engine.prefix, engine.pool
        if prefix is None:
            return
        tree = set(prefix._by_page)
        cached = {p for p in range(pool.n_pages) if pool._cached[p]}
        orphans = cached - tree
        if orphans:
            _fail("prefix-cache",
                  f"pages marked cached with no radix-tree node: "
                  f"{sorted(orphans)} — unreleasable without a tree owner")
        ghosts = tree - cached
        if ghosts:
            _fail("prefix-cache",
                  f"radix-tree nodes over pages the pool no longer marks "
                  f"cached: {sorted(ghosts)} — the tree would map out "
                  f"recyclable pages")

    # ------------------------------------------------------------------
    def _check_pos(self, engine) -> None:
        active = engine.sched.table.active
        jobs = engine._prefill_jobs if engine.sc.paged else {}
        n_vis = engine._n_vis
        for path, layer in _pos_layers(engine.slots.cache):
            pos = _host(layer["pos"])
            for slot, state in active.items():
                if slot in jobs:
                    # lockstep decode advances a mid-prefill lane's pos too
                    # (its writes land at or past the frontier, in slots the
                    # next chunk overwrites): pos may run ahead of the
                    # frontier, never behind it, where a write would clobber
                    # prefilled K/V
                    front = jobs[slot].next
                    if int(pos[slot]) < front:
                        _fail("pos",
                              f"{path} slot {slot} (uid {state.uid}): device "
                              f"pos {int(pos[slot])} is behind its "
                              f"mid-prefill frontier {front}")
                    continue
                if state.tokens:
                    want = state.prompt_len + n_vis + len(state.tokens) - 1
                    tag = (f"prompt {state.prompt_len} + vision {n_vis} "
                           f"+ generated {len(state.tokens)} - 1 = {want}")
                else:
                    continue                   # admitted, nothing emitted
                if int(pos[slot]) != want:
                    _fail("pos",
                          f"{path} slot {slot} (uid {state.uid}): device "
                          f"pos {int(pos[slot])} != {tag}")
            # parked lanes are not pinned: lockstep decode advances every
            # lane's pos; the parked row only reaches its private page
            # (_check_tables), and admission resets pos
            if "slot_pos" in layer and not engine.sc.paged:
                sp = _host(layer["slot_pos"])
                for slot in active:
                    bad = sp[slot][sp[slot] > int(pos[slot])]
                    if bad.size:
                        _fail("pos",
                              f"{path} slot {slot}: slot_pos holds positions "
                              f"{sorted(set(bad.tolist()))} beyond pos "
                              f"{int(pos[slot])}")

    # ------------------------------------------------------------------
    def _check_packed4(self, engine) -> None:
        sc = engine.sc
        for i, layer in enumerate(engine.slots.cache):
            if "k" not in layer:
                continue
            path = f"layers[{i}]"
            if sc.paged:
                span = engine.page_size
            else:
                span = (min(engine.cfg.window, sc.max_len)
                        if engine.model.blocks[i].kind == "local"
                        else sc.max_len)
                span += span % 2
            if span % PACKED4_ALIGN:
                _fail("int4-align", f"slot span {span} is not nibble-pair "
                                    f"aligned")
            for leaf in ("k", "v"):
                arr = layer.get(leaf)
                if arr is None or arr.dtype != torch.uint8:
                    continue
                if arr.shape[-2] * 2 != span:
                    _fail("int4-align",
                          f"{path}.{leaf}: packed slot axis {arr.shape[-2]} "
                          f"bytes != {span} logical slots / 2")
