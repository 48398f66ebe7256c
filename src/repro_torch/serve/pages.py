"""Paged KV cache: block-granular page pool + per-slot block tables (port
of ``repro/serve/pages.py``).

The slot cache (``serve.slots``) backs every request with a contiguous
``max_len`` row. This module replaces the row substrate with the layout
production serving uses:

  * on the device, each attention layer's K/V live in a **page pool**
    ``(n_pages, KV, page_size, hd)`` (packed4 int4: ``(n_pages, KV,
    page_size/2, hd)`` uint8; int8/int4 scales ``(n_pages, KV,
    page_size)``) and every slot row carries a **block table**
    ``(B, n_blocks)`` of physical page ids. Decode attention follows the
    indirection (``kernels.decode_attention.decode_attention_op(
    block_table=...)``, K5 on the card); admission never copies a row,
    it rewrites the slot's table row in place;
  * on the host, :class:`PagePool` is the ref-counted allocator: a free
    list for virgin pages plus an LRU **cold set** of pages whose
    refcount dropped to zero but which still back a radix-tree prefix
    block (``serve.prefix``). Allocation under pressure evicts cold pages
    LRU-first, telling the tree to drop the backing nodes.

Page size must be **even** so the int4 packed container's nibble pairs
(two slots per byte) never straddle a page
(``kernels.constraints.validate_page_size``).

Every block-table entry always holds a *valid* physical page id: entries
past a slot's allocation point at the slot's **parked page** (one
permanently-allocated, never-shared page per slot), so the decode step's
unconditional per-row cache write lands somewhere harmless for retired
or still-prefilling rows instead of corrupting a page another request
owns. The engine re-points a row at its parked page on retirement.

A copy, not an import: ``repro.serve`` imports JAX.
"""
from __future__ import annotations

import collections
from typing import Callable, Dict, List, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.constraints import validate_page_size
from repro_torch.models.transformer import init_cache
from repro_torch.serve.slots import KV_DTYPES


# ==========================================================================
# Host-side allocator
# ==========================================================================
class PagePool:
    """Ref-counted physical-page allocator with LRU eviction.

    Page states (disjoint):
      * **free** — on the free list, content garbage;
      * **hot**  — refcount ≥ 1 (owned by ≥ 1 live request, and/or just
        revived by a prefix match);
      * **cold** — refcount 0 but still registered as a radix-tree
        prefix block: content stays valid and a future prefix match can
        revive it (``incref``). Cold pages are the eviction pool, oldest
        first.

    ``evict_hook(page)`` — installed by :class:`~repro_torch.serve.
    prefix.RadixPrefixCache` — is called when a cold page is reclaimed so
    the tree drops the node (and its subtree, whose pages are released
    back here via :meth:`release_cached`).
    """

    def __init__(self, n_pages: int, page_size: int):
        validate_page_size(page_size)
        self.n_pages = n_pages
        self.page_size = page_size
        self._free: collections.deque = collections.deque(range(n_pages))
        self._ref = [0] * n_pages
        self._cached = [False] * n_pages      # backs a radix-tree node
        self._cold: "collections.OrderedDict[int, None]" = \
            collections.OrderedDict()          # refcount-0 cached, LRU order
        self.evict_hook: Optional[Callable[[int], None]] = None
        self.evictions = 0
        self.watermark_evictions = 0
        self.allocated = 0

    # ------------------------------------------------------------------
    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_cold(self) -> int:
        return len(self._cold)

    @property
    def n_hot(self) -> int:
        return self.n_pages - self.n_free - self.n_cold

    # ------------------------------------------------------------------
    def alloc(self, n: int) -> Optional[List[int]]:
        """``n`` fresh pages at refcount 1, evicting cold prefix pages
        LRU-first if the free list runs dry. Returns None (no state
        change) when free + cold cannot cover the request — the caller
        defers admission until live requests retire."""
        if n > len(self._free) + len(self._cold):
            return None
        out: List[int] = []
        while len(out) < n:
            if self._free:
                p = self._free.popleft()
            else:
                # oldest cold page; the tree drops its node + subtree
                # (subtree pages are cold too — a hot descendant would
                # hold refs on every ancestor — and come back via
                # release_cached, growing the free list mid-loop)
                p, _ = self._cold.popitem(last=False)
                self._cached[p] = False
                self.evictions += 1
                if self.evict_hook is not None:
                    self.evict_hook(p)
            self._ref[p] = 1
            out.append(p)
        self.allocated += n
        return out

    def ensure_free(self, min_free: int) -> int:
        """Watermark eviction: reclaim cold prefix pages LRU-first until
        at least ``min_free`` pages sit on the free list (or the cold
        set runs dry), ahead of demand, so a burst of admissions finds a
        drained free list. Returns the number of pages evicted."""
        n = 0
        while len(self._free) < min_free and self._cold:
            p, _ = self._cold.popitem(last=False)
            self._cached[p] = False
            self.evictions += 1
            self.watermark_evictions += 1
            if self.evict_hook is not None:
                # the hook releases the node's subtree via
                # release_cached (those pages are cold too and join the
                # free list); p itself is already un-cached so the
                # hook's own release of it is a no-op
                self.evict_hook(p)
            self._free.append(p)
            n += 1
        return n

    def incref(self, pages: List[int]) -> None:
        """Revive/share pages (prefix-cache hit): cold pages leave the
        eviction pool."""
        for p in pages:
            if self._ref[p] == 0:
                self._cold.pop(p, None)
            self._ref[p] += 1

    def decref(self, pages: List[int]) -> None:
        """Release one reference per page. A page reaching refcount 0
        goes cold (retained, evictable) if it backs a radix-tree block,
        else straight back to the free list."""
        for p in pages:
            if self._ref[p] <= 0:
                raise RuntimeError(f"double free of page {p}")
            self._ref[p] -= 1
            if self._ref[p] == 0:
                if self._cached[p]:
                    self._cold[p] = None          # MRU end of the LRU
                else:
                    self._free.append(p)

    # ------------------------------------------------------------------
    def mark_cached(self, page: int) -> None:
        """The radix tree took a node over this page (refcount stays the
        owner's; the page just becomes retainable-after-release)."""
        self._cached[page] = True

    def release_cached(self, page: int) -> None:
        """The radix tree dropped this page's node (subtree of an
        eviction): no longer retainable; free it if unreferenced."""
        if not self._cached[page]:
            return
        self._cached[page] = False
        if self._ref[page] == 0:
            self._cold.pop(page, None)
            self._free.append(page)

    def refcount(self, page: int) -> int:
        return self._ref[page]

    def stats(self) -> Dict[str, int]:
        return {"pages_total": self.n_pages, "pages_free": self.n_free,
                "pages_cold": self.n_cold, "pages_hot": self.n_hot,
                "evictions": self.evictions,
                "watermark_evictions": self.watermark_evictions,
                "page_allocs": self.allocated}

    def publish(self, reg) -> None:
        """Publish the page-pool series into a telemetry registry (names
        match the ``stats()`` keys)."""
        reg.gauge("pages_total", "physical pages in the pool"
                  ).set(self.n_pages)
        reg.gauge("pages_free", "virgin pages on the free list"
                  ).set(self.n_free)
        reg.gauge("pages_cold", "refcount-0 prefix-retained pages"
                  ).set(self.n_cold)
        reg.gauge("pages_hot", "pages owned by live requests"
                  ).set(self.n_hot)
        reg.counter("evictions", "cold prefix pages reclaimed under "
                    "pressure").set(self.evictions)
        reg.counter("watermark_evictions", "cold prefix pages reclaimed "
                    "ahead of demand by the free watermark"
                    ).set(self.watermark_evictions)
        reg.counter("page_allocs", "pages handed out").set(self.allocated)

    def reset_stats(self) -> None:
        self.evictions = 0
        self.watermark_evictions = 0
        self.allocated = 0


# ==========================================================================
# Device-side paged cache
# ==========================================================================
def set_block_table_row(cache: List[Dict], slot: int, row: torch.Tensor,
                        pos: int) -> None:
    """Point slot ``slot`` of every layer at physical pages ``row``
    (n_blocks,) int32 with write position ``pos``, in place."""
    for layer in cache:
        layer["block_table"][slot] = row
        layer["pos"][slot] = pos


class PagedKVCache:
    """Device page pools + block tables for ``n_slots`` decode lanes.

    The pools are allocated by ``models.init_cache(pages=, page_size=)``,
    one ``(n_pages, KV, page_size, hd)`` pool per layer, each layer with
    its own copy of the block tables. Admission and retirement rewrite
    one slot's table row (:func:`set_block_table_row`): there is no row
    copy and no per-request prefill cache template.
    """

    def __init__(self, cfg: ModelConfig, n_slots: int, max_len: int,
                 kv_dtype: str, page_size: int, n_pages: int, device):
        self.n_slots = n_slots
        self.page_size = page_size
        self.n_pages = n_pages
        self.n_blocks = -(-max_len // page_size)
        self.device = device
        self.cache = init_cache(cfg, n_slots, max_len, KV_DTYPES[kv_dtype],
                                device, pages=n_pages, page_size=page_size)

    def set_row(self, slot: int, pages: List[int], pos: int) -> None:
        """Map a slot's logical blocks onto physical ``pages`` (padded
        to n_blocks by the caller, with the slot's parked page) and reset
        its write position."""
        if len(pages) != self.n_blocks:
            raise ValueError(f"block table row needs {self.n_blocks} "
                             f"entries, got {len(pages)}")
        row = torch.tensor(pages, dtype=torch.int32).to(self.device)
        set_block_table_row(self.cache, slot, row, pos)
