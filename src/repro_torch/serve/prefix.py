"""Automatic prefix caching: a radix tree over token-block hashes (port of
``repro/serve/prefix.py``).

With the paged KV cache (``serve.pages``) a prefix that was prefilled
once is a run of physical pages, so a new request whose prompt starts
with the same tokens maps those pages into its block table (refcount
bump) and skips their prefill compute.

The index is a radix tree at **block granularity**: each edge consumes
exactly ``page_size`` tokens (their bytes are the child key) and each
node owns one physical page. Only *full* prompt blocks enter the tree —
a partial tail block also holds the request's decode tokens, so it is
never shareable — and matching is capped by the caller so at least one
prompt token is always recomputed (the engine needs the last-token
logits to pick the first output token).

Invariants (``tests/test_torch_paged.py`` holds the decisions equal to
the JAX package's):

  * a node's page outlives the node: pages enter via ``insert`` (owner
    still holds a ref), go *cold* in the pool when the owner retires,
    are revived by ``match`` (incref), and leave the tree only through
    pool eviction (LRU);
  * a matched path is ref'd root-to-leaf, so a hot node's ancestors are
    hot — eviction of a cold node can therefore drop the whole subtree
    (descendants are cold too) without stranding a live request;
  * ``match`` never returns a page the pool could evict mid-request:
    the incref happens inside the match walk.

A copy, not an import: ``repro.serve`` imports JAX.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from repro_torch.serve.pages import PagePool


class _Node:
    __slots__ = ("children", "parent", "key", "page")

    def __init__(self, parent: Optional["_Node"], key: Optional[bytes],
                 page: Optional[int]):
        self.children: Dict[bytes, _Node] = {}
        self.parent = parent
        self.key = key
        self.page = page


def _block_key(tokens: np.ndarray) -> bytes:
    return np.ascontiguousarray(tokens, np.int32).tobytes()


class RadixPrefixCache:
    """Block-granular prefix index over a :class:`PagePool`."""

    def __init__(self, pool: PagePool):
        self.pool = pool
        self.page_size = pool.page_size
        self.root = _Node(None, None, None)
        self._by_page: Dict[int, _Node] = {}
        pool.evict_hook = self._on_evict
        # counters (the engine surfaces these via stats())
        self.queries = 0
        self.hit_blocks = 0
        self.miss_blocks = 0
        self.inserted_blocks = 0

    # ------------------------------------------------------------------
    @property
    def n_blocks(self) -> int:
        return len(self._by_page)

    def match(self, tokens: np.ndarray, max_blocks: int) -> List[int]:
        """Longest cached block-prefix of ``tokens``, at most
        ``max_blocks`` blocks. Returns the physical pages root-to-leaf,
        **already incref'd** — the caller owns one reference per page
        and releases them all at retirement."""
        self.queries += 1
        ps = self.page_size
        node = self.root
        pages: List[int] = []
        n_full = min(max_blocks, len(tokens) // ps)
        for i in range(n_full):
            child = node.children.get(_block_key(tokens[i * ps:(i + 1) * ps]))
            if child is None:
                break
            pages.append(child.page)
            node = child
        self.pool.incref(pages)
        self.hit_blocks += len(pages)
        self.miss_blocks += n_full - len(pages)
        return pages

    def release_match(self, pages: List[int], n_queried: int) -> None:
        """Undo a :meth:`match` whose admission was deferred (pool
        pressure): drop the references *and* the query counters, so a
        request retried N times doesn't inflate the hit stats N-fold.
        ``n_queried`` is the block cap the match was given (the engine's
        ``(len(prompt) - 1) // page_size``)."""
        self.pool.decref(pages)
        self.queries -= 1
        self.hit_blocks -= len(pages)
        self.miss_blocks -= n_queried - len(pages)

    def insert(self, tokens: np.ndarray, pages: List[int]) -> int:
        """Register a prefilled prompt's full blocks: ``pages[i]`` holds
        the KV of tokens ``[i*ps, (i+1)*ps)``. Blocks already in the
        tree keep their incumbent page (the duplicate page stays private
        to its request and frees on retirement); new blocks take tree
        ownership of the page (``pool.mark_cached``). Returns the number
        of newly registered blocks."""
        ps = self.page_size
        node = self.root
        added = 0
        for i, page in enumerate(pages):
            key = _block_key(tokens[i * ps:(i + 1) * ps])
            child = node.children.get(key)
            if child is None:
                child = _Node(node, key, page)
                node.children[key] = child
                self._by_page[page] = child
                self.pool.mark_cached(page)
                added += 1
            node = child
        self.inserted_blocks += added
        return added

    # ------------------------------------------------------------------
    def _on_evict(self, page: int) -> None:
        """Pool reclaimed a cold page: drop its node and the whole
        subtree (all cold — see module invariants), releasing the
        subtree's pages back to the pool."""
        node = self._by_page.get(page)
        if node is None:
            return
        if node.parent is not None:
            node.parent.children.pop(node.key, None)
        stack = [node]
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            n.children.clear()
            if n.page is not None:
                self._by_page.pop(n.page, None)
                self.pool.release_cached(n.page)

    def stats(self) -> Dict[str, int]:
        return {"prefix_queries": self.queries,
                "prefix_hit_blocks": self.hit_blocks,
                "prefix_miss_blocks": self.miss_blocks,
                "prefix_cached_blocks": self.n_blocks,
                "prefix_inserted_blocks": self.inserted_blocks}

    def publish(self, reg) -> None:
        """Publish the prefix-cache series into a telemetry registry
        (names match the ``stats()`` keys)."""
        reg.counter("prefix_queries", "prefix-cache match walks"
                    ).set(self.queries)
        reg.counter("prefix_hit_blocks", "blocks served from the tree"
                    ).set(self.hit_blocks)
        reg.counter("prefix_miss_blocks", "full blocks walked but absent"
                    ).set(self.miss_blocks)
        reg.gauge("prefix_cached_blocks", "blocks currently in the tree"
                  ).set(self.n_blocks)
        reg.counter("prefix_inserted_blocks", "blocks registered"
                    ).set(self.inserted_blocks)

    def reset_stats(self) -> None:
        self.queries = self.hit_blocks = 0
        self.miss_blocks = self.inserted_blocks = 0
