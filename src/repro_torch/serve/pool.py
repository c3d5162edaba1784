"""PagePool — the serving stack's page allocator and prefix cache.

The part of ``repro.serve.pool`` that the port's engine calls (the port
imports nothing of the JAX package): the device tier only.  The host-RAM
tier (demotion, promotion, host eviction) and the preemption swap (park /
unpark) come with the slices that wire them into the engine; until then
the engine raises for ``host_pages>0`` and for priority traffic, and
eviction drops pages exactly as the JAX pool does with ``host_pages=0``.

``PagePool`` owns every page-level policy — allocation, refcounts, the
prefix trie, copy-on-write matching, eviction, byte-denominated budgeting —
behind a narrow interface, so the scheduling and orchestration layers
(``serve.scheduler``, ``serve.engine.ServeEngine``) can change without
touching it.  It is pure host-side bookkeeping over integer page ids: it
never sees a model, an array of KV data, or a device.  Device-side effects
(the COW page copy, the slot reset) remain the engine's job.

Interface (all O(pages) or better, no device imports):

- ``alloc(n)`` — pop ``n`` free pages (refcount 1 each), dropping LRU
  refcount-0 cached pages under pressure; raises if the demand can never
  be met (callers gate on ``available()`` first).
- ``share(pages)`` / ``release(pages)`` — refcount ++/--.  A released page
  stays RESIDENT if the prefix trie indexes it (the pool IS the cache) and
  returns to the free list otherwise.
- ``match_prefix(prompt)`` — longest cached prefix: full trie pages to map
  (refcounts untouched) plus an optional mid-page copy-on-write candidate.
- ``acquire(pages)`` — take one reference per matched page.
- ``index_page(node, key, page)`` — extend a cached chain by one full page
  as prefill passes each page boundary; returns the chain node, or ``None``
  when an equivalent page already owns the prefix.
- ``evict_one()`` / ``drop_cache()`` / ``available(pinned)`` — reclamation
  and admission-supply accounting.

Byte budgeting: ``kv_page_bytes`` / ``kv_bytes_per_token`` price a page (or
token) of paged KV across every global-attention layer for a storage dtype,
so budgets are BYTES, not page counts — an int8 pool holds ~``4·hd/(hd+4)``×
the float32 pages in the same bytes.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# storage costs of the paged KV pools: bytes per value, and the float32
# scale int8 pools keep per pool entry per KV head
KV_ITEMSIZE = {"float32": 4, "bfloat16": 2, "int8": 1}
KV_SCALE_BYTES = {"float32": 0, "bfloat16": 0, "int8": 4}


def kv_page_bytes(cfg, page_size: int, kv_dtype: str) -> int:
    """Bytes one pool page costs across ALL paged (global-attention) layers
    for a given storage dtype — K and V values plus, for int8, their scale
    rows.  The engine sizes its page budget with this: a pool budget is a
    BYTE budget, and int8 fits ~``4·hd/(hd+4)``× the pages of float32 in
    the same bytes."""
    isize = KV_ITEMSIZE[kv_dtype]
    sbytes = KV_SCALE_BYTES[kv_dtype]
    total = 0
    for st in cfg.stages:
        for blk in st.pattern:
            if blk.mixer == "attn" and blk.attn.window is None:
                kvH, hd = blk.attn.num_kv_heads, blk.attn.head_dim
                total += st.repeats * 2 * page_size * kvH * (hd * isize
                                                             + sbytes)
    return total


def kv_bytes_per_token(cfg, kv_dtype: str) -> int:
    """Bytes of paged-pool KV one token occupies (and one decode step must
    stream per context token) across all global-attention layers."""
    return kv_page_bytes(cfg, 1, kv_dtype)


class _PrefixNode:
    """One full page of prompt tokens in the prefix trie.

    ``children`` maps the NEXT page's token tuple to its node, so a cached
    prefix is a root-to-node chain of full pages.  Refcounts live in the
    pool's per-page array; a node is evictable when its page's refcount is
    0 and it has no children (leaf-first eviction keeps every cached chain
    reachable from the root — an active request holds refs on its whole
    matched path, so refcounts are monotone non-increasing down the trie)."""

    __slots__ = ("key", "page", "parent", "children", "last_used")

    def __init__(self, key: Optional[Tuple[int, ...]], page: int,
                 parent: Optional["_PrefixNode"]):
        self.key = key
        self.page = page
        self.parent = parent
        self.children: Dict[Tuple[int, ...], "_PrefixNode"] = {}
        self.last_used = 0


class PagePool:
    """Refcounted page allocator doubling as a prefix cache (see module
    docstring).  ``index_enabled=False`` degrades it to a plain FIFO page
    allocator: every match misses and released pages free immediately."""

    def __init__(self, n_pages: int, page_size: int, *,
                 index_enabled: bool = True):
        if n_pages < 0 or page_size < 1:
            raise ValueError(f"bad pool shape ({n_pages=}, {page_size=})")
        self.n_pages = n_pages
        self.page_size = page_size
        self.index_enabled = bool(index_enabled)
        self._free: List[int] = list(range(n_pages))
        self._ref = np.zeros(n_pages, np.int64)  # per-page refcounts
        self._root = _PrefixNode(None, -1, None)  # trie of cached prefixes
        self._page_node: Dict[int, _PrefixNode] = {}  # page -> trie node
        self._clock = 0  # LRU counter (bumped per touch)
        # the JAX pool's counters; those of the host tier and the
        # preemption swap stay 0 until those slices are ported
        self.stats = {"evictions": 0, "demotions": 0, "promotions": 0,
                      "host_evictions": 0, "park_demotions": 0,
                      "park_promotions": 0, "parks_dropped": 0}

    # -- introspection ----------------------------------------------------
    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def cached_pages(self) -> int:
        """Pages currently held by the prefix index."""
        return len(self._page_node)

    @property
    def pages_in_use(self) -> int:
        """Pages some live request currently holds (refcount > 0)."""
        return int((self._ref > 0).sum())

    @property
    def reclaimable_pages(self) -> int:
        """Free pages plus refcount-0 cached pages — the allocator can hand
        all of these out; equals ``n_pages`` whenever no page is pinned."""
        return len(self._free) + self.evictable()

    def evictable(self) -> int:
        """Cached pages reclaimable under pressure (refcount 0)."""
        return sum(1 for p in self._page_node if self._ref[p] == 0)

    def is_indexed(self, page: int) -> bool:
        """True when the prefix index owns ``page``.  Only full PROMPT pages
        are indexed, so a slot's decode and draft positions always land in
        pages for which this is False: a rejected draft tail can never
        touch an indexed prefix page (the engine asserts it when it packs
        drafts)."""
        return page in self._page_node

    def available(self, pinned: Sequence[int] = ()) -> int:
        """Pages an admission could obtain AFTER it pins ``pinned``: free +
        evictable, minus currently-refcount-0 cached pages the caller is
        about to hold — a page the request itself pins must not be counted
        as reclaimable supply for its own allocation."""
        held = sum(1 for p in set(pinned) if self._ref[p] == 0)
        return len(self._free) + self.evictable() - held

    # -- refcounts / allocation -------------------------------------------
    def alloc(self, n: int) -> List[int]:
        """Pop ``n`` pages, LRU-evicting cached refcount-0 pages as needed.
        Returned pages carry refcount 1 (the caller owns them)."""
        while len(self._free) < n:
            if not self.evict_one():
                raise RuntimeError(  # unreachable when callers gate on
                    "page pool exhausted with nothing evictable")  # available()
        out = [self._free.pop() for _ in range(n)]
        for p in out:
            self._ref[p] += 1
        return out

    def share(self, pages: Sequence[int]) -> None:
        """Add one reference per page (mapping cached pages into a slot)."""
        for p in pages:
            self._ref[p] += 1

    def release(self, pages: Sequence[int]) -> None:
        """Drop one reference per page.  Refcount-0 pages stay resident if
        the prefix trie indexes them (the pool IS the cache; eviction
        reclaims them under pressure) and are freed immediately otherwise."""
        for p in pages:
            self._ref[p] -= 1
            assert self._ref[p] >= 0, f"page {p} over-released"
            if self._ref[p] == 0 and p not in self._page_node:
                self._free.append(p)

    def acquire(self, pages: Sequence[int]) -> List[int]:
        """Take one reference per matched page; returns the page list.  (The
        JAX pool also promotes host-tier hits here.)"""
        self.share(pages)
        return list(pages)

    # -- prefix index -----------------------------------------------------
    def _walk_full_pages(self, prompt: np.ndarray):
        """Walk the trie one full page of ``prompt`` at a time, refreshing
        LRU recency; returns (last node, matched pages, matched tokens)."""
        P = self.page_size
        node, pages, matched = self._root, [], 0
        while matched + P <= len(prompt):
            child = node.children.get(
                tuple(int(t) for t in prompt[matched:matched + P]))
            if child is None:
                break
            child.last_used = self._clock
            node = child
            pages.append(child.page)
            matched += P
        return node, pages, matched

    def match_prefix(self, prompt: np.ndarray):
        """Longest cached prefix of ``prompt``: walk the trie a full page at
        a time, then probe the children of the last matched node for a
        partial-page hit (longest common prefix ≥ 1 token → COW candidate).

        Returns (node, pages, matched_tokens, cow) with ``pages`` the full
        shared pages IN CHAIN ORDER and ``cow`` either None or (src_page,
        extra_tokens).  Refcounts are NOT touched — the caller ``acquire``s
        what it keeps."""
        if not self.index_enabled:
            return self._root, [], 0, None
        self._clock += 1
        node, pages, matched = self._walk_full_pages(prompt)
        cow = None
        rem = prompt[matched:]
        if rem.size and node.children:
            best_len, best = 0, None
            for key, child in node.children.items():
                k = np.asarray(key[:rem.size], np.int32)
                lcp = int((np.cumprod(k == rem[:k.size]) if k.size else
                           np.zeros(0)).sum())
                if lcp > best_len:
                    best_len, best = lcp, child
            if best is not None:
                best.last_used = self._clock
                cow = (best.page, best_len)
        return node, pages, matched, cow

    def index_page(self, node: _PrefixNode, key: Tuple[int, ...],
                   page: int) -> Optional[_PrefixNode]:
        """Extend the cached chain at ``node`` with one full page.

        Returns the chain's new tip, or ``None`` when an EQUIVALENT page
        already owns this prefix (the caller's private duplicate stays out
        of the index and is freed at its release)."""
        if not self.index_enabled:
            return None
        child = node.children.get(key)
        if child is None:
            child = _PrefixNode(key, page, node)
            node.children[key] = child
            self._page_node[page] = child
        elif child.page != page:
            return None  # prefix owned elsewhere: stop indexing
        self._clock += 1
        child.last_used = self._clock
        return child

    # -- eviction ---------------------------------------------------------
    def evict_one(self) -> bool:
        """Drop the least-recently-used refcount-0 cached page with no
        children.  Leaf-first plus refcount monotonicity (active requests
        hold their whole matched path) means repetition drains any
        evictable subtree."""
        best = None
        stack = list(self._root.children.values())
        while stack:
            nd = stack.pop()
            stack.extend(nd.children.values())
            if self._ref[nd.page] != 0 or nd.children:
                continue
            if best is None or nd.last_used < best.last_used:
                best = nd
        if best is None:
            return False
        del best.parent.children[best.key]
        del self._page_node[best.page]
        self._free.append(best.page)
        self.stats["evictions"] += 1
        return True

    def drop_cache(self) -> int:
        """Discard every refcount-0 cached page (A/B runs, tests).  Returns
        the number of pages returned to the free list."""
        n = 0

        def drop(nd: _PrefixNode) -> None:
            nonlocal n
            for c in list(nd.children.values()):
                drop(c)
            if nd.children:
                return  # a kept (referenced) descendant pins the chain
            if self._ref[nd.page] == 0:
                del nd.parent.children[nd.key]
                del self._page_node[nd.page]
                self._free.append(nd.page)
                self.stats["evictions"] += 1
                n += 1

        for c in list(self._root.children.values()):
            drop(c)
        return n
