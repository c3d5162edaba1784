"""PagePool — the serving stack's two-tier page allocator and prefix cache.

A copy of ``repro.serve.pool`` (the port imports nothing of the JAX
package): the same policies over the same integer page ids, so that for one
sequence of calls both pools make the same decisions and emit the same
events.

``PagePool`` owns every page-level policy — allocation, refcounts, the
prefix trie, copy-on-write matching, tiered eviction, byte-denominated
budgeting — behind a narrow interface, so the scheduling and orchestration
layers (``serve.scheduler``, ``serve.engine.ServeEngine``) can change
without touching it.  It is pure host-side bookkeeping: it never sees a
model, a tensor of KV data, or a device.  Device-side effects (the COW page
copy, the slot reset, the page movers the ``events`` log asks for) remain
the engine's job; the pool only decides WHICH pages move WHERE.

**Tiers.**  The DEVICE tier is ``n_pages`` pages of pool memory; an
optional HOST tier (``host_pages`` slots of host RAM) catches what pressure
pushes out.  A page's life is alloc → (release) → demote → promote →
preempt (park) → resume (unpark) → free:

- **Demotion** — under allocation pressure the LRU refcount-0 device node
  with no device children moves its page to a host slot instead of being
  dropped.  Its trie entry survives under the encoded id ``n_pages +
  slot``, so the prefix stays matchable; a ("demote", page, slot) event
  tells the engine to copy the page's bytes (values and int8 scale rows)
  to host storage before the device page is reused.
- **Promotion** — ``acquire`` of a matched host-tier page allocates a
  device page (possibly demoting another), returns the trie entry to the
  device tier and emits ("promote", slot, page).
- **Host eviction** — making room in a full host tier drops its LRU
  childless node (("hevict", slot)).  Only a miss in BOTH tiers pays a
  full re-prefill.
- **Preemption** — ``park`` moves a preempted slot's PRIVATE pages
  (refcount 1, not indexed) to host slots held outside the trie, through
  the same "demote" events; ``unpark`` brings them back ("promote") and
  ``drop_parked`` abandons them ("hevict").  A park is all or nothing, and
  cache traffic never evicts a parked slot.

Interface (all O(pages) or better, no device imports):

- ``alloc(n)`` / ``share(pages)`` / ``release(pages)`` — allocation and
  refcounts; a released page stays RESIDENT if the trie indexes it.
- ``match_prefix(prompt)`` — longest cached prefix across both tiers (host
  hits as encoded ids) and an optional mid-page copy-on-write candidate;
  ``acquire(pages)`` references it, promoting the host hits.
- ``index_page(node, key, page)`` — extend a cached chain by one page.
- ``probe_prefix_len`` / ``probe_prefix_split`` — non-mutating probes for
  schedulers: cached tokens in total, or split (device, host).
- ``park`` / ``unpark`` / ``drop_parked`` — the preemption swap.
- ``evict_one()`` / ``drop_cache()`` / ``storm_host_cache()`` /
  ``available(pinned)`` — reclamation and admission-supply accounting;
  ``drain_events()`` hands over the chronological demote/promote/hevict
  log, which the engine applies in order.

Byte budgeting: ``kv_page_bytes`` / ``kv_bytes_per_token`` price a page (or
token) of paged KV across every global-attention layer for a storage dtype,
so budgets are BYTES, not page counts — an int8 pool holds ~``4·hd/(hd+4)``×
the float32 pages in the same bytes.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# storage costs of the paged KV pools (bytes per value, and the float32
# scale int8 pools keep per pool entry per KV head): core.roofline's tables,
# the single source of truth that the cost model prices pages with too
from repro_torch.core.roofline import KV_ITEMSIZE, KV_SCALE_BYTES


def kv_page_bytes(cfg, page_size: int, kv_dtype: str,
                  kv_shards: int = 1) -> int:
    """Bytes one pool page costs across ALL paged (global-attention) layers
    for a given storage dtype — K and V values plus, for int8, their scale
    rows.  The engine sizes its page budget with this: a pool budget is a
    BYTE budget, and int8 fits ~``4·hd/(hd+4)``× the pages of float32 in
    the same bytes.  ``kv_shards`` prices a page PER RANK under KV-head
    tensor parallelism (the engine's ``mesh=``): each rank holds ``kvH //
    kv_shards`` of a layer's heads (layers whose head count does not divide
    stay whole and cost their full bytes on every rank)."""
    isize = KV_ITEMSIZE[kv_dtype]
    sbytes = KV_SCALE_BYTES[kv_dtype]
    total = 0
    for st in cfg.stages:
        for blk in st.pattern:
            if blk.mixer == "attn" and blk.attn.window is None:
                kvH, hd = blk.attn.num_kv_heads, blk.attn.head_dim
                if kvH % kv_shards == 0:
                    kvH //= kv_shards
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
    """Refcounted two-tier page allocator doubling as a prefix cache (see
    module docstring).  ``index_enabled=False`` degrades it to a plain FIFO
    page allocator: every match misses and released pages free immediately.
    ``host_pages=0`` (the default) disables the host tier: eviction drops
    pages exactly as it always did."""

    def __init__(self, n_pages: int, page_size: int, *,
                 index_enabled: bool = True, host_pages: int = 0):
        if n_pages < 0 or page_size < 1:
            raise ValueError(f"bad pool shape ({n_pages=}, {page_size=})")
        if host_pages < 0:
            raise ValueError(f"bad host tier size ({host_pages=})")
        self.n_pages = n_pages
        self.page_size = page_size
        self.index_enabled = bool(index_enabled)
        self._free: List[int] = list(range(n_pages))
        self._ref = np.zeros(n_pages, np.int64)  # per-page refcounts
        self._root = _PrefixNode(None, -1, None)  # trie of cached prefixes
        self._page_node: Dict[int, _PrefixNode] = {}  # page -> trie node
        self._clock = 0  # LRU counter (bumped per touch)
        # host tier: slot -> trie node for demoted pages (encoded in the
        # trie as page id ``n_pages + slot``); no refcounts — a pure cache
        self.host_pages = int(host_pages)
        self._host_free: List[int] = list(range(self.host_pages))
        self._host_node: Dict[int, _PrefixNode] = {}
        self._host_pinned: set = set()  # slots mid-promotion: not evictable
        # host slots holding a PREEMPTED request's parked pages: outside the
        # trie (not matchable), never host-evictable — live-request state
        # outranks cache.  Freed only by unpark (resume) or drop_parked.
        self._parked: set = set()
        # chronological demote/promote/hevict log for the engine to apply
        # to device state (``drain_events``)
        self.events: List[tuple] = []
        self.stats = {"evictions": 0, "demotions": 0, "promotions": 0,
                      "host_evictions": 0,
                      # preemption swap traffic: pages parked device->host,
                      # unparked host->device, and parks abandoned
                      "park_demotions": 0, "park_promotions": 0,
                      "parks_dropped": 0}

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

    @property
    def host_cached_pages(self) -> int:
        """Pages resident in the host tier (demoted, still matchable)."""
        return len(self._host_node)

    @property
    def host_free_slots(self) -> int:
        return len(self._host_free)

    @property
    def parked_pages(self) -> int:
        """Host slots holding preempted requests' parked pages."""
        return len(self._parked)

    def is_host(self, page: int) -> bool:
        """True for an encoded host-tier page id (``n_pages + slot``)."""
        return page >= self.n_pages

    def is_indexed(self, page: int) -> bool:
        """True when a device page is owned by the prefix index.

        The speculative-decoding safety contract leans on this: only full
        PROMPT pages ever enter the index (``index_page`` is driven by
        prefill advancing ``fill``; decode and draft tokens never advance
        it), so a slot's decode/draft positions always land in pages this
        returns False for — privately allocated or COW'd, refcount-held by
        the slot alone.  Rejected-tail rollback therefore can never corrupt
        an indexed prefix page or its int8 scale rows: the rolled-back rows
        live exclusively in non-indexed pages, and the rollback itself only
        touches per-slot kpos/slen metadata anyway.  The engine asserts
        this when packing draft chains."""
        return page in self._page_node

    def ref(self, page: int) -> int:
        return int(self._ref[page])

    def evictable(self) -> int:
        """Cached device pages reclaimable under pressure (refcount 0) —
        by demotion with a host tier, by dropping without one; either way
        the device page becomes allocator supply."""
        return sum(1 for p in self._page_node if self._ref[p] == 0)

    def available(self, pinned: Sequence[int] = ()) -> int:
        """Device pages an admission could obtain AFTER it pins ``pinned``:
        free + evictable, minus currently-refcount-0 cached pages the caller
        is about to hold — a page the request itself pins must not be
        counted as reclaimable supply for its own allocation.  Encoded
        host-tier ids in ``pinned`` are ignored: promoting them CONSUMES a
        device page, which callers price into their demand instead."""
        held = sum(1 for p in set(pinned)
                   if p < self.n_pages and self._ref[p] == 0)
        return len(self._free) + self.evictable() - held

    def drain_events(self) -> List[tuple]:
        """Hand over (and clear) the chronological tier-traffic log.  The
        engine must apply entries IN ORDER before any other device-state
        mutation of the admission round: ("demote", page, slot) gathers the
        device page's bytes into host storage BEFORE the freed page is
        reused, ("promote", slot, page) scatters host bytes into the newly
        allocated device page, ("hevict", slot) discards host storage.  A
        slot freed by a promote may be reused by a later demote in the same
        round — chronological application makes that correct by
        construction."""
        ev, self.events = self.events, []
        return ev

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
        the prefix trie indexes them (the pool IS the cache; tiered eviction
        reclaims them under pressure) and are freed immediately otherwise."""
        for p in pages:
            self._ref[p] -= 1
            assert self._ref[p] >= 0, f"page {p} over-released"
            if self._ref[p] == 0 and p not in self._page_node:
                self._free.append(p)

    def acquire(self, pages: Sequence[int]) -> List[int]:
        """Take one reference per matched page, PROMOTING host-tier hits.

        Device pages are ``share``d; encoded host ids get a device page
        allocated (demoting under pressure), their trie entry moved back to
        the device tier, and a ("promote", slot, page) event appended for
        the engine to scatter the host bytes in.  Returns the resolved
        all-device page list — every returned page carries one reference
        for the caller.

        Pages must arrive in chain (root-first) order, as ``match_prefix``
        returns them: the matched chain's device prefix is then referenced
        before any promotion can trigger a demotion, and each promotion
        re-closes the device region of the trie before the next.  Pending
        host slots are pinned against host eviction for the duration — a
        promotion's own demotions can never evict the tail it is about to
        promote."""
        pending = {p - self.n_pages for p in pages if p >= self.n_pages}
        self._host_pinned |= pending
        out: List[int] = []
        try:
            for p in pages:
                if p < self.n_pages:
                    self._ref[p] += 1
                    out.append(p)
                    continue
                slot = p - self.n_pages
                (dev,) = self.alloc(1)  # arrives refcounted
                node = self._host_node.pop(slot)
                node.page = dev
                self._page_node[dev] = node
                self._host_free.append(slot)
                self._host_pinned.discard(slot)
                self.events.append(("promote", slot, dev))
                self.stats["promotions"] += 1
                out.append(dev)
        finally:
            self._host_pinned -= pending
        return out

    # -- preemption swap (park / unpark) ----------------------------------
    def park(self, pages: Sequence[int]) -> Optional[List[int]]:
        """Swap a preempted slot's PRIVATE pages out to pinned host slots.

        Each page must be refcount-1 and non-indexed (the victim slot is
        its sole owner — generated-token pages and prompt duplicates; the
        victim's indexed prefix pages are simply ``release``d instead and
        stay matchable as cache).  Emits the same ("demote", page, slot)
        events as cache demotion, so the engine's event drain moves the
        bytes with the machinery it already has; the slots land in
        ``_parked`` — never in the trie — so neither matching nor host
        eviction can touch them until ``unpark``/``drop_parked``.

        ALL-OR-NOTHING: returns the host slot list (parallel to ``pages``),
        or ``None`` without side effects when the host tier is absent or
        cannot take every page — a resume needs contiguous coverage, so a
        partial park is worth nothing.  Making room may hevict cached host
        nodes (live-request state outranks the pure cache)."""
        pages = list(pages)
        if not pages:
            return []
        if self.host_pages == 0:
            return None
        # conservative capacity probe: free slots + currently-evictable
        # cache nodes (evictions can only expose more candidates)
        cap = len(self._host_free) + sum(
            1 for s, nd in self._host_node.items()
            if s not in self._host_pinned and not nd.children)
        if cap < len(pages):
            return None
        slots: List[int] = []
        for p in pages:
            assert self._ref[p] == 1 and p not in self._page_node, \
                f"park of a shared or indexed page {p}"
            slot = self._host_slot_for_demote()
            assert slot is not None, "capacity probe admitted a full tier"
            self.events.append(("demote", p, slot))
            self._ref[p] -= 1
            self._free.append(p)
            self._parked.add(slot)
            slots.append(slot)
        self.stats["park_demotions"] += len(slots)
        return slots

    def unpark(self, slots: Sequence[int]) -> List[int]:
        """Resume a park: allocate one device page per parked slot and emit
        ("promote", slot, page) events for the engine to scatter the bytes
        back.  Returned pages carry refcount 1 (the resumed slot owns
        them); the host slots return to the cache's free list.  Callers
        gate on ``available()`` for the whole resume demand first, exactly
        like admission."""
        out: List[int] = []
        for slot in slots:
            assert slot in self._parked, f"unpark of a non-parked slot {slot}"
            # alloc BEFORE freeing the slot: an eviction this alloc triggers
            # then cannot demote into a slot whose bytes are still pending
            # promotion (chronological event order handles later reuse)
            (dev,) = self.alloc(1)
            self.events.append(("promote", slot, dev))
            self._parked.discard(slot)
            self._host_free.append(slot)
            out.append(dev)
        self.stats["park_promotions"] += len(out)
        return out

    def drop_parked(self, slots: Sequence[int]) -> None:
        """Abandon a park (cancel, deadline expiry, chaos eviction storm):
        the host slots free and ("hevict", slot) events tell the engine to
        discard the bytes.  The preempted request can still resume — it
        re-prefills from its own token history instead of promoting."""
        n = 0
        for slot in slots:
            if slot not in self._parked:
                continue
            self._parked.discard(slot)
            self._host_free.append(slot)
            self.events.append(("hevict", slot))
            n += 1
        self.stats["parks_dropped"] += n

    # -- prefix index -----------------------------------------------------
    @property
    def root(self) -> _PrefixNode:
        return self._root

    def _walk_full_pages(self, prompt: np.ndarray, touch: bool):
        """Walk the trie one full page of ``prompt`` at a time; returns
        (last node, matched pages, matched tokens).  ``touch`` refreshes
        LRU recency — the one difference between a real match and the
        schedulers' non-mutating probe, which must share this walk so their
        notions of "cached prefix" can never drift apart."""
        P = self.page_size
        node, pages, matched = self._root, [], 0
        while matched + P <= len(prompt):
            child = node.children.get(
                tuple(int(t) for t in prompt[matched:matched + P]))
            if child is None:
                break
            if touch:
                child.last_used = self._clock
            node = child
            pages.append(child.page)
            matched += P
        return node, pages, matched

    def match_prefix(self, prompt: np.ndarray):
        """Longest cached prefix of ``prompt`` ACROSS BOTH TIERS: walk the
        trie a full page at a time, then probe the children of the last
        matched node for a partial-page hit (longest common prefix ≥ 1
        token → COW candidate; device tier only — a mid-page reuse is an
        optimization, not worth a promotion).

        Returns (node, pages, matched_tokens, cow) with ``pages`` the full
        shared pages IN CHAIN ORDER — host-tier hits appear as encoded ids
        ``n_pages + slot``, always a contiguous tail of the list (the
        device region of the trie is prefix-closed) — and ``cow`` either
        None or (src_page, extra_tokens).  Refcounts are NOT touched — the
        caller ``acquire``s what it keeps (which also promotes the host
        hits)."""
        if not self.index_enabled:
            return self._root, [], 0, None
        self._clock += 1
        node, pages, matched = self._walk_full_pages(prompt, touch=True)
        cow = None
        rem = prompt[matched:]
        if rem.size and node.children:
            best_len, best = 0, None
            for key, child in node.children.items():
                if self.is_host(child.page):
                    continue
                k = np.asarray(key[:rem.size], np.int32)
                lcp = int((np.cumprod(k == rem[:k.size]) if k.size else
                           np.zeros(0)).sum())
                if lcp > best_len:
                    best_len, best = lcp, child
            if best is not None:
                best.last_used = self._clock
                cow = (best.page, best_len)
        return node, pages, matched, cow

    def probe_prefix_len(self, prompt: np.ndarray) -> int:
        """Tokens of ``prompt`` covered by cached FULL pages (either tier)
        — a non-mutating ``match_prefix`` (no LRU touch) for schedulers
        ranking queued requests by expected reuse."""
        if not self.index_enabled:
            return 0
        return self._walk_full_pages(prompt, touch=False)[2]

    def probe_prefix_split(self, prompt: np.ndarray) -> Tuple[int, int]:
        """(device_tokens, host_tokens) of the cached full-page prefix — a
        non-mutating probe for tier-aware schedulers: a device hit is free,
        a host hit costs one promotion copy, a miss costs re-prefill, so
        the three candidate classes rank warm > host-warm > cold."""
        if not self.index_enabled:
            return 0, 0
        _, pages, matched = self._walk_full_pages(prompt, touch=False)
        host = sum(1 for p in pages if self.is_host(p)) * self.page_size
        return matched - host, host

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

    def storm_host_cache(self) -> int:
        """Chaos hook: hevict EVERY evictable host cache node (leaf-first,
        until none remain).  Parked slots and pinned (mid-promotion) nodes
        survive — a storm models cache-tier loss, and live-request state is
        not cache.  Returns the number of slots dropped."""
        n = 0
        progress = True
        while progress:
            progress = False
            for slot, nd in list(self._host_node.items()):
                if slot in self._host_pinned or nd.children:
                    continue
                self._hevict(nd)
                n += 1
                progress = True
        return n

    # -- eviction / demotion ----------------------------------------------
    def evict_one(self) -> bool:
        """Reclaim one device page from the cache.

        With a host tier this is a DEMOTION: the least-recently-used
        refcount-0 device node with no DEVICE children (host children may
        hang below — the device region stays prefix-closed) moves its page
        to a host slot; the trie entry survives with an encoded host id and
        a ("demote", page, slot) event tells the engine to gather the bytes
        out before the freed page is reused.  Host capacity is made by
        dropping the LRU childless, unpinned host node first.

        Without a host tier — or in the corner where every host slot is
        pinned by an in-flight promotion — the page is DROPPED as the
        untiered pool always did (any host descendants are dropped with it
        so every surviving chain stays rooted).  Device-leaf-first plus
        refcount monotonicity (active requests hold their whole matched
        path) means repetition drains any evictable subtree."""
        best = None
        stack = list(self._root.children.values())
        while stack:
            nd = stack.pop()
            stack.extend(nd.children.values())
            if self.is_host(nd.page) or self._ref[nd.page] != 0:
                continue
            if any(not self.is_host(c.page) for c in nd.children.values()):
                continue
            if best is None or nd.last_used < best.last_used:
                best = nd
        if best is None:
            return False
        slot = self._host_slot_for_demote()
        if slot is None:
            self._drop_device_node(best)
            return True
        self.events.append(("demote", best.page, slot))
        del self._page_node[best.page]
        self._free.append(best.page)
        self._host_node[slot] = best
        best.page = self.n_pages + slot
        self.stats["demotions"] += 1
        return True

    def _host_slot_for_demote(self) -> Optional[int]:
        """A free host slot for an incoming demotion, evicting the LRU
        childless (and unpinned) host node if the tier is full; ``None``
        when the tier is disabled or nothing can make room."""
        if self.host_pages == 0:
            return None
        if self._host_free:
            return self._host_free.pop()
        best = None
        for slot, nd in self._host_node.items():
            if slot in self._host_pinned or nd.children:
                continue
            if best is None or nd.last_used < self._host_node[best].last_used:
                best = slot
        if best is None:
            return None
        self._hevict(self._host_node[best])
        return self._host_free.pop()

    def _hevict(self, node: _PrefixNode) -> None:
        """Drop one host-tier node: trie entry out, slot freed, ("hevict",
        slot) event so the engine discards the host-side bytes."""
        slot = node.page - self.n_pages
        del node.parent.children[node.key]
        del self._host_node[slot]
        self._host_free.append(slot)
        self.events.append(("hevict", slot))
        self.stats["host_evictions"] += 1

    def _drop_device_node(self, node: _PrefixNode) -> None:
        """Discard a device node outright (untiered eviction, or the
        all-host-slots-pinned corner), cascading its host descendants
        children-first so no chain is left unrooted."""
        def drop_host(nd: _PrefixNode) -> None:
            for c in list(nd.children.values()):
                drop_host(c)
            if self.is_host(nd.page):
                self._hevict(nd)
        for c in list(node.children.values()):
            drop_host(c)
        del node.parent.children[node.key]
        del self._page_node[node.page]
        self._free.append(node.page)
        self.stats["evictions"] += 1

    def drop_cache(self) -> int:
        """Discard every refcount-0 cached page in BOTH tiers (A/B runs,
        tests) — nothing is demoted; the cache is emptied.  Returns the
        number of DEVICE pages returned to the free list.  Callers holding
        host-side storage must still drain the ("hevict", slot) events."""
        n = 0

        def drop(nd: _PrefixNode) -> None:
            nonlocal n
            for c in list(nd.children.values()):
                drop(c)
            if nd.children:
                return  # a kept (referenced) descendant pins the chain
            if self.is_host(nd.page):
                self._hevict(nd)
            elif self._ref[nd.page] == 0:
                del nd.parent.children[nd.key]
                del self._page_node[nd.page]
                self._free.append(nd.page)
                self.stats["evictions"] += 1
                n += 1

        for c in list(self._root.children.values()):
            drop(c)
        return n
