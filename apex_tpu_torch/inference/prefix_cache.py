"""Host-side prefix cache: a radix tree over token ids mapping cached
prompt prefixes to KV page lists (ISSUE 12), with a host-DRAM second
tier under the HBM pool (ISSUE 18).

Serving traffic is dominated by shared prompt prefixes — system
prompts, few-shot templates, multi-turn history.  The paged layout
(ISSUE 6) makes reusing them a TABLE-ROW EDIT: page-table indirection
means N requests can point at ONE physical copy of the prefix's pages,
so this cache only has to answer, host-side, "which already-filled
pages cover a prefix of this prompt?"  The device needs no new
executables for SHARING; the host tier adds exactly two (the swap
copy programs in :mod:`~apex_tpu.inference.kv_cache`).

Structure (the SGLang-style radix tree, at PAGE granularity):

* Each FULL-PAGE edge is keyed by its ``page_size`` token ids and
  carries the physical page holding those tokens' k/v.  Walking edges
  from the root yields the longest cached page-aligned prefix.
* A node may additionally hold PARTIAL-TAIL edges (< ``page_size``
  tokens): the unaligned tail of a cached prompt.  At the walk's
  boundary the longest common prefix against any outgoing edge adds
  sub-page coverage — the rows past the match are masked by the
  consumer (``prefix_window_attention`` masks columns ``>= start``),
  so partially matching pages are safely reusable.

Two-state edges (ISSUE 18): a full-page edge is either HBM-resident
(``page`` set, ``host`` None — the cache holds one allocator ref) or
HOST-resident (``page`` None, ``host`` = a
:class:`~apex_tpu.inference.kv_cache.HostPageStore` handle — the HBM
ref was released at eviction, the content lives in host DRAM).  LRU
eviction under backpressure OFFLOADS full pages device→host instead of
discarding them, so the next hit pays batched page uploads, not
recompute; the host tier has its own byte budget and its own LRU
(true-leaf host edges drop when the budget fills).  Partial-tail edges
are never offloaded — sub-page recompute is cheaper than a swap.
Tier structure invariant: an HBM edge only transitions to host once
its subtree holds no HBM pages, and :meth:`insert` resurrects host
edges along its walk, so below a host edge EVERY edge is host — the
host-tier LRU always finds a true leaf to drop.

Reference counting: the cache holds ONE reference
(:meth:`~apex_tpu.inference.kv_cache.PageAllocator.share`) on every
HBM page it indexes, so cached pages survive their original request's
retirement; :meth:`evict_lru` releases references leaf-first in
least-recently-matched order when the scheduler needs pages back —
BACKPRESSURE drives eviction, never a mid-request free.  Cross-tier
conservation (the churn sweep walks it every step): the allocator's
``free + distinct-live == num_pages`` as always, the cache's
``host_pages`` mirrors the store's entry count, and no page is ever
HBM-pinned and host-resident at once.

The cache never dispatches device work itself: matching and insertion
are pure host bookkeeping over ints, and eviction's offload runs
through an injected callable (the scheduler's engine-backed closure),
performed at the admission points the scheduler already occupies.
"""
from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from apex_tpu_torch.inference.kv_cache import HostPageStore, PageAllocator

__all__ = ["PrefixCache", "prefix_cache_enabled"]

_PREFIX_CACHE_ENV = "APEX_TPU_PREFIX_CACHE"


def prefix_cache_enabled() -> bool:
    """``APEX_TPU_PREFIX_CACHE``: prefix caching for paged schedulers —
    on by default (sharing is functionally transparent); ``0`` disables
    matching AND insertion (every admission prefills cold)."""
    env = os.environ.get(_PREFIX_CACHE_ENV)
    if env is None:
        return True
    return env.strip() not in ("0", "", "false", "False")


class _Edge:
    """One cached page: the tokens it holds, its residency (HBM page id
    XOR host-store handle), the LRU stamp, and (full-page edges only)
    the child node continuing the prefix."""
    __slots__ = ("page", "child", "stamp", "host")

    def __init__(self, page: int, child: Optional["_Node"], stamp: int):
        self.page: Optional[int] = page
        self.child = child
        self.stamp = stamp
        self.host: Optional[int] = None    # HostPageStore handle


class _Node:
    __slots__ = ("children", "partials")

    def __init__(self):
        self.children: Dict[Tuple[int, ...], _Edge] = {}   # ps-token edges
        self.partials: Dict[Tuple[int, ...], _Edge] = {}   # sub-page tails


def _lcp(a: Tuple[int, ...], b: Sequence[int]) -> int:
    n = min(len(a), len(b))
    i = 0
    while i < n and a[i] == b[i]:
        i += 1
    return i


class PrefixCache:
    """Radix tree ``token ids -> page list`` over one
    :class:`~apex_tpu.inference.kv_cache.PageAllocator`'s pages.

    ``min_hit_tokens`` (default ``page_size``) is the smallest coverage
    reported as a hit: sharing less than one page's worth of prefix
    costs a COW copy for near-zero compute savings, so sub-page
    accidental overlaps stay cold.

    ``host_store`` + ``offload`` arm the host tier (ISSUE 18):
    ``offload(page_ids)`` copies the pages' contents device→host and
    returns one store handle per page (or None when it cannot — the
    eviction then discards, exactly the pre-tier behavior).  Both None
    means single-tier operation, bit-identical to ISSUE 12.
    """

    def __init__(self, allocator: PageAllocator,
                 min_hit_tokens: Optional[int] = None, *,
                 host_store: Optional[HostPageStore] = None,
                 offload: Optional[
                     Callable[[List[int]], Optional[List[int]]]] = None):
        self._alloc = allocator
        self.page_size = allocator.page_size
        self.min_hit_tokens = (self.page_size if min_hit_tokens is None
                               else int(min_hit_tokens))
        self._host_store = host_store
        self._offload = offload
        self._root = _Node()
        self._clock = 0
        self.pinned_pages = 0          # HBM pages this cache holds a ref on
        self.evictions = 0             # HBM refs released by evict_lru
        self.host_pages = 0            # edges currently host-resident
        self.host_evictions = 0        # host-tier entries dropped for good
        self.swapped_out = 0           # lifetime pages offloaded to host

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    # -- lookup --------------------------------------------------------------
    def match_tiered(self, tokens: Sequence[int]) \
            -> Tuple[int, List[int], List[Tuple[int, int]]]:
        """Longest cached prefix of ``tokens`` ACROSS BOTH TIERS:
        ``(covered_tokens, pages, host)``.  ``pages[j]`` is the
        physical page backing page-ordinal ``j`` when HBM-resident and
        ``-1`` when host-resident; ``host`` lists the host ordinals as
        ``(ordinal, store_handle)`` pairs — the scheduler backs each
        with a freshly acquired page and swaps the content in before
        the tail's first prefill chunk.  Coverage below
        ``min_hit_tokens`` reports a miss ``(0, [], [])``.  Matched
        edges are LRU-touched in both tiers."""
        toks = [int(t) for t in tokens]
        ps = self.page_size
        node, pages, c = self._root, [], 0
        host: List[Tuple[int, int]] = []
        path: List[_Edge] = []
        while len(toks) - c >= ps:
            edge = node.children.get(tuple(toks[c:c + ps]))
            if edge is None:
                break
            path.append(edge)
            if edge.page is None:
                host.append((len(pages), edge.host))
                pages.append(-1)
            else:
                pages.append(edge.page)
            c += ps
            node = edge.child
        # boundary: best sub-page overlap against any outgoing edge
        rest = toks[c:]
        best, best_edge = 0, None
        if rest:
            for et, edge in list(node.children.items()) \
                    + list(node.partials.items()):
                n = _lcp(et, rest)
                if n > best:
                    best, best_edge = n, edge
        if best_edge is not None:
            path.append(best_edge)
            if best_edge.page is None:
                host.append((len(pages), best_edge.host))
                pages.append(-1)
            else:
                pages.append(best_edge.page)
            c += best
        if c < self.min_hit_tokens:
            return 0, [], []
        stamp = self._tick()
        for edge in path:
            edge.stamp = stamp
        return c, pages, host

    def peek_match(self, tokens: Sequence[int]) \
            -> Tuple[int, int, int]:
        """READ-ONLY coverage probe for routers (ISSUE 19):
        ``(covered_tokens, hbm_pages, host_pages)`` for the longest
        cached prefix of ``tokens`` across both tiers — the same walk
        as :meth:`match_tiered` but with ZERO side effects: no LRU
        touch, no clock tick, no counter.  A fleet front door peeks
        every replica's cache to find where a shared prefix's pages
        live; only the replica that actually ADMITS the request may
        disturb recency (a peek that stamped edges would let routing
        probes pin victims against eviction on replicas that never
        serve them)."""
        toks = [int(t) for t in tokens]
        ps = self.page_size
        node, c = self._root, 0
        hbm = host = 0
        while len(toks) - c >= ps:
            edge = node.children.get(tuple(toks[c:c + ps]))
            if edge is None:
                break
            if edge.page is None:
                host += 1
            else:
                hbm += 1
            c += ps
            node = edge.child
        rest = toks[c:]
        best, best_edge = 0, None
        if rest:
            for et, edge in list(node.children.items()) \
                    + list(node.partials.items()):
                n = _lcp(et, rest)
                if n > best:
                    best, best_edge = n, edge
        if best_edge is not None:
            if best_edge.page is None:
                host += 1
            else:
                hbm += 1
            c += best
        if c < self.min_hit_tokens:
            return 0, 0, 0
        return c, hbm, host

    def walk_edges(self) -> List[dict]:
        """Deterministic READ-ONLY walk of the radix tree, the
        sanctioned external observation surface (APX112: outside
        callers never touch ``_root``): one dict per edge, parents
        before children, siblings in sorted token order —
        ``{"path", "tokens", "kind" ("full"|"partial"), "page",
        "host", "stamp"}``.  The protocol auditor canonicalizes tree
        states and checks the tier invariant through this; no LRU
        touch, no clock tick."""
        out: List[dict] = []

        def walk(node: _Node, path: Tuple[int, ...]):
            for et in sorted(node.children):
                edge = node.children[et]
                out.append({"path": path, "tokens": et, "kind": "full",
                            "page": edge.page, "host": edge.host,
                            "stamp": edge.stamp})
                walk(edge.child, path + et)
            for et in sorted(node.partials):
                edge = node.partials[et]
                out.append({"path": path, "tokens": et,
                            "kind": "partial", "page": edge.page,
                            "host": edge.host, "stamp": edge.stamp})

        walk(self._root, ())
        return out

    def match(self, tokens: Sequence[int]) -> Tuple[int, List[int]]:
        """Single-tier view of :meth:`match_tiered` for callers that
        cannot swap in: coverage truncates at the first host-resident
        ordinal, so every returned page is HBM-live and shareable."""
        c, pages, host = self.match_tiered(tokens)
        if host:
            first = min(j for j, _ in host)
            c = min(c, first * self.page_size)
            pages = pages[:first]
            if c < self.min_hit_tokens:
                return 0, []
        return c, pages

    # -- insertion -----------------------------------------------------------
    def insert(self, tokens: Sequence[int], pages: Sequence[int]) -> int:
        """Register a prefilled prompt: ``pages`` are the physical
        pages backing ``tokens`` in order (``ceil(len(tokens) /
        page_size)`` of them).  New edges take one allocator reference
        per page (the cache's own pin); edges already present are
        deduplicated — the newcomer's identical private pages simply
        stay uncached and die with their request.  A HOST-resident edge
        on the walk is RESURRECTED instead: the newcomer's page (its
        freshly swapped-in or recomputed copy of the same content) is
        pinned and the host-store entry dropped — the swap-in commit
        path and the cold-recompute dedup path are the same move.
        Returns the number of pages newly pinned."""
        toks = [int(t) for t in tokens]
        ps = self.page_size
        full = len(toks) // ps
        if len(pages) < full + (1 if len(toks) % ps else 0):
            raise ValueError(
                f"{len(pages)} pages cannot back {len(toks)} tokens at "
                f"page size {ps}")
        stamp = self._tick()
        node, new = self._root, 0
        for j in range(full):
            et = tuple(toks[j * ps:(j + 1) * ps])
            edge = node.children.get(et)
            if edge is None:
                self._alloc.share([pages[j]])
                new += 1
                edge = _Edge(int(pages[j]), _Node(), stamp)
                node.children[et] = edge
            elif edge.page is None:
                # host -> HBM resurrection with the newcomer's copy
                self._alloc.share([pages[j]])
                new += 1
                edge.page = int(pages[j])
                if self._host_store is not None:
                    self._host_store.pop(edge.host)
                edge.host = None
                self.host_pages -= 1
            edge.stamp = stamp
            node = edge.child
        tail = tuple(toks[full * ps:])
        if tail:
            edge = node.partials.get(tail)
            if edge is None:
                self._alloc.share([pages[full]])
                new += 1
                node.partials[tail] = _Edge(int(pages[full]), None, stamp)
            else:
                edge.stamp = stamp
        self.pinned_pages += new
        return new

    # -- eviction ------------------------------------------------------------
    def _evictable(self):
        """Yield ``(stamp, parent_dict, key)`` for every HBM-evictable
        edge: any partial tail, and any HBM full-page edge whose
        subtree holds no HBM pages (a purely-host subtree no longer
        anchors its ancestors) — interior pages stay until their HBM
        subtree drains."""
        out = []

        def walk(node: _Node) -> bool:
            has_hbm = False
            for key, edge in node.partials.items():
                out.append((edge.stamp, node.partials, key))
                has_hbm = True
            for key, edge in node.children.items():
                child_has = walk(edge.child)
                if edge.page is not None:
                    if not child_has:
                        out.append((edge.stamp, node.children, key))
                    has_hbm = True
                has_hbm = has_hbm or child_has
            return has_hbm

        walk(self._root)
        return out

    def _host_evictable(self):
        """``(stamp, parent_dict, key)`` for true-leaf host edges —
        the only droppable host-tier entries (the tier invariant keeps
        the deepest edges host, so there is always one while
        ``host_pages > 0``)."""
        out = []

        def walk(node: _Node):
            for key, edge in node.children.items():
                child = edge.child
                if edge.page is None and not child.children \
                        and not child.partials:
                    out.append((edge.stamp, node.children, key))
                else:
                    walk(child)

        walk(self._root)
        return out

    def _evict_host_leaf(self) -> bool:
        """Drop the least-recently-matched host-tier leaf (the host
        tier's own LRU, run when its byte budget fills)."""
        leaves = self._host_evictable()
        if not leaves:
            return False
        _, parent, key = min(leaves, key=lambda t: t[0])
        edge = parent.pop(key)
        if self._host_store is not None:
            self._host_store.pop(edge.host)
        self.host_pages -= 1
        self.host_evictions += 1
        return True

    def _drop_host_subtree(self, node: _Node) -> None:
        """Drop every host-tier entry under ``node`` (an HBM-evictable
        victim's subtree holds only host full-page edges — partials
        and HBM pages would have anchored it)."""
        for edge in node.children.values():
            if edge.page is None:
                if self._host_store is not None:
                    self._host_store.pop(edge.host)
                self.host_pages -= 1
                self.host_evictions += 1
            self._drop_host_subtree(edge.child)

    def _offload_batch(self, victims: List[_Edge]) -> Dict[_Edge, int]:
        """Copy full-page victims device→host in ONE batched extract
        BEFORE their HBM refs drop; returns ``{edge: handle}`` for the
        pages parked.  Partial-tail edges are never offloaded (sub-page
        recompute is cheaper than a swap) and victims the host budget
        cannot hold — even after dropping host-LRU leaves — are
        discarded exactly as before the tier existed (oldest first, so
        the budget keeps the most recently matched)."""
        if self._offload is None or self._host_store is None:
            return {}
        full = [e for e in victims if e.child is not None]
        while full and not self._host_store.fits(len(full)):
            if not self._evict_host_leaf():
                store = self._host_store
                room = max(0, (store.capacity_bytes - store.bytes_used)
                           // store.page_bytes)
                full = full[len(full) - room:] if room else []
                break
        if not full:
            return {}
        handles = self._offload([e.page for e in full])
        if handles is None:
            return {}
        self.swapped_out += len(full)
        return dict(zip(full, handles))

    def evict_lru(self, pages_wanted: int) -> int:
        """Release cached HBM references, least-recently-matched
        evictable edges first, until ``pages_wanted`` pages have
        RETURNED to the free list (a released page still shared by a
        live request frees nothing, so eviction keeps going) or the
        cache holds no HBM pages.  Returns the number of pages actually
        freed.

        With the host tier armed, each batch of full-page victims is
        offloaded device→host FIRST (one batched extract while the
        pages are still pinned), then released: the HBM page returns to
        the free list immediately and the edge transitions to its
        ``host`` state instead of being deleted.  One tree walk selects
        a whole BATCH of victims (oldest first, sized by PREDICTED
        frees — a refcount-1 page frees on release, a shared one does
        not); the tree is re-walked only when the batch is exhausted
        (transitioning or popping an edge can expose its parent)."""
        freed0 = self._alloc.free_pages

        def done():
            return self._alloc.free_pages - freed0 >= pages_wanted

        while not done():
            leaves = sorted(self._evictable(), key=lambda t: t[0])
            if not leaves:
                break
            victims = []
            predicted = self._alloc.free_pages - freed0
            for _, parent, key in leaves:
                if predicted >= pages_wanted:
                    break
                victims.append((parent, key))
                if self._alloc.refcount(parent[key].page) == 1:
                    predicted += 1
            handles = self._offload_batch(
                [parent[key] for parent, key in victims])
            for parent, key in victims:
                edge = parent[key]
                self._alloc.release([edge.page])
                self.pinned_pages -= 1
                self.evictions += 1
                if edge in handles:
                    edge.page = None
                    edge.host = handles[edge]
                    self.host_pages += 1
                else:
                    parent.pop(key)
                    if edge.child is not None:
                        self._drop_host_subtree(edge.child)
        return self._alloc.free_pages - freed0

    def clear(self) -> None:
        """Release every cached HBM reference and drop every host-tier
        entry (cache teardown)."""
        def walk(node: _Node):
            for edge in node.partials.values():
                self._alloc.release([edge.page])
            for edge in node.children.values():
                if edge.page is None:
                    if self._host_store is not None:
                        self._host_store.pop(edge.host)
                else:
                    self._alloc.release([edge.page])
                walk(edge.child)

        walk(self._root)
        self._root = _Node()
        self.pinned_pages = 0
        self.host_pages = 0
