"""The KV caches: dataclasses of tensors updated in place.

Port of ``apex_tpu/inference/kv_cache.py``.  The dense slot cache
(:class:`KVCache`, the JAX engine's default) provisions ``max_seq``
rows for every slot::

    k, v       : [slots, layers, kv_heads, max_seq, head_dim]
    lengths    : [slots]  int32   live tokens per slot

The paged pool (:class:`PagedKVCache`)::

    k, v       : [pages, layers, kv_heads, page_size, head_dim]
    page_table : [slots, max_pages_per_slot]  int32
    lengths    : [slots]  int32   live tokens per slot
    capacity   : [slots]  int32   page_size * pages owned by the slot

A slot's tokens live in whichever pages the host-side
:class:`PageAllocator` handed it; virtual position ``t`` maps to
physical page ``page_table[slot, t // page_size]``, row
``t % page_size``.

Unlike the JAX package, whose pure updates return a new cache that the
jitted step donates, every mutation here (:func:`insert`,
:func:`insert_tokens`, :func:`append_layer`, :func:`advance`,
:func:`set_lengths`, :func:`evict`, :func:`cow_page`) UPDATES THE
CACHE IN PLACE and returns the same cache object, so the call sites
read the same (``cache = f(cache, ...)``) and no step ever allocates a
second cache.

Design positions carried over unchanged:

* **GQA/MQA-aware.**  The pool stores ``kv_heads`` (not query heads).
* **Eviction is metadata.**  Retiring a slot zeroes its length and
  capacity and re-parks its page-table row on the trash page.
* **The trash page.**  The pool carries ONE sacrificial page at index
  ``pages - 1`` that the allocator never hands out; page-table entries
  beyond a slot's reservation point there, so writes that overrun a
  reservation land harmlessly.  Rows past a slot's whole virtual
  window are dropped, never clamped onto live rows.
* **The dense clamp.**  A dense append at capacity (length ==
  ``max_seq``) lands on row ``max_seq - 1``, where the JAX
  ``dynamic_update_slice`` clamps its start; :func:`advance` flags the
  slot ``truncated`` and the caller retires it.

:class:`PageAllocator` and :class:`HostPageStore` are copied verbatim:
they are host bookkeeping over ints.
"""
from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence

import numpy as np
import torch

from apex_tpu_torch.utils import resolve_device

__all__ = ["KVCache", "init_cache", "insert", "PagedKVCache",
           "init_paged_cache", "PageAllocator", "HostPageStore",
           "default_page_size", "page_row", "insert_tokens", "append_layer",
           "append_targets", "advance", "set_lengths", "evict", "cow_page"]

_PAGE_SIZE_ENV = "APEX_TPU_PAGE_SIZE"
_DEFAULT_PAGE_SIZE = 64


def default_page_size() -> int:
    """Engine-default KV page size: ``APEX_TPU_PAGE_SIZE`` env var >
    the built-in 64 (a power of two <= the smallest prefill bucket, so
    buckets always tile exactly into pages)."""
    env = os.environ.get(_PAGE_SIZE_ENV)
    if env:
        try:
            val = int(env)
        except ValueError as e:
            raise ValueError(
                f"{_PAGE_SIZE_ENV} must be an int, got {env!r}") from e
        if val < 1 or (val & (val - 1)):
            raise ValueError(
                f"{_PAGE_SIZE_ENV} must be a positive power of two, "
                f"got {val}")
        return val
    return _DEFAULT_PAGE_SIZE


@dataclasses.dataclass
class KVCache:
    """Static-shape slot cache: ``max_seq`` rows for every slot."""
    k: torch.Tensor           # [slots, layers, kv_heads, max_seq, d]
    v: torch.Tensor           # same shape/dtype as k
    lengths: torch.Tensor     # [slots] int32: live tokens per slot

    @property
    def slots(self) -> int:
        return self.k.shape[0]

    @property
    def layers(self) -> int:
        return self.k.shape[1]

    @property
    def kv_heads(self) -> int:
        return self.k.shape[2]

    @property
    def max_seq(self) -> int:
        return self.k.shape[3]

    @property
    def head_dim(self) -> int:
        return self.k.shape[4]

    @property
    def device(self) -> torch.device:
        return self.k.device


def init_cache(slots: int, layers: int, kv_heads: int, max_seq: int,
               head_dim: int, dtype=torch.bfloat16, device=None) -> KVCache:
    """Allocate an empty dense cache (every slot free, length 0);
    ``device=None`` is CUDA."""
    dev = resolve_device(device)
    shape = (slots, layers, kv_heads, max_seq, head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=dev),
                   v=torch.zeros(shape, dtype=dtype, device=dev),
                   lengths=torch.zeros((slots,), dtype=torch.int32,
                                       device=dev))


def insert(cache: KVCache, slot: int, k, v, length: int) -> KVCache:
    """Prefill write, in place: park a prompt's k/v ``[layers, kv_heads,
    s, head_dim]`` (``s`` the possibly bucket-padded length, at most
    ``max_seq``) in rows ``[0, s)`` of one slot, and set its length to
    ``length`` real tokens (padding rows are stored but masked by the
    length wherever they could be read)."""
    s = k.shape[2]
    if k.shape != v.shape or tuple(k.shape[:2]) != (cache.layers,
                                                    cache.kv_heads) \
            or k.shape[3] != cache.head_dim:
        raise ValueError(
            f"prefill k/v must be [layers={cache.layers}, "
            f"kv_heads={cache.kv_heads}, s, head_dim={cache.head_dim}], "
            f"got k {tuple(k.shape)} v {tuple(v.shape)}")
    if s > cache.max_seq:
        raise ValueError(
            f"prompt length {s} exceeds cache max_seq {cache.max_seq}")
    cache.k[int(slot), :, :, :s] = k.to(cache.k.dtype)
    cache.v[int(slot), :, :, :s] = v.to(cache.v.dtype)
    cache.lengths[int(slot)] = int(length)
    return cache


@dataclasses.dataclass
class PagedKVCache:
    """Fixed-size page pool + per-slot page table (module docstring).
    The LAST page (``null_page == pages - 1``) is the trash page."""
    k: torch.Tensor           # [pages, layers, kv_heads, page_size, d]
    v: torch.Tensor           # same shape/dtype as k
    page_table: torch.Tensor  # [slots, max_pages_per_slot] int32
    lengths: torch.Tensor     # [slots] int32: live tokens per slot
    capacity: torch.Tensor    # [slots] int32: page_size * owned pages
    #: the engine's crossover override for ``paged_decode_attention``
    #: (its ``xla_max_pages``; None = the env/default), as in JAX
    attn_max_pages: Optional[int] = None

    @property
    def pages(self) -> int:
        """Total physical pages INCLUDING the trash page."""
        return self.k.shape[0]

    @property
    def null_page(self) -> int:
        return self.k.shape[0] - 1

    @property
    def alloc_pages(self) -> int:
        """Pages the allocator may hand out (pool minus the trash page)."""
        return self.k.shape[0] - 1

    @property
    def layers(self) -> int:
        return self.k.shape[1]

    @property
    def kv_heads(self) -> int:
        return self.k.shape[2]

    @property
    def page_size(self) -> int:
        return self.k.shape[3]

    @property
    def head_dim(self) -> int:
        return self.k.shape[4]

    @property
    def slots(self) -> int:
        return self.page_table.shape[0]

    @property
    def max_pages_per_slot(self) -> int:
        return self.page_table.shape[1]

    @property
    def max_seq(self) -> int:
        """The virtual per-slot window ``max_pages_per_slot *
        page_size``."""
        return self.page_table.shape[1] * self.k.shape[3]

    @property
    def device(self) -> torch.device:
        return self.k.device


def init_paged_cache(pages: int, layers: int, kv_heads: int,
                     page_size: int, head_dim: int, *, slots: int,
                     max_pages_per_slot: int, dtype=torch.bfloat16,
                     attn_max_pages: Optional[int] = None,
                     device=None) -> PagedKVCache:
    """Allocate an empty pool: ``pages`` allocatable pages (+1 trash
    page appended), every page-table entry pointing at the trash page,
    every slot empty.  ``attn_max_pages`` is kept on the cache for the
    attention call (:attr:`PagedKVCache.attn_max_pages`).
    ``device=None`` is CUDA."""
    if pages < 1 or page_size < 1 or max_pages_per_slot < 1:
        raise ValueError(
            f"pages ({pages}), page_size ({page_size}) and "
            f"max_pages_per_slot ({max_pages_per_slot}) must be >= 1")
    dev = resolve_device(device)
    shape = (pages + 1, layers, kv_heads, page_size, head_dim)
    i32 = dict(dtype=torch.int32, device=dev)
    return PagedKVCache(
        k=torch.zeros(shape, dtype=dtype, device=dev),
        v=torch.zeros(shape, dtype=dtype, device=dev),
        page_table=torch.full((slots, max_pages_per_slot), pages, **i32),
        lengths=torch.zeros((slots,), **i32),
        capacity=torch.zeros((slots,), **i32),
        attn_max_pages=attn_max_pages)


def page_row(page_ids: Sequence[int], max_pages_per_slot: int,
             null_page: int) -> np.ndarray:
    """Host helper: pad an allocator's page-ID list to a full
    ``[max_pages_per_slot]`` int32 page-table row (dead entries point
    at the trash page)."""
    ids = list(page_ids)
    if len(ids) > max_pages_per_slot:
        raise ValueError(
            f"{len(ids)} pages exceed max_pages_per_slot "
            f"{max_pages_per_slot}")
    return np.asarray(ids + [null_page] * (max_pages_per_slot - len(ids)),
                      np.int32)


def insert_tokens(cache: PagedKVCache, slot: int, k, v, length: int, row,
                  start: int) -> PagedKVCache:
    """Prefill write, in place: scatter a (bucket-padded) slab of ``s``
    token rows into the slot's pages at positions ``[start, start +
    s)`` — any alignment, so a prefix-cache hit can resume mid-page
    after its boundary COW.

    ``k``/``v``: ``[layers, kv_heads, s, head_dim]``; ``row`` is the
    slot's full page-table row (host ints, see :func:`page_row`);
    ``length`` is the slot's TOTAL live length after this write.  Row
    ``pos`` lands at ``(row[pos // page_size], pos % page_size)``;
    positions past the reservation land in the trash page, positions
    past the virtual window are dropped.  The slot's page-table row,
    length and capacity (owned pages x page_size) are set too."""
    ps, mpps, s = cache.page_size, cache.max_pages_per_slot, k.shape[2]
    if k.shape != v.shape or k.shape[0] != cache.layers \
            or k.shape[1] != cache.kv_heads \
            or k.shape[3] != cache.head_dim:
        raise ValueError(
            f"prefill k/v must be [layers={cache.layers}, "
            f"kv_heads={cache.kv_heads}, s, head_dim={cache.head_dim}], "
            f"got k {tuple(k.shape)} v {tuple(v.shape)}")
    if s < 1 or s > cache.max_seq:
        raise ValueError(
            f"suffix slab length {s} must be in [1, max_seq "
            f"{cache.max_seq}]")
    row = np.asarray(row, np.int32).reshape(-1)
    if row.shape != (mpps,):
        raise ValueError(f"page row must be [{mpps}], got {row.shape}")
    start = int(start)
    n = min(s, mpps * ps - start)      # rows inside the virtual window
    dev = cache.device
    if n > 0:
        pos = np.arange(start, start + n)
        ordinal = pos // ps
        pages = torch.from_numpy(row[ordinal].astype(np.int64)).to(dev)
        offs = torch.from_numpy(pos - ordinal * ps).to(dev)
        # [layers, kvh, n, d] -> [n, layers, kvh, d]: the advanced
        # indices (pages, offs) lead the indexed result
        cache.k[pages, :, :, offs, :] = k[:, :, :n].permute(
            2, 0, 1, 3).to(cache.k.dtype)
        cache.v[pages, :, :, offs, :] = v[:, :, :n].permute(
            2, 0, 1, 3).to(cache.v.dtype)
    owned = int(np.sum(row != cache.null_page))
    cache.page_table[slot] = torch.from_numpy(row).to(dev)
    cache.lengths[slot] = int(length)
    cache.capacity[slot] = owned * ps
    return cache


def append_targets(cache):
    """Where each slot's next token row goes, computed on the device (no
    host read).  Paged: ``(pages, offs)``, page ``page_table[i,
    lengths[i] // page_size]`` at row ``lengths[i] % page_size``; at
    capacity the write clamps into the last ordinal's page (the trash
    page for a slot whose reservation is full) — bounded damage, off the
    live data.  Dense: ``(slots, rows)``, row ``lengths[i]`` clamped to
    ``max_seq - 1`` as the JAX ``dynamic_update_slice`` clamps it."""
    if isinstance(cache, KVCache):
        rows = torch.clamp(cache.lengths.long(), max=cache.max_seq - 1)
        return torch.arange(cache.slots, device=cache.device), rows
    ps, mpps = cache.page_size, cache.max_pages_per_slot
    pos = cache.lengths.long()
    ordinal = torch.clamp(pos // ps, max=mpps - 1)
    pages = cache.page_table.gather(1, ordinal[:, None])[:, 0].long()
    offs = torch.clamp(pos - ordinal * ps, max=ps - 1)
    return pages, offs


def append_layer(cache, layer: int, k_tok, v_tok, targets=None):
    """Decode write for ONE layer, in place, on either cache: each
    slot's token row ``k_tok``/``v_tok [slots, kv_heads, head_dim]``
    lands at that slot's current length.  Lengths do NOT advance here
    (:func:`advance` runs once after the last layer).  ``targets`` may
    pass this step's :func:`append_targets` so the layers of one step
    share them."""
    if tuple(k_tok.shape) != (cache.slots, cache.kv_heads,
                              cache.head_dim):
        raise ValueError(
            f"token k/v must be [slots={cache.slots}, "
            f"kv_heads={cache.kv_heads}, head_dim={cache.head_dim}], "
            f"got {tuple(k_tok.shape)}")
    # paged: (page, row in page); dense: (slot, row); the same scatter
    first, second = append_targets(cache) if targets is None else targets
    kl, vl = cache.k[:, layer], cache.v[:, layer]    # strided views
    kl[first, :, second, :] = k_tok.to(cache.k.dtype)
    vl[first, :, second, :] = v_tok.to(cache.v.dtype)
    return cache


def _capacity(cache):
    """Each slot's capacity: ``max_seq`` (dense) or its owned pages'
    rows (paged)."""
    if isinstance(cache, KVCache):
        return torch.full_like(cache.lengths, cache.max_seq)
    return cache.capacity


def advance(cache, active):
    """Advance the active slots' lengths by one, in place; returns
    ``(cache, truncated)``.  Lengths clamp at the slot's capacity
    (``max_seq`` dense, the owned pages paged); ``truncated`` ([slots]
    bool, on the device) is True where an active slot was ALREADY at
    capacity, so its emitted token could not be appended and the caller
    must retire it."""
    act = torch.as_tensor(active, device=cache.device).to(torch.bool)
    cap = _capacity(cache)
    truncated = act & (cache.lengths >= cap) & (cap > 0)
    cache.lengths.copy_(torch.minimum(cache.lengths + act.to(torch.int32),
                                      cap))
    return cache, truncated


def set_lengths(cache, new_lengths):
    """Set every slot's length, in place, clamped to ``[0, capacity]``:
    the host-driven rollback of a draft engine (rows past the restored
    length are dead by the mask)."""
    new = torch.as_tensor(new_lengths, device=cache.device).to(torch.int32)
    cache.lengths.copy_(torch.minimum(torch.clamp(new, min=0),
                                      _capacity(cache)))
    return cache


def evict(cache, slot: int):
    """Retire a slot, in place: zero its length; paged, also its
    capacity, and re-park its page-table row on the trash page (so the
    idle slot's masked decode appends never land in another request's
    pages).  Metadata only — the k/v rows are left as they are."""
    cache.lengths[slot] = 0
    if isinstance(cache, KVCache):
        return cache
    cache.capacity[slot] = 0
    cache.page_table[slot] = cache.null_page
    return cache


def cow_page(cache: PagedKVCache, src: int, dst: int) -> PagedKVCache:
    """Copy-on-write page duplication, in place: copy physical page
    ``src``'s k/v rows (every layer) into page ``dst``.  The table-row
    swap is not done here: the suffix prefill that follows writes the
    slot's full row through :func:`insert_tokens`."""
    cache.k[int(dst)].copy_(cache.k[int(src)])
    cache.v[int(dst)].copy_(cache.v[int(src)])
    return cache


class PageAllocator:
    """Host-side reference-counted free-list allocator over the pool's
    allocatable pages (ISSUE 12: refcounts make shared-prefix page
    sharing and copy-on-write a bookkeeping operation).

    The scheduler's admission-control arm: a request is admitted only
    if :meth:`acquire` can hand it every PRIVATE page it may need
    (suffix + token budget, rounded up to whole pages) — out-of-pages
    is BACKPRESSURE (the request waits), never a mid-decode failure,
    because reservations are made in full before prefill.  A request
    extending a cached prefix does not copy the prefix's pages: it
    :meth:`share`\\ s them (refcount + 1 per co-owner), so N
    concurrent requests over a P-page prefix pin P physical pages,
    not N·P.  :meth:`release` is the ONLY way out: the page returns
    to the LIFO free list exactly when its LAST owner releases it.
    LIFO reuse keeps recently-touched pages hot.  Double-release and
    foreign-page releases raise — a leaked page is a capacity leak
    forever and a premature free corrupts another request's stream,
    so the bookkeeping is strict.

    Conservation invariant (the allocator sweep test walks it every
    step): ``free_pages + live_pages == num_pages`` with
    ``live_pages`` counting DISTINCT outstanding pages, while
    ``weighted_live()`` (the refcount-weighted view) equals the sum of
    every holder's page list — shared pages counted once per owner.
    """

    def __init__(self, num_pages: int, page_size: int,
                 max_pages_per_slot: int):
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.max_pages_per_slot = int(max_pages_per_slot)
        self._free: List[int] = list(range(self.num_pages))
        self._refs: dict = {}          # page id -> outstanding refcount

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def live_pages(self) -> int:
        """Distinct pages with at least one outstanding reference."""
        return len(self._refs)

    def weighted_live(self) -> int:
        """Sum of refcounts over live pages — what N sharers of one
        page would have paid WITHOUT sharing."""
        return sum(self._refs.values())

    def shared_pages(self) -> int:
        """Pages currently held by more than one owner."""
        return sum(1 for c in self._refs.values() if c > 1)

    def refcount(self, pid: int) -> int:
        return self._refs.get(int(pid), 0)

    def pages_needed(self, tokens: int) -> int:
        """Whole pages covering ``tokens``, clamped to the per-slot
        table size (a request past the virtual window truncates at
        capacity — the scheduler records why)."""
        need = -(-int(tokens) // self.page_size)
        return max(1, min(need, self.max_pages_per_slot))

    def acquire(self, n: int) -> Optional[List[int]]:
        """``n`` fresh page IDs at refcount 1 each, or None
        (backpressure) if the free list can't cover the reservation."""
        if n > len(self._free):
            return None
        ids = [self._free.pop() for _ in range(n)]
        for pid in ids:
            self._refs[pid] = 1
        return ids

    def share(self, ids: Sequence[int]) -> None:
        """Take one additional reference on each (already outstanding)
        page — the sharing half of copy-on-write.  Sharing a page with
        no live owner raises: a freed page may already back another
        request, so silent resurrection is the corruption this
        allocator exists to prevent."""
        ids = [int(p) for p in ids]
        for pid in ids:
            if pid not in self._refs:
                raise ValueError(
                    f"page {pid} is not outstanding (cannot share a "
                    f"freed page, or a page this allocator never "
                    f"issued)")
        for pid in ids:
            self._refs[pid] += 1

    def release(self, ids: Sequence[int]) -> None:
        """Drop one reference per page; a page whose LAST owner
        releases it returns to the LIFO free list.  Strict: releasing
        a page with no outstanding reference (double release, or a
        page this allocator never issued) raises."""
        for pid in ids:
            pid = int(pid)
            if pid not in self._refs:
                raise ValueError(
                    f"page {pid} is not outstanding (double release, "
                    f"or a page this allocator never issued)")
            self._refs[pid] -= 1
            if self._refs[pid] == 0:
                del self._refs[pid]
                self._free.append(pid)

    def snapshot(self) -> dict:
        """Read-only copy of the books, the SANCTIONED way to observe
        allocator internals from outside this package (the APX112 lint
        rule bans underscore-attribute mutation from anywhere else;
        the protocol auditor canonicalizes states through this).
        ``free`` preserves LIFO order — it determines which page the
        next acquire hands out, so two states whose free lists differ
        only in order are NOT equivalent."""
        return {"free": tuple(self._free),
                "refs": dict(self._refs)}


class _DeferredSlab:
    """Placeholder for one page whose device→host drain has been
    DISPATCHED but not yet fetched (ISSUE 19): ``pending.resolve()``
    returns the batch's stacked ``(k, v)`` slabs and ``index`` selects
    this page's row.  Bytes are booked the moment the placeholder is
    parked — the drain WILL land — so the budget stays as strict as an
    eager put."""
    __slots__ = ("pending", "index")

    def __init__(self, pending, index: int):
        self.pending = pending
        self.index = index

    def materialize(self):
        k, v = self.pending.resolve()
        return k[self.index].copy(), v[self.index].copy()


class HostPageStore:
    """Host-DRAM page tier under the HBM pool (ISSUE 18): a
    byte-budgeted dict of per-page k/v slabs, keyed by opaque integer
    handles the prefix cache's ``host``-state edges carry.

    The store is deliberately dumb: which entries exist and WHEN they
    are dropped is the prefix cache's per-tier LRU policy — this class
    only owns the byte ledger.  Entries are the GLOBAL page geometry
    (``[layers, kv_heads, page_size, head_dim]`` per buffer) even under
    tensor parallelism: the engine's swap-out assembles the full
    kv-head dim via ``device_get`` and the swap-in re-shards, so the
    host books stay replicated exactly like the page table.

    Conservation mirror (the churn sweep walks it every step):
    ``pages == `` the prefix cache's count of host-state edges, and
    ``bytes_used == pages * page_bytes <= capacity_bytes``.
    """

    def __init__(self, capacity_bytes: int, page_bytes: int):
        capacity_bytes = int(capacity_bytes)
        page_bytes = int(page_bytes)
        if capacity_bytes < 0 or page_bytes < 1:
            raise ValueError(
                f"capacity_bytes ({capacity_bytes}) must be >= 0 and "
                f"page_bytes ({page_bytes}) >= 1")
        self.capacity_bytes = capacity_bytes
        self.page_bytes = page_bytes
        self._slabs: dict = {}      # handle -> (k_np, v_np)
        self._next_handle = 0

    @property
    def pages(self) -> int:
        return len(self._slabs)

    @property
    def bytes_used(self) -> int:
        return len(self._slabs) * self.page_bytes

    def fits(self, n: int = 1) -> bool:
        """Would ``n`` more pages stay inside the byte budget?"""
        return self.bytes_used + int(n) * self.page_bytes \
            <= self.capacity_bytes

    def put(self, k_np, v_np) -> int:
        """Park one page's k/v slabs; returns the handle.  Strict on
        the budget: the caller (the prefix cache's offload path) makes
        room FIRST — an over-budget put is a bookkeeping bug."""
        if not self.fits(1):
            raise ValueError(
                f"host tier over budget: {self.bytes_used} + "
                f"{self.page_bytes} > {self.capacity_bytes}")
        handle = self._next_handle
        self._next_handle += 1
        self._slabs[handle] = (k_np, v_np)
        return handle

    def put_deferred(self, n: int, pending) -> list:
        """Park ``n`` pages whose device→host drain is in flight
        (ISSUE 19): ``pending.resolve()`` must return the batch's
        stacked ``(k, v)`` slabs ``[n, ...]``.  Same strict budget as
        :meth:`put` — bytes are booked eagerly for all ``n`` pages.
        Returns one handle per page.  A :meth:`get`/:meth:`pop` before
        the owner drains ``pending`` forces resolution (a prefix hit
        racing its own eviction is correct, just no longer deferred)."""
        n = int(n)
        if not self.fits(n):
            raise ValueError(
                f"host tier over budget: {self.bytes_used} + "
                f"{n * self.page_bytes} > {self.capacity_bytes}")
        handles = []
        for i in range(n):
            handle = self._next_handle
            self._next_handle += 1
            self._slabs[handle] = _DeferredSlab(pending, i)
            handles.append(handle)
        return handles

    def get(self, handle: int):
        """The ``(k, v)`` slabs behind ``handle`` (KeyError if the
        host-tier LRU already dropped it)."""
        handle = int(handle)
        entry = self._slabs[handle]
        if isinstance(entry, _DeferredSlab):
            entry = entry.materialize()
            self._slabs[handle] = entry
        return entry

    def pop(self, handle: int):
        """Drop an entry, returning its slabs (None if already gone —
        a swapped-in entry may race a host-tier eviction)."""
        entry = self._slabs.pop(int(handle), None)
        if isinstance(entry, _DeferredSlab):
            entry = entry.materialize()
        return entry

    def snapshot(self) -> dict:
        """Read-only view of the ledger, the sanctioned external
        observation surface (APX112): handle -> ``"resident"`` or
        ``"deferred"``.  Purely observational — an in-flight deferred
        entry is NOT materialized (that would force its pending drain
        and mutate the state being observed); a deferred entry whose
        pending already resolved counts as resident."""
        return {int(h): ("resident" if not isinstance(e, _DeferredSlab)
                         or getattr(e.pending, "done", False)
                         else "deferred")
                for h, e in self._slabs.items()}

    def peek_resident(self, handle: int):
        """The ``(k, v)`` slabs behind ``handle`` if resident (eager,
        or deferred with its drain already resolved), else None —
        unlike :meth:`get` this never forces an in-flight drain, so
        invariant checkers can inspect content without mutating the
        observable state."""
        entry = self._slabs.get(int(handle))
        if entry is None:
            return None
        if isinstance(entry, _DeferredSlab):
            if not getattr(entry.pending, "done", False):
                return None
            entry = entry.materialize()
            self._slabs[int(handle)] = entry
        return entry
