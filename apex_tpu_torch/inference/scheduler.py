"""SLO-aware continuous batching: a host-side slot (+page) allocator
with shared-prefix admission, chunked prefill, and tenant fairness.

The Megatron/vLLM-style serving loop reduced to its TPU-native core: the
DEVICE programs never change shape — decode is always ``[slots]``-wide,
prefill pads to one of O(log max_seq) buckets — and the HOST admits and
retires requests between device steps:

    admit:   free slot + queued request -> prefill into the slot
             (one donated executable; first token sampled in-program).
             PAGED engines additionally need the request's page
             reservation from the pool — but a request whose prompt
             extends a CACHED PREFIX (ISSUE 12) reserves only its
             uncached SUFFIX pages: the shared prefix pages are
             written into the slot's page-table row at one extra
             reference each (:class:`~apex_tpu.inference.prefix_cache.
             PrefixCache` + the refcounted allocator), and only the
             tail is prefilled (``prefill_from``).  Short of pages the
             scheduler first EVICTS cold cache entries (LRU), then
             WAITS (backpressure).  Admission order is SLO-aware:
             highest effective priority first (request priority + the
             ``APEX_TPU_TENANT_PRIORITY`` override), ties broken by
             least-recently-admitted tenant (per-tenant fairness under
             overload), then FIFO.
    chunk:   a long prompt's prefill is split into fixed-token chunks
             (``APEX_TPU_PREFILL_CHUNK``) interleaved with decode
             steps, so a long-prompt burst cannot stall every
             in-flight decode token for a whole monolithic prefill —
             at most ``max_chunks_per_pass`` chunks run between
             consecutive decode steps.
    step:    one decode executable over every slot (inactive slots
             compute garbage that is masked and never advances)
    retire:  EOS, the token budget, or slot capacity frees the slot;
             a retired slot only RELEASES its page references — a page
             another request (or the prefix cache) still maps goes
             back to the free list only when its LAST owner lets go.
             Every finished request records WHY in ``finish_reasons``.

Copy-on-write: a slot about to write into a page it still shares (the
partial boundary page of an unaligned prefix hit — e.g. a prompt that
EXACTLY matches a cached prefix re-prefills only its last token)
first privatizes it: one fresh page, one compiled copy dispatch
(:meth:`~apex_tpu.inference.engine.InferenceEngine.cow_page`), and the
row points at the copy — the other owners' reads stay bitwise
untouched.

A wave of requests therefore flows through a FIXED set of compiled
programs — the continuous-batching property — and N requests sharing a
P-page prefix pin P physical prefix pages, not N·P.

Telemetry (ISSUE 8/12): every scheduler carries a
:class:`~apex_tpu.observability.serve.ServeTelemetry` observing the
lifecycle at host points the loop ALREADY occupies — zero device reads,
zero recompiles — now including prefix-cache hit rate, shared-page and
cache-pinned-page gauges, COW copies, prefill chunks, and per-tenant
admitted/rejected counters.

SLO awareness (ISSUE 13): the same boundaries feed the request tracer
(``APEX_TPU_TRACE`` — per-request ``trace_span`` waterfalls) and an
:class:`~apex_tpu.observability.slo.SLOTracker` — one load observation
per loop pass through the overload detector, one burn-rate/error-budget
accounting window per ``run()`` wave (``APEX_TPU_SLO_TTFT_US`` /
``APEX_TPU_SLO_DECODE_US``).  Behind ``shed_on_overload=True`` the
priority admission consumes the advisory: while overload holds, the
LOWEST effective-priority queued request is rejected
(``finish_reasons[uid] == "shed"``, a ``rejected`` terminal span, the
rejected side of the conservation law) so high-priority tenants keep
their SLOs through the storm.
"""
from __future__ import annotations

import collections
import dataclasses
import os
from typing import Dict, Optional

import numpy as np

from apex_tpu_torch.inference import kv_cache
from apex_tpu_torch.inference.prefix_cache import PrefixCache, prefix_cache_enabled
from apex_tpu_torch.inference.speculative import Drafter, NGramDrafter
from apex_tpu_torch.observability import ServeTelemetry
from apex_tpu_torch.observability.slo import SLOTracker

__all__ = ["Request", "SlotScheduler", "generate",
           "default_prefill_chunk", "tenant_priority_overrides"]

#: finish_reasons codes
REASON_EOS = "eos"                    # the request's eos_id was sampled
REASON_LENGTH = "length"              # max_new_tokens budget exhausted
REASON_TRUNCATED = "truncated"        # slot capacity (max_seq or page
#                                       reservation) cut the stream
REASON_SHED = "shed"                  # rejected while queued by the
#                                       overload shedding advisory

#: Admission-cost weight of one HOST-tier-covered token (ISSUE 19):
#: a swap-in upload per page instead of a full prefill recompute —
#: much cheaper than cold (1.0) but never free like an HBM hit (0.0).
#: The exact value only needs to preserve that ordering; 0.25 tracks
#: the dryrun's upload-vs-prefill ratio at the flagship page size.
HOST_HIT_TOKEN_COST = 0.25

_PREFILL_CHUNK_ENV = "APEX_TPU_PREFILL_CHUNK"
_TENANT_PRIORITY_ENV = "APEX_TPU_TENANT_PRIORITY"


def default_prefill_chunk() -> int:
    """``APEX_TPU_PREFILL_CHUNK``: chunked-prefill chunk size in tokens
    (``0`` = monolithic prefill).  Prompts longer than this prefill in
    chunks interleaved with decode steps, bounding decode-token p99
    during long-prompt bursts."""
    env = os.environ.get(_PREFILL_CHUNK_ENV)
    if not env:
        return 0
    try:
        val = int(env)
    except ValueError as e:
        raise ValueError(
            f"{_PREFILL_CHUNK_ENV} must be an int, got {env!r}") from e
    if val < 0:
        raise ValueError(
            f"{_PREFILL_CHUNK_ENV} must be >= 0, got {val}")
    return val


def tenant_priority_overrides() -> Dict[str, int]:
    """``APEX_TPU_TENANT_PRIORITY``: per-tenant admission-priority
    boosts, ``"tenantA=10,tenantB=-1"`` (empty/``0`` = none).  Added to
    each request's own ``priority`` when the scheduler picks the next
    admission."""
    env = os.environ.get(_TENANT_PRIORITY_ENV)
    if not env or env.strip() == "0":
        return {}
    out: Dict[str, int] = {}
    for item in env.split(","):
        item = item.strip()
        if not item:
            continue
        if "=" not in item:
            raise ValueError(
                f"{_TENANT_PRIORITY_ENV} entries must be "
                f"tenant=priority, got {item!r}")
        name, _, val = item.partition("=")
        try:
            out[name.strip()] = int(val)
        except ValueError as e:
            raise ValueError(
                f"{_TENANT_PRIORITY_ENV}: priority for {name!r} must "
                f"be an int, got {val!r}") from e
    return out


@dataclasses.dataclass
class Request:
    uid: int
    prompt: list
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    tenant: str = "default"
    priority: int = 0


@dataclasses.dataclass
class _SlotState:
    """Host bookkeeping for one occupied slot."""
    uid: int
    generated: list
    max_new_tokens: int
    eos_id: Optional[int]
    prompt_len: int = 0
    capacity: int = 0              # cache positions this slot owns
    pages: Optional[list] = None   # page refs held (shared + private)
    tenant: str = "default"
    prompt: Optional[list] = None  # full prompt (chunked prefill)
    prefilled: int = 0             # prompt tokens already in the cache
    chunked: bool = False          # prefill split into >1 chunk

    def prefilling(self) -> bool:
        """Still inserting prompt tokens — not decoding yet."""
        return self.prefilled < self.prompt_len

    def done(self) -> bool:
        if self.eos_id is not None and self.generated \
                and self.generated[-1] == self.eos_id:
            return True
        return len(self.generated) >= self.max_new_tokens

    def cache_len(self) -> int:
        """The slot's device cache length, derived host-side: the
        prompt plus one append per decode step taken (the first
        generated token comes from prefill and is written by the NEXT
        decode) — so the capacity guard never reads the device."""
        return self.prompt_len + len(self.generated) - 1


class SlotScheduler:
    """Maps a request queue onto the engine's fixed slots (and, paged,
    onto its page pool, sharing cached prefix pages across requests).

    ``finish_reasons[uid]`` records why each request stopped:
    ``"eos"``, ``"length"`` (token budget), or ``"truncated"`` (slot
    capacity — ``max_seq``, or the page reservation when prompt +
    budget exceeded the virtual window).  ``peak_active`` tracks the
    maximum concurrently-decoding requests the run reached — the
    admission-capacity observable prefix sharing exists to raise.

    ``prefill_chunk``/``tenant_priority`` default from their env knobs
    (``APEX_TPU_PREFILL_CHUNK`` / ``APEX_TPU_TENANT_PRIORITY``);
    ``prefix_cache=False`` disables prefix sharing for this scheduler
    regardless of ``APEX_TPU_PREFIX_CACHE``.
    """

    def __init__(self, engine, telemetry: Optional[ServeTelemetry] = None,
                 *, prefix_cache: Optional[bool] = None,
                 prefill_chunk: Optional[int] = None,
                 tenant_priority: Optional[Dict[str, int]] = None,
                 max_chunks_per_pass: int = 1,
                 slo: Optional[SLOTracker] = None,
                 shed_on_overload: bool = False,
                 drafter: Optional[Drafter] = None,
                 replica_id: Optional[int] = None):
        self.engine = engine
        # fleet plumb-through (ISSUE 19): the router stamps each
        # replica's ordinal here so per-replica metric labels and
        # route_decision events can name the scheduler they hit;
        # standalone schedulers stay unlabeled (None).
        self.replica_id = replica_id
        self.queue: collections.deque = collections.deque()
        self._next_uid = 0
        self.alloc = engine.new_allocator() if engine.paged else None
        self.finish_reasons: dict = {}
        self.peak_active = 0
        # default: the global registry (env-selected sinks attach there);
        # tests pass a ServeTelemetry over a fresh registry for isolation
        self.telemetry = (telemetry if telemetry is not None
                          else ServeTelemetry())
        use_prefix = (prefix_cache if prefix_cache is not None
                      else prefix_cache_enabled())
        # host-DRAM page tier (ISSUE 18): armed when the engine carries
        # a byte budget AND prefix caching is on — the tier is the
        # prefix cache's second level, nothing else swaps.  The store
        # and the offload closure (a batched engine extract over the
        # scheduler's live cache) are both owned here; the prefix cache
        # only does bookkeeping.
        self.host_store = None
        self._pending_swaps: list = []   # deferred D2H drains (ISSUE 19)
        if engine.paged and use_prefix \
                and getattr(engine, "host_tier_bytes", 0):
            self.host_store = kv_cache.HostPageStore(
                engine.host_tier_bytes, engine.page_host_bytes())
            self.prefix = PrefixCache(self.alloc,
                                      host_store=self.host_store,
                                      offload=self._offload_pages)
        elif engine.paged and use_prefix:
            self.prefix = PrefixCache(self.alloc)
        else:
            self.prefix = None
        self.prefill_chunk = (default_prefill_chunk()
                              if prefill_chunk is None
                              else int(prefill_chunk))
        if self.prefill_chunk and not engine.paged:
            raise ValueError(
                "chunked prefill rides the paged cache's prefill_from "
                "path; this engine runs the dense slot cache")
        if self.prefill_chunk and engine.paged \
                and self.prefill_chunk % engine.page_size:
            raise ValueError(
                f"prefill chunk ({self.prefill_chunk}) must be a "
                f"multiple of page_size ({engine.page_size}) so chunk "
                f"boundaries stay page-aligned")
        self.tenant_priority = (tenant_priority_overrides()
                                if tenant_priority is None
                                else dict(tenant_priority))
        self.max_chunks_per_pass = max(1, int(max_chunks_per_pass))
        # SLO accounting (ISSUE 13): the tracker shares the telemetry's
        # registry so its burn-rate math reads the SAME histograms the
        # lifecycle methods feed; specs default from the
        # APEX_TPU_SLO_*_US knobs (none armed = the tracker only runs
        # the overload detector).  shed_on_overload lets the priority
        # admission consume the advisory: while it holds, the LOWEST
        # effective-priority queued request is rejected (reason "shed")
        # once per pass instead of starving every tenant equally.
        self.slo = (slo if slo is not None
                    else SLOTracker(self.telemetry.registry))
        self.shed_on_overload = bool(shed_on_overload)
        # speculative decoding (ISSUE 15): engines built with
        # spec_k > 0 serve their decode tokens through the batched
        # verify step; the drafter proposes, the target disposes.
        # Default drafter = prompt-lookup self-drafting (zero device
        # work); pass drafter= for a scripted/model drafter.
        self.drafter: Optional[Drafter] = drafter
        if getattr(engine, "spec_k", 0) and self.drafter is None:
            self.drafter = NGramDrafter()
        self._admit_clock = 0
        self._tenant_last_admit: Dict[str, int] = {}
        # the scheduler OWNS one cache for its lifetime (lazily built):
        # the prefix cache indexes physical pages of THIS cache, so a
        # fresh pool per run() would turn every cached prefix into a
        # dangling pointer at zeroed pages.  One allocator, one prefix
        # cache, one device cache — one lifetime.
        self.cache = None
        # per-wave slot books (begin_run .. finish_run); empty between
        # waves so run_pending() is False outside one
        self._wave_open = False
        self._run_slots: list = []
        self._run_free: list = []
        self._run_last = np.zeros((engine.slots,), np.int32)
        self._run_results: dict = {}
        if self.alloc is not None:
            self.telemetry.pool(self.alloc.free_pages,
                                self.engine.num_pages)

    def submit(self, prompt, max_new_tokens: int = 16,
               eos_id: Optional[int] = None, tenant: str = "default",
               priority: int = 0) -> int:
        """Queue one request; returns its uid (results key)."""
        tel = self.telemetry
        prompt = [int(t) for t in np.asarray(prompt).reshape(-1)]
        if not prompt:
            tel.request_rejected("empty_prompt", tenant=tenant)
            raise ValueError("empty prompt")
        if len(prompt) > self.engine.max_seq:
            tel.request_rejected("prompt_over_max_seq", tenant=tenant)
            raise ValueError(
                f"prompt length {len(prompt)} exceeds engine max_seq "
                f"{self.engine.max_seq}")
        if self.alloc is not None:
            # fail fast: a request no empty pool could ever cover would
            # otherwise stall the queue mid-run after earlier requests
            # already finished (and their results were built).  The
            # check is conservative — cold-path pages — because hits
            # cannot be known before the prefix cache is populated.
            need = self.alloc.pages_needed(len(prompt)
                                           + int(max_new_tokens))
            if need > self.engine.num_pages:
                tel.request_rejected("request_over_pool", tenant=tenant)
                raise ValueError(
                    f"request needs {need} pages of "
                    f"{self.engine.page_size} (prompt {len(prompt)} + "
                    f"budget {int(max_new_tokens)} tokens) but the "
                    f"pool has only {self.engine.num_pages}; grow "
                    f"num_pages or shrink the request")
        uid = self._next_uid
        self._next_uid += 1
        self.queue.append(Request(uid, prompt, int(max_new_tokens),
                                  eos_id, str(tenant), int(priority)))
        tel.request_submitted(uid, len(prompt), int(max_new_tokens),
                              queue_depth=len(self.queue))
        return uid

    def _offload_pages(self, page_ids):
        """Eviction-side device→host copy for the prefix cache's host
        tier (ISSUE 18): one batched extract over the scheduler's live
        cache, one store entry per page, handles back to the cache so
        its edges can transition to their ``host`` state.  Returns
        None before the first wave materializes a cache (nothing to
        copy — the eviction then discards, as without the tier).

        The drain is DEFERRED (ISSUE 19): the gather dispatches queue
        now, but the blocking ``device_get``\\ s run at the next wave
        boundary (or on the first hit against one of these handles,
        whichever comes first) — eviction inside the admission path no
        longer stalls on PCIe."""
        if self.cache is None or self.host_store is None:
            return None
        pending = self.engine.swap_out_pages(self.cache, page_ids,
                                             defer=True)
        handles = self.host_store.put_deferred(len(page_ids), pending)
        self._pending_swaps.append(pending)
        self.telemetry.page_swapped("out", len(page_ids))
        return handles

    def drain_pending_swaps(self) -> int:
        """Resolve every deferred device→host page drain (ISSUE 19):
        returns how many batches were forced.  Called at the wave
        boundary; hits against still-pending handles resolve lazily
        through the host store, so this only catches stragglers."""
        n = len(self._pending_swaps)
        for p in self._pending_swaps:
            p.resolve()
        self._pending_swaps.clear()
        return n

    def admission_cost(self, prompt) -> float:
        """Estimated admission cost in PREFILL-TOKEN EQUIVALENTS for a
        prompt, resolved against the prefix cache WITHOUT disturbing
        its LRU (a pure :meth:`PrefixCache.peek_match` probe).

        Cold tokens cost 1.0 each.  HBM-covered tokens cost 0 — the
        pages are already resident.  HOST-tier-covered tokens cost
        ``HOST_HIT_TOKEN_COST`` each (ISSUE 19 satellite): the swap-in
        upload is far cheaper than recomputing the prefix but it is
        NOT a free HBM hit — each such page still buys a fresh HBM
        page and a PCIe upload before the tail can prefill.  Pinned by
        a unit test: full-HBM hit < host hit < cold, always."""
        toks = [int(t) for t in np.asarray(prompt).reshape(-1)]
        if self.prefix is None:
            return float(len(toks))
        covered, _hbm, host = self.prefix.peek_match(toks)
        host_tokens = min(host * self.engine.page_size, covered)
        return (float(len(toks) - covered)
                + HOST_HIT_TOKEN_COST * host_tokens)

    def shed_worst(self) -> Optional[int]:
        """Public shed hook for the fleet router (ISSUE 19): reject
        the worst-ranked QUEUED request (lowest effective priority,
        most recently admitted tenant, newest) and return its uid, or
        None when nothing is queued.  Same conservation-preserving
        path as the in-loop overload shed."""
        if not self.queue:
            return None
        return self._shed_one()

    # -- admission ----------------------------------------------------------
    def _pick_index(self, worst: bool = False) -> int:
        """Queue index of the next request to admit: highest effective
        priority (request priority + tenant override); ties go to the
        LEAST recently admitted tenant (round-robin fairness under
        overload), then FIFO.  ``worst=True`` inverts the ordering —
        the shed victim: LOWEST effective priority, most recently
        admitted tenant, newest submission."""
        best_key, best_i = None, 0
        for i, req in enumerate(self.queue):
            pr = req.priority + self.tenant_priority.get(req.tenant, 0)
            key = (-pr, self._tenant_last_admit.get(req.tenant, -1), i)
            better = (best_key is None
                      or (key > best_key if worst else key < best_key))
            if better:
                best_key, best_i = key, i
        return best_i

    def _shed_one(self) -> int:
        """Reject the worst-ranked queued request under the overload
        advisory (ISSUE 13): it leaves the queue with
        ``finish_reasons[uid] == "shed"`` (no results entry), its trace
        closes with a ``rejected`` terminal span, and the shed/rejected
        counters keep the conservation law intact."""
        i = self._pick_index(worst=True)
        req = self.queue[i]
        del self.queue[i]
        self.finish_reasons[req.uid] = REASON_SHED
        self.telemetry.request_shed(req.uid, tenant=req.tenant,
                                    queue_depth=len(self.queue))
        return req.uid

    def _reservation(self, req: Request):
        """Page plan for one request, or None (backpressure).

        Paged: match the prompt against BOTH tiers of the prefix
        cache, take one shared reference per HBM-covered page, and
        ACQUIRE the private pages (uncached suffix + decode headroom
        + one fresh page per HOST-covered ordinal — swapped-out
        content needs an HBM page to land in).  Coverage is clamped
        to ``len(prompt) - 1`` — the last prompt token is always
        prefilled so its logits seed the first sampled token — which
        is exactly what makes a fully-cached prompt's boundary page a
        COW candidate.  A HOST-resident boundary page needs no COW:
        its swapped-in copy is already private to the request.  Short
        of private pages the prefix cache evicts LRU entries first
        (offloading them to the host tier when armed); only then does
        the request wait.  Returns ``(row_ids, capacity, covered,
        cow_src, swap_plan)``: ``row_ids`` the slot's full ordered
        page list, ``covered`` the shared token coverage, ``cow_src``
        the shared page to privatize before the suffix prefill writes
        mid-page (or None), ``swap_plan`` the
        ``(page_ids, k_slabs, v_slabs)`` upload the admission must
        dispatch before the tail's first prefill chunk (or None).
        Dense: ``(None, max_seq, 0, None, None)``."""
        eng = self.engine
        if not eng.paged:
            return None, eng.max_seq, 0, None, None
        ps = eng.page_size
        need_total = self.alloc.pages_needed(
            len(req.prompt) + req.max_new_tokens)
        covered, mpages, host = 0, [], []
        if self.prefix is not None:
            covered, mpages, host = self.prefix.match_tiered(req.prompt)
            covered = min(covered, len(req.prompt) - 1)
            if covered < self.prefix.min_hit_tokens:
                covered, mpages, host = 0, [], []
            else:
                n_cov = -(-covered // ps)
                mpages = mpages[:n_cov]
                host = [(j, h) for j, h in host if j < n_cov]
        full = covered // ps
        partial = covered % ps
        host_map = dict(host)
        shared = [mpages[j] for j in range(full) if j not in host_map]
        boundary_host = bool(partial) and (full in host_map)
        cow_src = (mpages[full] if partial and full not in host_map
                   else None)
        # grab the host slabs NOW (numpy refs stay valid even if the
        # host-tier LRU drops these entries while evict_lru below
        # makes room for NEW offloads)
        swap_ordinals = sorted(host_map)
        swap_slabs = [self.host_store.get(host_map[j])
                      for j in swap_ordinals]
        # pin the matched HBM pages BEFORE eviction/acquire: evict_lru
        # may release the cache's (sole) reference on exactly these
        # pages, and the LIFO acquire would then re-issue one of them
        # as a private suffix page — the same physical page mapped
        # twice into one row.  The request's own references block that.
        pinned = shared + ([cow_src] if cow_src is not None else [])
        self.alloc.share(pinned)
        need_priv = need_total - len(shared)
        if need_priv > self.alloc.free_pages and self.prefix is not None:
            freed = self.prefix.evict_lru(
                need_priv - self.alloc.free_pages)
            if freed:
                self.telemetry.prefix_evicted(self.prefix.evictions)
        priv = self.alloc.acquire(need_priv)
        if priv is None:
            if pinned:
                self.alloc.release(pinned)
            return None, 0, covered, None, None
        # assemble the row POSITIONALLY: ordinal j's page backs tokens
        # [j*ps, (j+1)*ps) — HBM ordinals reuse the shared page, host
        # ordinals take a fresh private page the swap-in fills
        priv_q = list(priv)
        row_ids, swap_ids = [], []
        for j in range(full):
            if j in host_map:
                pid = priv_q.pop(0)
                row_ids.append(pid)
                swap_ids.append(pid)
            else:
                row_ids.append(mpages[j])
        if boundary_host:
            pid = priv_q.pop(0)
            row_ids.append(pid)
            swap_ids.append(pid)
        row_ids += priv_q
        swap_plan = None
        if swap_ids:
            swap_plan = (swap_ids,
                         np.stack([s[0] for s in swap_slabs]),
                         np.stack([s[1] for s in swap_slabs]))
        return row_ids, min(len(row_ids) * ps, eng.max_seq), covered, \
            cow_src, swap_plan

    # -- the wave loop, stepwise --------------------------------------------
    # run() is begin_run() + run_pass() until run_pending() clears +
    # finish_run().  The split exists so the protocol auditor
    # (``apex_tpu/analysis/protocol_audit.py``) can drive the SAME
    # admission/prefill/decode/retire code as discrete model-checking
    # actions interleaved with submits, evictions and handoffs — the
    # code being explored is the code that serves.

    def begin_run(self, cache=None) -> None:
        """Open one wave: telemetry wave marker, cache adoption, fresh
        per-wave slot books.  ``run()`` calls this once per wave; close
        with :meth:`finish_run`."""
        if self._wave_open:
            raise RuntimeError(
                "begin_run inside an open wave: finish_run() first")
        eng = self.engine
        self.telemetry.begin_wave()
        if cache is None:
            if self.cache is None:
                self.cache = eng.init_cache()
        elif cache is not self.cache:
            # the allocator and prefix cache index PHYSICAL page ids of
            # the cache this scheduler has been serving — swapping in a
            # foreign cache would turn every cached prefix into a
            # dangling pointer at zeroed pages.  A fresh cache is only
            # adoptable while no page state references the old one.
            if self.alloc is not None and (
                    self.alloc.live_pages > 0
                    or (self.prefix is not None
                        and self.prefix.pinned_pages > 0)):
                raise ValueError(
                    "a paged SlotScheduler owns its cache for its "
                    "lifetime (the prefix cache/allocator index this "
                    "cache's physical pages); cannot substitute a "
                    "different cache while pages are live — build a "
                    "new scheduler instead")
            self.cache = cache
        self._run_slots = [None] * eng.slots
        self._run_free = list(range(eng.slots))
        self._run_last = np.zeros((eng.slots,), np.int32)
        self._run_results = {}
        self._wave_open = True

    def run_pending(self) -> bool:
        """True while the open wave still has queued or in-flight
        requests — i.e. another :meth:`run_pass` would do work."""
        return bool(self.queue
                    or any(s is not None for s in self._run_slots))

    @property
    def wave_open(self) -> bool:
        """True between :meth:`begin_run` and :meth:`finish_run`."""
        return self._wave_open

    @property
    def pending_swaps(self) -> int:
        """Deferred device→host drain batches not yet resolved — 0
        outside a wave (the boundary drains them)."""
        return len(self._pending_swaps)

    def slot_states(self) -> list:
        """Read-only view of the open wave's slot books: one
        ``_SlotState`` (or None) per slot — the protocol auditor's
        observation surface for per-row page holdings."""
        return list(self._run_slots)

    def finish_run(self) -> dict:
        """Close the wave: force any deferred eviction drains to land
        (ISSUE 19 — the dispatches have been pipelining behind the
        wave's real work; the gets happen here, out of line), close one
        SLO accounting window (burn rate / budget gauges +
        slo_violation events off the histogram deltas this wave
        contributed), then flush snapshot sinks (the Prometheus file is
        only written on export).  Returns ``{uid: generated tokens}``
        for the wave."""
        if not self._wave_open:
            raise RuntimeError("finish_run without an open wave")
        self.drain_pending_swaps()
        self.slo.observe_window()
        self.telemetry.registry.export()
        self._wave_open = False
        results, self._run_results = self._run_results, {}
        return results

    def _pool_gauges(self) -> None:
        tel = self.telemetry
        tel.pool(self.alloc.free_pages, self.engine.num_pages)
        tel.prefix_pages(
            self.alloc.shared_pages(),
            self.prefix.pinned_pages if self.prefix is not None
            else 0)
        if self.host_store is not None:
            tel.host_tier(self.host_store.pages,
                          self.host_store.bytes_used)
            tel.host_tier_evicted(self.prefix.host_evictions)

    def _retire(self, slot: int, reason: str) -> None:
        st = self._run_slots[slot]
        # token budget may have been crossed by an EOS cut
        gen = st.generated[:st.max_new_tokens]
        if st.eos_id is not None and st.eos_id in gen:
            gen = gen[:gen.index(st.eos_id) + 1]
            reason = REASON_EOS
        self._run_results[st.uid] = gen
        self.finish_reasons[st.uid] = reason
        if st.pages is not None:
            # device-side metadata evict BEFORE any page could be
            # reassigned: it re-parks the slot's page-table row on
            # the trash page, so the idle slot's masked decode
            # appends can never land in another request's pages.
            # Host-side the slot then only RELEASES its references
            # — a page the prefix cache or a prefix-sharing
            # neighbour still maps stays live until its LAST owner
            # lets go (the ISSUE 12 silent-overwrite fix).
            self.cache = self.engine.evict_slot(self.cache, slot)
            self.alloc.release(st.pages)
            self._pool_gauges()
        self._run_slots[slot] = None
        self._run_free.append(slot)    # eviction = metadata; insert
        # on re-admit overwrites the stale cache rows
        if self.drafter is not None:
            self.drafter.retire(slot)
        self.telemetry.request_finished(st.uid, reason, len(gen))

    def _prefill_piece(self, slot: int) -> None:
        """Advance one slot's prefill by one chunk (or the whole
        uncached tail when chunking is off / the tail fits)."""
        eng, tel = self.engine, self.telemetry
        st = self._run_slots[slot]
        total = st.prompt_len
        start = st.prefilled
        end = (total if not self.prefill_chunk
               else min(total, start + self.prefill_chunk))
        with tel.prefill_step(
                prompt_len=end - start,
                bucket_len=eng.bucket_for(end - start),
                uid=st.uid, start_tok=start):
            self.cache, tok, _ = eng.prefill(
                self.cache, st.prompt[:end], slot, pages=st.pages,
                prefill_from=start)
            tok = int(np.asarray(tok))
        st.prefilled = end
        if st.chunked:
            tel.prefill_chunked(st.uid, start, end - start)
        if end < total:
            return                     # more chunks to go
        # final piece: the sampled token is the request's first
        tel.first_token(st.uid)
        st.generated.append(tok)
        self._run_last[slot] = tok
        if self.drafter is not None and eng.spec_k:
            self.drafter.begin(slot, st.prompt, tok)
        if self.prefix is not None:
            ps = eng.page_size
            new = self.prefix.insert(
                st.prompt, st.pages[:-(-total // ps)])
            if new:
                self._pool_gauges()
        if st.done():
            self._retire(slot, REASON_LENGTH)

    def _admit_one(self) -> bool:
        eng, tel = self.engine, self.telemetry
        i = self._pick_index()
        row_ids, capacity, covered, cow_src, swap_plan = \
            self._reservation(self.queue[i])
        if eng.paged and row_ids is None:
            tel.backpressured()
            return False               # out of pages: wait for a retire
        req = self.queue[i]
        del self.queue[i]
        slot = self._run_free.pop()
        self._admit_clock += 1
        self._tenant_last_admit[req.tenant] = self._admit_clock
        if self.prefix is not None:
            tel.prefix_lookup(covered > 0, covered)
        tel.request_admitted(
            req.uid, slot, queue_depth=len(self.queue),
            pages=len(row_ids) if row_ids is not None else None,
            tenant=req.tenant, prefix_tokens=covered)
        if row_ids is not None:
            self._pool_gauges()
        if cow_src is not None:
            # privatize the partially-shared boundary page before
            # the suffix prefill writes into it mid-page: the copy
            # lands in the first private page of the reservation.
            # The source was pinned by _reservation only for the
            # copy window — the slot's row maps the copy, not it.
            dst = row_ids[covered // eng.page_size]
            self.cache = eng.cow_page(self.cache, cow_src, dst)
            self.alloc.release([cow_src])
            tel.cow_copied(req.uid, slot, cow_src, dst)
        if swap_plan is not None:
            # host-tier hit (ISSUE 18): upload the swapped-out
            # prefix pages into their freshly acquired rows BEFORE
            # the tail's first prefill chunk — the batched uploads
            # queue ahead of the tail's compute and the prefill
            # attends across the partially-materialized prefix via
            # prefill_from.  The prefix edges resurrect to HBM at
            # this request's insert() (the swap-in commit and the
            # cold-dedup path are the same move).
            ids, kss, vss = swap_plan
            self.cache = eng.swap_in_pages(self.cache, ids, kss, vss)
            tel.page_swapped("in", len(ids), uid=req.uid)
            tel.prefix_host_hit()
            self._pool_gauges()
        n_chunks = (1 if not self.prefill_chunk else
                    -(-(len(req.prompt) - covered)
                      // self.prefill_chunk))
        self._run_slots[slot] = _SlotState(
            req.uid, [], req.max_new_tokens, req.eos_id,
            prompt_len=len(req.prompt), capacity=capacity,
            pages=row_ids, tenant=req.tenant, prompt=req.prompt,
            prefilled=covered, chunked=n_chunks > 1)
        return True

    def run_pass(self) -> None:
        """One pass of the wave loop: admit what fits (slots, pages —
        priority/fairness ordered), advance at most
        ``max_chunks_per_pass`` prefill chunks, then ONE batched
        decode (or verify) step over the decoding slots.  The device
        sees only the fixed-shape prefill/decode (+COW copy)
        executables; everything else here is host-side bookkeeping on
        ints."""
        eng, tel = self.engine, self.telemetry
        slots = self._run_slots
        # SLO load observation (ISSUE 13): one host-side sample per
        # pass through the overload detector; while the advisory
        # holds and shedding is armed, the worst-ranked queued
        # request is rejected (at most one per pass — shedding
        # relieves pressure, it does not empty the queue)
        advisory = self.slo.observe_load(
            queue_depth=len(self.queue),
            backpressure_total=tel.backpressure_waits.total(),
            free_pages=(self.alloc.free_pages
                        if self.alloc is not None else None))
        if advisory and self.shed_on_overload and self.queue:
            self._shed_one()
        # admit: fill free slots from the queue (priority/fairness
        # ordered — a picked request the pool can't cover yet
        # blocks this pass rather than being starved)
        blocked = False
        while self.queue and self._run_free:
            if not self._admit_one():
                blocked = True
                break
        # advance prefills.  Chunking off: every pending admission
        # prefills now (the classic loop).  Chunking on: at most
        # max_chunks_per_pass chunks run BETWEEN decode steps, so a
        # long-prompt burst cannot starve in-flight decodes.
        budget = (self.max_chunks_per_pass if self.prefill_chunk
                  else eng.slots)
        chunks = 0
        for slot in range(eng.slots):
            st = slots[slot]
            if st is None or not st.prefilling():
                continue
            self._prefill_piece(slot)
            chunks += 1
            if chunks >= budget:
                break
        active = np.array(
            [s is not None and not s.prefilling()
             and bool(s.generated) for s in slots], bool)
        if not active.any():
            if any(s is not None for s in slots):
                return                 # still prefilling: next pass
            if self.queue:
                if not blocked:
                    # slots opened up mid-pass (a request finished
                    # at its prefill): admit on the next pass
                    return
                # nothing running and the picked request still
                # can't be admitted: the POOL itself is too small
                # (prefix-cache eviction already ran)
                req = self.queue[self._pick_index()]
                raise RuntimeError(
                    f"request {req.uid} needs more pages than the "
                    f"pool frees up (prompt {len(req.prompt)} + "
                    f"budget {req.max_new_tokens} tokens vs "
                    f"{self.alloc.free_pages} free pages of "
                    f"{self.alloc.page_size}); grow num_pages or "
                    f"shrink the request")
            return
        # guard: a slot at its capacity cannot take another token.
        # Lengths are derived host-side (_SlotState.cache_len) — no
        # device readback in the control loop beyond the sampled
        # tokens themselves.  The decode step's `truncated` output
        # is the device-side belt to this suspender.
        for slot, st in enumerate(slots):
            if st is not None and active[slot] \
                    and st.cache_len() >= st.capacity:
                self._retire(slot, REASON_TRUNCATED)
                active[slot] = False
        if not active.any():
            return
        # counted AFTER the capacity guard: peak_active measures
        # requests that actually decode concurrently this step
        n_active = int(active.sum())
        self.peak_active = max(self.peak_active, n_active)
        if getattr(eng, "spec_k", 0):
            # speculative wave (ISSUE 15): drafts in, the verify
            # step scores one (k+1)-slab per slot, accepted drafts
            # + bonus come out.  The emitted stream is ALWAYS the
            # target's own greedy stream; rejection already rolled
            # the device lengths back in-program, and pages were
            # reserved at admission so nothing is released here.
            k = eng.spec_k
            slab = np.zeros((eng.slots, k + 1), np.int32)
            slab[:, 0] = self._run_last
            slab[:, 1:] = self.drafter.draft_batch(active, k)
            with tel.verify_step(n_active,
                                 capacity=eng.slots) as vstep:
                self.cache, toks, n_emit, truncated = eng.verify(
                    self.cache, slab, active)
                toks = np.asarray(toks)
                n_emit = np.asarray(n_emit)
                truncated = np.asarray(truncated)
                # per-token latency back-channel: the bracket's
                # histogram sample divides by mean emitted/slot.
                # Clamped the way the consumption loop below will
                # clamp (capacity AND token budget) so a final
                # short round cannot under-report per-token
                # latency; only an eos landing mid-slab (terminal
                # for the stream) escapes the host-side mirror.
                vstep["tokens"] = float(sum(
                    min(int(n_emit[s]),
                        slots[s].capacity - slots[s].cache_len(),
                        slots[s].max_new_tokens
                        - len(slots[s].generated))
                    for s in range(eng.slots)
                    if slots[s] is not None and active[s]))
            for slot, st in enumerate(slots):
                if st is None or not active[slot]:
                    continue
                # the host capacity mirror clamps exactly like the
                # device's advance_by did (same inputs, same min)
                remaining = st.capacity - st.cache_len()
                usable = int(min(int(n_emit[slot]), remaining))
                emitted = []
                reason = None
                for t in toks[slot, :usable]:
                    st.generated.append(int(t))
                    emitted.append(int(t))
                    if st.done():
                        reason = REASON_LENGTH
                        break
                # emitted counts tokens that actually reached the
                # request (capacity- AND budget-clamped), so
                # spec_emitted == tokens_generated minus the
                # prefill-sampled firsts — conservation-testable
                tel.speculation(k, int(n_emit[slot]) - 1,
                                len(emitted))
                if emitted:
                    self._run_last[slot] = emitted[-1]
                    self.drafter.observe(slot, emitted)
                if reason is not None:
                    self._retire(slot, reason)
                elif usable < int(n_emit[slot]) or truncated[slot]:
                    # capacity cut the emitted stream short
                    self._retire(slot, REASON_TRUNCATED)
            return
        # the decode bracket closes after the token host-read the
        # loop performs anyway, so the histogram sample is the true
        # per-token latency (dispatch + sync), and its recompile
        # flag feeds serve_recompiles_total (pinned 0 by tests)
        with tel.decode_step(n_active, capacity=eng.slots):
            self.cache, toks, _, truncated = eng.decode(
                self.cache, self._run_last, active)
            toks = np.asarray(toks)
            truncated = np.asarray(truncated)
        for slot, st in enumerate(slots):
            if st is None or not active[slot]:
                continue
            if truncated[slot]:
                # the host guard above should have retired this
                # slot first; trust the device flag regardless
                self._retire(slot, REASON_TRUNCATED)
                continue
            st.generated.append(int(toks[slot]))
            self._run_last[slot] = toks[slot]
            if st.done():
                self._retire(slot, REASON_LENGTH)

    def run(self, cache=None) -> dict:
        """Drain the queue; returns ``{uid: generated token list}``.

        One :meth:`begin_run`, :meth:`run_pass` until the queue and
        slots drain, one :meth:`finish_run` — the wave boundary.  The
        (donation-threaded) cache carries into the next wave, so
        cached prefix pages stay valid across ``run()`` calls.
        """
        self.begin_run(cache)
        while self.run_pending():
            self.run_pass()
        return self.finish_run()


def generate(engine, prompts, max_new_tokens: int = 16,
             eos_id: Optional[int] = None):
    """One-shot continuous-batching run: list of prompts in, list of
    generated token lists out (submission order)."""
    sched = SlotScheduler(engine)
    uids = [sched.submit(p, max_new_tokens=max_new_tokens, eos_id=eos_id)
            for p in prompts]
    out = sched.run()
    return [out[u] for u in uids]
