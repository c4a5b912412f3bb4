"""Serving telemetry: the request lifecycle as metrics + events.

One :class:`ServeTelemetry` rides inside each
:class:`~apex_tpu.inference.scheduler.SlotScheduler` and observes the
lifecycle the scheduler already walks —

    submit -> (reject) | queue -> admit/prefill -> first token
           -> decode steps -> finish(reason)

— yielding the PAPERS.md Gemma-serving signals: TTFT and per-token
decode-latency histograms, queue depth, admitted/backpressured counters,
finish-reason counts, and the page-pool free/occupancy gauges the PR 6
scheduler computed internally but never exported.  Since ISSUE 13 the
same boundaries also drive the request tracer
(:class:`~apex_tpu.observability.spans.RequestTracer`, armed by
``APEX_TPU_TRACE``): every sampled request's lifecycle lands in the
JSONL stream as ``trace_span`` events the flight recorder renders as a
per-request waterfall.

Sync discipline: every timestamp is taken at a host point the scheduler
ALREADY occupies (it reads sampled tokens between steps by
construction), so instrumentation adds zero device reads; the decode
bracket deliberately closes after the scheduler's token read, making the
sample the true per-token latency, and its recompile flag feeds
``serve_recompiles_total`` — which the L1 integration test pins at 0.
"""
from __future__ import annotations

import contextlib
import time
from typing import Optional

from apex_tpu_torch.observability.registry import MetricsRegistry
from apex_tpu_torch.observability.spans import RequestTracer
from apex_tpu_torch.observability.timers import StepTimer

__all__ = ["ServeTelemetry", "FleetTelemetry", "SPEC_METRIC_FAMILIES",
           "TIER_METRIC_FAMILIES", "FLEET_METRIC_FAMILIES"]

#: the ISSUE 15 speculation families (schema-guard tested: every name
#: here must be pinned in ``.telemetry_schema.json`` — the
#: NUMERICS_METRIC_FAMILIES pattern)
SPEC_METRIC_FAMILIES = (
    "serve_spec_verify_steps_total",
    "serve_spec_drafted_tokens_total",
    "serve_spec_accepted_tokens_total",
    "serve_spec_emitted_tokens_total",
    "serve_spec_acceptance_rate",
    "infer_decode_fused_dispatch_total",
    "infer_verify_dispatch_total",
)

#: the ISSUE 18 host-page-tier families (same schema-guard contract as
#: SPEC_METRIC_FAMILIES: every name pinned in ``.telemetry_schema.json``)
TIER_METRIC_FAMILIES = (
    "serve_swap_out_pages_total",
    "serve_swap_in_pages_total",
    "serve_host_tier_pages",
    "serve_host_tier_bytes",
    "serve_host_tier_evictions_total",
    "serve_prefix_host_hits_total",
    "infer_swap_out_dispatch_total",
    "infer_swap_in_dispatch_total",
)

#: the ISSUE 19 fleet-front-door families (same schema-guard contract
#: as SPEC/TIER_METRIC_FAMILIES: every name pinned in
#: ``.telemetry_schema.json``)
FLEET_METRIC_FAMILIES = (
    "fleet_requests_submitted_total",
    "fleet_requests_routed_total",
    "fleet_requests_shed_total",
    "fleet_prefix_affinity_hits_total",
    "fleet_affinity_spills_total",
    "fleet_routed_prefix_tokens_total",
    "fleet_replica_queue_depth",
    "fleet_replica_free_pages",
    "fleet_replica_overloaded",
)


class FleetTelemetry:
    """Front-door routing accounting for the ISSUE 19 fleet router:
    per-replica-labeled routing/shed counters, the replica load gauges
    the router samples while deciding, and one ``route_decision``
    JSONL event per submit.

    The router-side half of the fleet conservation law (the other half
    is each replica's own :meth:`ServeTelemetry.conservation`):
    every front-door submit is either ROUTED to exactly one replica or
    SHED at the router (``replica="router"``), so
    ``submitted == Σ routed + shed{router}``."""

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        if registry is None:
            from apex_tpu_torch.observability import configure_from_env
            registry = configure_from_env()
        self.registry = registry
        d = registry.declared
        self.submitted = d("fleet_requests_submitted_total")
        self.routed = d("fleet_requests_routed_total")
        self.shed = d("fleet_requests_shed_total")
        self.affinity_hits = d("fleet_prefix_affinity_hits_total")
        self.affinity_spills = d("fleet_affinity_spills_total")
        self.routed_prefix_tokens = d("fleet_routed_prefix_tokens_total")
        self.replica_queue_depth = d("fleet_replica_queue_depth")
        self.replica_free_pages = d("fleet_replica_free_pages")
        self.replica_overloaded = d("fleet_replica_overloaded")

    def request_submitted(self) -> None:
        """One request reached the front door (pre-routing)."""
        self.submitted.inc()

    def replica_load(self, replica: int, queue_depth: int,
                     free_pages: Optional[int],
                     overloaded: bool) -> None:
        """Gauge refresh for one replica's load as the router saw it
        while deciding (queue depth, free pages, overload advisory)."""
        r = str(int(replica))
        self.replica_queue_depth.set(int(queue_depth), replica=r)
        if free_pages is not None:
            self.replica_free_pages.set(int(free_pages), replica=r)
        self.replica_overloaded.set(1 if overloaded else 0, replica=r)

    def route(self, uid: int, replica: int, policy: str,
              prefix_tokens: int = 0, queue_depth: int = 0,
              free_pages: Optional[int] = None,
              overloaded: bool = False, spilled: bool = False) -> None:
        """One routing decision: the request went to ``replica``.
        ``prefix_tokens`` is the read-only peek coverage found there;
        ``spilled`` marks an affinity pick diverted by the load spill
        threshold."""
        r = str(int(replica))
        self.routed.inc(replica=r)
        if prefix_tokens:
            self.affinity_hits.inc()
            self.routed_prefix_tokens.inc(int(prefix_tokens), replica=r)
        if spilled:
            self.affinity_spills.inc()
        self.registry.emit_event(
            "route_decision", uid=int(uid), replica=int(replica),
            policy=str(policy), prefix_tokens=int(prefix_tokens),
            queue_depth=int(queue_depth),
            free_pages=int(free_pages) if free_pages is not None
            else None, overloaded=bool(overloaded),
            spilled=bool(spilled))

    def request_shed(self, replica: Optional[int] = None) -> None:
        """One request shed by cross-replica overload routing: from
        ``replica``'s queue, or at the front door before reaching any
        queue (``replica=None`` → the ``"router"`` label)."""
        self.shed.inc(replica="router" if replica is None
                      else str(int(replica)))

    def conservation(self) -> dict:
        """Router-side half of the fleet conservation law:
        ``submitted == routed + shed{router}``."""
        return {
            "submitted": int(self.submitted.total()),
            "routed": int(self.routed.total()),
            "router_shed": int(self.shed.value(replica="router")),
        }


class ServeTelemetry:

    def __init__(self, registry: Optional[MetricsRegistry] = None, *,
                 trace: Optional[int] = None):
        if registry is None:
            # default = the global registry with env-selected sinks
            # attached (lazy import: this module is part of the package)
            from apex_tpu_torch.observability import configure_from_env
            registry = configure_from_env()
        reg = registry
        self.registry = reg
        d = reg.declared
        self.submitted = d("serve_requests_submitted_total")
        self.rejected = d("serve_requests_rejected_total")
        self.admitted = d("serve_requests_admitted_total")
        self.finished = d("serve_requests_finished_total")
        self.backpressure_waits = d("serve_backpressure_waits_total")
        self.tokens_generated = d("serve_tokens_generated_total")
        self.decode_steps = d("serve_decode_steps_total")
        self.recompiles = d("serve_recompiles_total")
        self.queue_depth = d("serve_queue_depth")
        self.active_slots = d("serve_active_slots")
        self.peak_active = d("serve_peak_active")
        self.free_pages = d("serve_free_pages")
        self.pool_occupancy = d("serve_page_pool_occupancy")
        self.ttft = d("serve_ttft_seconds")
        self.prefill_seconds = d("serve_prefill_seconds")
        self.decode_token_seconds = d("serve_decode_token_seconds")
        # goodput decomposition (ISSUE 10): where the fixed-shape
        # executables' token-slots actually went
        self.prefill_pad_tokens = d(
            "serve_badput_prefill_pad_tokens_total")
        self.idle_slot_tokens = d(
            "serve_badput_idle_slot_tokens_total")
        self.truncated_tokens = d(
            "serve_badput_truncated_tokens_total")
        # shared-prefix serving (ISSUE 12): prefix-cache effectiveness,
        # page sharing, copy-on-write, chunked prefill, tenants
        self.prefix_hits = d("serve_prefix_cache_hits_total")
        self.prefix_misses = d("serve_prefix_cache_misses_total")
        self.prefix_hit_tokens = d("serve_prefix_hit_tokens_total")
        self.prefix_hit_rate = d("serve_prefix_cache_hit_rate")
        self.shared_pages = d("serve_prefix_shared_pages")
        self.prefix_cache_pages = d("serve_prefix_cache_pages")
        self.prefix_evictions = d("serve_prefix_cache_evictions_total")
        self.cow_copies = d("serve_cow_copies_total")
        self.prefill_chunks = d("serve_prefill_chunks_total")
        self.tenant_admitted = d("serve_tenant_admitted_total")
        self.tenant_rejected = d("serve_tenant_rejected_total")
        self.shed = d("serve_requests_shed_total")
        # speculative decoding (ISSUE 15): verify-round accounting.
        # spec_step_seconds is a host-side wall-clock tally of RAW
        # verify-step time (the histogram carries per-token samples),
        # read by the bench speculation leg — not an exported family.
        self.spec_verify_steps = d("serve_spec_verify_steps_total")
        self.spec_drafted = d("serve_spec_drafted_tokens_total")
        self.spec_accepted = d("serve_spec_accepted_tokens_total")
        self.spec_emitted = d("serve_spec_emitted_tokens_total")
        self.spec_acceptance = d("serve_spec_acceptance_rate")
        self.spec_step_seconds = 0.0
        # tiered KV memory (ISSUE 18): host-DRAM page-tier accounting —
        # pages crossing the HBM<->host boundary, tier residency gauges,
        # host-LRU drops, and hits served by uploads instead of compute
        self.swap_out_pages = d("serve_swap_out_pages_total")
        self.swap_in_pages = d("serve_swap_in_pages_total")
        self.host_tier_pages = d("serve_host_tier_pages")
        self.host_tier_bytes = d("serve_host_tier_bytes")
        self.host_tier_evictions = d("serve_host_tier_evictions_total")
        self.prefix_host_hits = d("serve_prefix_host_hits_total")
        # request tracing (ISSUE 13): spans ride the SAME host
        # boundaries the methods below already occupy — arming the
        # tracer (trace= or APEX_TPU_TRACE) adds zero device work
        self.tracer = RequestTracer(reg, sample=trace)
        # separate timers: prefill legitimately compiles once per prompt
        # bucket, and must not advance the decode timer past its warmup
        # step (which would mislabel decode's one compile a recompile)
        self._prefill_timer = StepTimer()
        self._decode_timer = StepTimer()
        self._submit_ts: dict = {}
        self._first_token_seen: set = set()

    # -- lifecycle ----------------------------------------------------------
    def begin_wave(self) -> None:
        """A scheduler ``run()`` started (trace spans admitted from
        here carry the new wave index)."""
        self.tracer.begin_wave()

    def request_submitted(self, uid: int, prompt_len: int,
                          max_new_tokens: int, queue_depth: int) -> None:
        self.submitted.inc()
        self.queue_depth.set(queue_depth)
        self._submit_ts[uid] = time.perf_counter()
        self.tracer.request_submitted(uid, self._submit_ts[uid])
        self.registry.emit_event(
            "request_submit", uid=int(uid), prompt_len=int(prompt_len),
            max_new_tokens=int(max_new_tokens),
            queue_depth=int(queue_depth))

    def request_rejected(self, reason: str,
                         tenant: str = "default") -> None:
        """A submission that failed validation (counted as submitted —
        conservation: submitted == finished + active + rejected)."""
        self.submitted.inc()
        self.rejected.inc(reason=reason)
        self.tenant_rejected.inc(tenant=str(tenant))

    def request_shed(self, uid: int, tenant: str = "default",
                     queue_depth: Optional[int] = None) -> None:
        """A QUEUED request rejected by the overload shedding advisory
        (ISSUE 13).  Rides the ``rejected`` side of the conservation
        law — it was already counted submitted at submit() — and closes
        the request's trace with a ``rejected`` terminal span so no
        trace dangles."""
        self.rejected.inc(reason="shed")
        self.shed.inc(tenant=str(tenant))
        if queue_depth is not None:
            self.queue_depth.set(queue_depth)
        self._submit_ts.pop(uid, None)
        self._first_token_seen.discard(uid)
        self.tracer.request_rejected(uid, "shed")
        self.registry.emit_event(
            "request_shed", uid=int(uid), tenant=str(tenant),
            queue_depth=int(queue_depth) if queue_depth is not None
            else -1)

    def request_admitted(self, uid: int, slot: int, queue_depth: int,
                         pages: Optional[int] = None,
                         tenant: str = "default",
                         prefix_tokens: int = 0) -> None:
        self.admitted.inc()
        self.tenant_admitted.inc(tenant=str(tenant))
        self.queue_depth.set(queue_depth)
        wait = time.perf_counter() - self._submit_ts.get(
            uid, time.perf_counter())
        self.tracer.request_admitted(uid, slot, pages=pages,
                                     prefix_tokens=prefix_tokens)
        self.registry.emit_event(
            "request_admit", uid=int(uid), slot=int(slot),
            wait_s=round(wait, 9),
            pages=int(pages) if pages is not None else None,
            tenant=str(tenant), prefix_tokens=int(prefix_tokens))

    # -- shared-prefix serving (ISSUE 12) -----------------------------------
    def prefix_lookup(self, hit: bool, tokens_reused: int) -> None:
        """One prefix-cache lookup at admission: hit/miss tally plus
        the prompt tokens served from shared pages instead of prefill
        compute; the hit-rate gauge tracks the running ratio."""
        (self.prefix_hits if hit else self.prefix_misses).inc()
        if tokens_reused:
            self.prefix_hit_tokens.inc(tokens_reused)
        hits = self.prefix_hits.total()
        total = hits + self.prefix_misses.total()
        if total:
            self.prefix_hit_rate.set(hits / total)

    def prefix_pages(self, shared: int, cached: int) -> None:
        """Gauge refresh: pages held by more than one owner, and pages
        pinned by the host prefix cache."""
        self.shared_pages.set(shared)
        self.prefix_cache_pages.set(cached)

    def prefix_evicted(self, total_evictions: int) -> None:
        """Sync the eviction counter to the cache's lifetime tally
        (called after an LRU sweep)."""
        done = self.prefix_evictions.total()
        if total_evictions > done:
            self.prefix_evictions.inc(total_evictions - done)

    def page_swapped(self, direction: str, pages: int,
                     uid: Optional[int] = None) -> None:
        """``pages`` KV pages crossed the HBM<->host boundary in one
        batched copy: ``direction`` is ``"out"`` when LRU eviction
        offloaded prefix pages to the host tier, ``"in"`` when a hit on
        a swapped-out prefix uploaded them back.  ``uid`` tags swap-ins
        with the admitting request; swap-outs have no single owner."""
        (self.swap_out_pages if direction == "out"
         else self.swap_in_pages).inc(pages)
        self.registry.emit_event(
            "page_swap", uid=int(uid) if uid is not None else None,
            direction=str(direction), pages=int(pages))

    def host_tier(self, pages: int, bytes_used: int) -> None:
        """Gauge refresh: pages resident in the host-DRAM tier and the
        bytes they hold against the configured budget."""
        self.host_tier_pages.set(pages)
        self.host_tier_bytes.set(bytes_used)

    def host_tier_evicted(self, total_evictions: int) -> None:
        """Sync the host-tier eviction counter to the prefix cache's
        lifetime tally (the :meth:`prefix_evicted` delta pattern) —
        counts pages dropped from the HOST tier entirely, i.e. prefixes
        that will cost recompute if requested again."""
        done = self.host_tier_evictions.total()
        if total_evictions > done:
            self.host_tier_evictions.inc(total_evictions - done)

    def prefix_host_hit(self) -> None:
        """One admission whose matched prefix was (partly) host-resident
        — served by swap-in uploads instead of prefill recompute."""
        self.prefix_host_hits.inc()

    def cow_copied(self, uid: int, slot: int, src: int, dst: int) -> None:
        """One copy-on-write page duplication (a slot privatized a
        shared page before writing into it)."""
        self.cow_copies.inc()
        self.tracer.cow_copy(uid, src, dst)
        self.registry.emit_event("cow_copy", uid=int(uid),
                                 slot=int(slot), src=int(src),
                                 dst=int(dst))

    def prefill_chunked(self, uid: int, start: int, tokens: int) -> None:
        """One chunk of a split (chunked) prefill dispatched."""
        self.prefill_chunks.inc()
        self.registry.emit_event("prefill_chunk", uid=int(uid),
                                 start=int(start), tokens=int(tokens))

    @contextlib.contextmanager
    def prefill_step(self, prompt_len: Optional[int] = None,
                     bucket_len: Optional[int] = None,
                     uid: Optional[int] = None, start_tok: int = 0):
        """Bracket one admission's prefill dispatch + first-token read.

        ``prompt_len``/``bucket_len`` (when the scheduler knows them)
        feed the padding-badput counter: the bucket positions beyond
        the prompt are compute the fixed-shape executable spends on
        padding rows.  ``uid``/``start_tok`` (when the scheduler passes
        them) close a ``prefill_chunk`` span on the request's trace —
        one span per dispatched piece, monolithic prefill included."""
        t_begin = time.perf_counter()
        self._prefill_timer.start()
        try:
            yield
        finally:
            sample = self._prefill_timer.stop()
            self.prefill_seconds.observe(sample.seconds)
            if prompt_len is not None and bucket_len is not None \
                    and bucket_len > prompt_len:
                self.prefill_pad_tokens.inc(bucket_len - prompt_len)
            if uid is not None:
                self.tracer.prefill_chunk(
                    uid, t_begin, sample.seconds, start_tok,
                    prompt_len if prompt_len is not None else 0,
                    bucket=bucket_len)

    def first_token(self, uid: int) -> None:
        """The request's first token reached the host: observe TTFT."""
        if uid in self._first_token_seen:
            return
        self._first_token_seen.add(uid)
        t0 = self._submit_ts.get(uid)
        if t0 is None:
            return
        ttft = time.perf_counter() - t0
        self.ttft.observe(ttft)
        self.tracer.first_token(uid, ttft)
        self.registry.emit_event("request_first_token", uid=int(uid),
                                 ttft_s=round(ttft, 9))

    @contextlib.contextmanager
    def _step_bracket(self, counter, active: int,
                      capacity: Optional[int], spec: bool):
        """One shared bracket for the decode/verify dispatch + token
        read: gauges, the step timer, the per-token histogram sample,
        the recompile counter and the idle-slot badput — one copy so
        the two step kinds cannot silently diverge.  The yielded dict
        is the verify path's back-channel: the scheduler drops the
        step's emitted-token count into ``holder["tokens"]`` so the
        histogram sample stays PER-TOKEN (step seconds divided by mean
        tokens per active slot) — the semantics the SLO tracker's
        decode_token_p99 objective and every dashboard assume."""
        self.active_slots.set(active)
        self.peak_active.set_max(active)
        holder: dict = {}
        self._decode_timer.start()
        try:
            yield holder
        finally:
            sample = self._decode_timer.stop()
            counter.inc()
            if spec:
                self.spec_step_seconds += sample.seconds
                per_slot = (holder.get("tokens", float(active))
                            / max(active, 1))
                self.decode_token_seconds.observe(
                    sample.seconds / max(per_slot, 1.0))
            else:
                self.decode_token_seconds.observe(sample.seconds)
            if sample.recompiled:
                self.recompiles.inc()
            if capacity is not None and capacity > active:
                self.idle_slot_tokens.inc(capacity - active)

    @contextlib.contextmanager
    def decode_step(self, active: int, capacity: Optional[int] = None):
        """Bracket one batched decode: dispatch + the scheduler's token
        read.  One sample = one token per active slot.  ``capacity``
        (the executable's slot width) feeds the idle-slot badput
        counter: inactive slots compute masked garbage every step."""
        with self._step_bracket(self.decode_steps, active, capacity,
                                spec=False):
            yield

    @contextlib.contextmanager
    def verify_step(self, active: int, capacity: Optional[int] = None):
        """Bracket one batched speculative-verify dispatch + the
        scheduler's token read (ISSUE 15).  Yields the holder dict the
        scheduler fills with ``"tokens"`` (the step's emitted count
        across active slots) so the decode-latency histogram sample is
        the EFFECTIVE per-token latency (step seconds / mean tokens
        per active slot) — arming speculation must not read as a
        per-token latency regression to the SLO tracker, whose
        decode_token_p99 objective consumes this histogram.  Raw step
        wall time accumulates in :attr:`spec_step_seconds` (host-side,
        the bench speculation leg's clock); the recompile flag feeds
        the same pinned-zero counter, because the verify step is as
        much ONE donated executable as decode is."""
        with self._step_bracket(self.spec_verify_steps, active,
                                capacity, spec=True) as holder:
            yield holder

    def speculation(self, drafted: int, accepted: int,
                    emitted: int) -> None:
        """One slot's accept/reject outcome for one verify round:
        ``drafted`` tokens were scored, ``accepted`` of them matched
        the target's greedy stream, ``emitted`` tokens (accepted +
        bonus, capacity-clamped) reached the request.  The acceptance
        gauge tracks the lifetime ratio."""
        if drafted:
            self.spec_drafted.inc(drafted)
        if accepted:
            self.spec_accepted.inc(accepted)
        if emitted:
            self.spec_emitted.inc(emitted)
        total = self.spec_drafted.total()
        if total:
            self.spec_acceptance.set(self.spec_accepted.total() / total)

    def backpressured(self) -> None:
        self.backpressure_waits.inc()

    def request_finished(self, uid: int, reason: str,
                         n_tokens: int) -> None:
        self.finished.inc(reason=reason)
        self.tokens_generated.inc(n_tokens)
        if reason == "truncated":
            self.truncated_tokens.inc(n_tokens)
        t0 = self._submit_ts.pop(uid, None)
        self._first_token_seen.discard(uid)
        self.tracer.request_finished(uid, reason, n_tokens)
        e2e = (time.perf_counter() - t0) if t0 is not None else 0.0
        self.registry.emit_event(
            "request_finish", uid=int(uid), reason=str(reason),
            tokens=int(n_tokens), e2e_s=round(e2e, 9))

    def pool(self, free: int, total: int) -> None:
        self.free_pages.set(free)
        if total > 0:
            self.pool_occupancy.set(1.0 - free / total)

    # -- bookkeeping views --------------------------------------------------
    def goodput(self) -> dict:
        """Token-level goodput decomposition: generated tokens vs the
        token-slots the fixed-shape executables spent on bucket padding
        and idle decode lanes, plus the truncation-wasted share of the
        generated tokens.  ``goodput_fraction`` = generated / (generated
        + padding + idle) — the device-work share that became tokens."""
        gen = float(self.tokens_generated.total())
        pad = float(self.prefill_pad_tokens.total())
        idle = float(self.idle_slot_tokens.total())
        spent = gen + pad + idle
        return {
            "generated_tokens": gen,
            "prefill_pad_tokens": pad,
            "idle_slot_tokens": idle,
            "truncated_tokens": float(self.truncated_tokens.total()),
            "goodput_fraction": gen / spent if spent > 0 else None,
        }

    def conservation(self) -> dict:
        """The lifecycle conservation law the scheduler tests assert:
        ``submitted == finished + active + rejected`` (active = admitted
        or queued, i.e. submit timestamps not yet retired)."""
        return {
            "submitted": int(self.submitted.total()),
            "finished": int(self.finished.total()),
            "rejected": int(self.rejected.total()),
            "active": len(self._submit_ts),
        }

    def summary(self) -> dict:
        """Human-oriented digest (examples/generate.py prints this)."""
        out = {
            "requests": int(self.finished.total()),
            "tokens": int(self.tokens_generated.total()),
            "decode_steps": int(self.decode_steps.total()),
            "recompiles": int(self.recompiles.total()),
        }
        lookups = self.prefix_hits.total() + self.prefix_misses.total()
        if lookups:
            out["prefix_hits"] = int(self.prefix_hits.total())
            out["prefix_misses"] = int(self.prefix_misses.total())
            out["prefix_hit_tokens"] = int(self.prefix_hit_tokens.total())
            out["prefix_hit_rate"] = round(
                self.prefix_hits.total() / lookups, 4)
            out["cow_copies"] = int(self.cow_copies.total())
        if self.prefill_chunks.total():
            out["prefill_chunks"] = int(self.prefill_chunks.total())
        if self.swap_out_pages.total() or self.swap_in_pages.total():
            out["swap_out_pages"] = int(self.swap_out_pages.total())
            out["swap_in_pages"] = int(self.swap_in_pages.total())
            out["prefix_host_hits"] = int(self.prefix_host_hits.total())
            out["host_tier_evictions"] = int(
                self.host_tier_evictions.total())
        if self.spec_verify_steps.total():
            out["verify_steps"] = int(self.spec_verify_steps.total())
            out["spec_drafted"] = int(self.spec_drafted.total())
            out["spec_accepted"] = int(self.spec_accepted.total())
            out["spec_emitted"] = int(self.spec_emitted.total())
            if self.spec_drafted.total():
                out["spec_acceptance_rate"] = round(
                    self.spec_accepted.total()
                    / self.spec_drafted.total(), 4)
        if self.tracer.enabled():
            out["trace_spans"] = int(self.tracer.spans.total())
        if self.shed.total():
            out["shed"] = int(self.shed.total())
        for name, hist in (("ttft", self.ttft),
                           ("decode_token", self.decode_token_seconds)):
            if hist.count():
                out[f"{name}_p50_s"] = hist.quantile(0.5)
                out[f"{name}_p99_s"] = hist.quantile(0.99)
                out[f"{name}_mean_s"] = round(
                    hist.sum() / hist.count(), 9)
        return out
