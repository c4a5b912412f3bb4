"""The pinned telemetry schema: every metric family and JSONL event the
runtime emits, declared ONCE.

Dashboards and log pipelines consume the Prometheus text file and the
JSONL event stream by field name; a silent rename breaks them without a
test failing anywhere.  This module is therefore the single source of
truth, mirrored to the committed ``.telemetry_schema.json`` and gated by
``tests/L0/run_observability/test_schema_guard.py`` exactly like the
SPMD comm/HBM budget ledger (``.analysis_budget.json``): the committed
file must match :func:`current_schema` bit-for-bit, and instruments can
only be created FROM these declarations
(:meth:`~apex_tpu.observability.registry.MetricsRegistry.declared`
raises on an undeclared name), so the code cannot emit a family the
schema does not pin.

To change the schema: edit the declarations here, then re-pin with

    python -m apex_tpu.observability.schema --write

and commit both files — the conscious-rename workflow, same as
``apex-tpu-analyze --spmd --write-budget``.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

__all__ = ["MetricSpec", "METRIC_SPECS", "EVENT_FIELDS", "SCHEMA_NAME",
           "SCHEMA_VERSION", "current_schema", "main"]

SCHEMA_NAME = ".telemetry_schema.json"
SCHEMA_VERSION = 1

#: histogram bucket upper bounds, seconds.  Decode hands one token per
#: slot per step, so its buckets start an order of magnitude finer than
#: the request-level latencies (TTFT spans prefill compile + forward).
DECODE_LATENCY_BUCKETS_S: Tuple[float, ...] = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 1.0)
REQUEST_LATENCY_BUCKETS_S: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
    5.0, 10.0, 30.0)
STEP_TIME_BUCKETS_S: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
    5.0, 15.0, 60.0)
#: global grad-norm histogram bounds (ISSUE 11 numerics mode):
#: log-spaced over the 7 decades a healthy-to-diverging LLM run spans —
#: a loss spike is a mass shift rightward across these, visible at
#: bucket resolution without storing per-step samples.
GRAD_NORM_BUCKETS: Tuple[float, ...] = (
    0.0001, 0.0003, 0.001, 0.003, 0.01, 0.03, 0.1, 0.3, 1.0, 3.0,
    10.0, 30.0, 100.0, 1000.0)


@dataclass(frozen=True)
class MetricSpec:
    name: str
    kind: str                              # counter | gauge | histogram
    help: str
    labels: Tuple[str, ...] = ()
    buckets: Optional[Tuple[float, ...]] = None   # histograms only

    def __post_init__(self):
        if self.kind not in ("counter", "gauge", "histogram"):
            raise ValueError(f"{self.name}: unknown kind {self.kind!r}")
        if (self.buckets is not None) != (self.kind == "histogram"):
            raise ValueError(f"{self.name}: buckets iff histogram")


METRIC_SPECS: Dict[str, MetricSpec] = {s.name: s for s in [
    # -- serving (SlotScheduler / ServeTelemetry) -------------------------
    MetricSpec("serve_requests_submitted_total", "counter",
               "requests handed to SlotScheduler.submit (pre-validation)"),
    MetricSpec("serve_requests_rejected_total", "counter",
               "submissions rejected at validation (never queued)",
               labels=("reason",)),
    MetricSpec("serve_requests_admitted_total", "counter",
               "requests admitted into a cache slot (prefill issued)"),
    MetricSpec("serve_requests_finished_total", "counter",
               "requests retired, keyed by the scheduler finish reason",
               labels=("reason",)),
    MetricSpec("serve_backpressure_waits_total", "counter",
               "admission passes deferred for lack of free KV pages"),
    MetricSpec("serve_tokens_generated_total", "counter",
               "tokens returned to finished requests"),
    MetricSpec("serve_decode_steps_total", "counter",
               "batched decode executions (one token per active slot)"),
    MetricSpec("serve_recompiles_total", "counter",
               "decode steps that triggered a NEW compile after warmup "
               "(must stay 0: decode is ONE donated executable)"),
    MetricSpec("serve_queue_depth", "gauge",
               "requests waiting in the scheduler queue"),
    MetricSpec("serve_active_slots", "gauge",
               "slots decoding concurrently this step"),
    MetricSpec("serve_peak_active", "gauge",
               "max concurrently-decoding requests the run reached"),
    MetricSpec("serve_free_pages", "gauge",
               "KV page-pool pages currently free (paged engines)"),
    MetricSpec("serve_page_pool_occupancy", "gauge",
               "fraction of the KV page pool in use, 0..1 (paged)"),
    MetricSpec("serve_ttft_seconds", "histogram",
               "submit -> first token on host (time to first token)",
               buckets=REQUEST_LATENCY_BUCKETS_S),
    MetricSpec("serve_prefill_seconds", "histogram",
               "prefill dispatch + first-token host read, per admission",
               buckets=REQUEST_LATENCY_BUCKETS_S),
    MetricSpec("serve_decode_token_seconds", "histogram",
               "one decode step: dispatch + sampled-token host read "
               "(= per-token latency; one token per slot per step)",
               buckets=DECODE_LATENCY_BUCKETS_S),
    # -- serving goodput (ISSUE 10): where the device's token-slots go --
    MetricSpec("serve_badput_prefill_pad_tokens_total", "counter",
               "prefill token positions computed as bucket padding "
               "(bucket length minus prompt length, per admission)"),
    MetricSpec("serve_badput_idle_slot_tokens_total", "counter",
               "decode token-slots computed for INACTIVE slots "
               "(capacity minus active, per decode step) — masked "
               "garbage the fixed-shape executable pays for anyway"),
    MetricSpec("serve_badput_truncated_tokens_total", "counter",
               "tokens generated by requests that finished 'truncated' "
               "(slot/page capacity cut the stream short)"),
    # -- shared-prefix serving (ISSUE 12): prefix cache, page sharing,
    #    copy-on-write, chunked prefill, per-tenant admission ----------
    MetricSpec("serve_prefix_cache_hits_total", "counter",
               "admissions whose prompt extended a cached prefix "
               "(shared pages written into the slot's page-table row)"),
    MetricSpec("serve_prefix_cache_misses_total", "counter",
               "admissions that found no cached prefix (cold prefill)"),
    MetricSpec("serve_prefix_hit_tokens_total", "counter",
               "prompt tokens served from shared prefix pages instead "
               "of prefill compute (summed over admissions)"),
    MetricSpec("serve_prefix_cache_hit_rate", "gauge",
               "hits / (hits + misses) over the scheduler's lifetime, "
               "0..1 (set after every prefix-cache lookup)"),
    MetricSpec("serve_prefix_shared_pages", "gauge",
               "KV pages currently held by MORE than one owner "
               "(requests and/or the prefix cache)"),
    MetricSpec("serve_prefix_cache_pages", "gauge",
               "KV pages currently pinned by the host prefix cache"),
    MetricSpec("serve_prefix_cache_evictions_total", "counter",
               "prefix-cache entries evicted (LRU, under page "
               "backpressure)"),
    MetricSpec("serve_cow_copies_total", "counter",
               "copy-on-write page copies: a slot privatized a page it "
               "shared before writing into it"),
    MetricSpec("serve_prefill_chunks_total", "counter",
               "chunked-prefill continuation chunks dispatched "
               "(long prompts split so decode steps interleave)"),
    MetricSpec("serve_tenant_admitted_total", "counter",
               "requests admitted, keyed by tenant (fairness "
               "observable under overload)", labels=("tenant",)),
    MetricSpec("serve_tenant_rejected_total", "counter",
               "submissions rejected at validation, keyed by tenant",
               labels=("tenant",)),
    # -- tiered KV memory (ISSUE 18): host-DRAM prefix-page offload.
    #    Swap-outs ride LRU eviction (page contents copied to host
    #    before the HBM page returns to the free list); swap-ins ride
    #    admissions whose matched prefix is host-resident.
    MetricSpec("serve_swap_out_pages_total", "counter",
               "KV pages offloaded HBM -> host-DRAM tier at prefix "
               "eviction (contents survive; the HBM page is freed)"),
    MetricSpec("serve_swap_in_pages_total", "counter",
               "KV pages uploaded host -> HBM on a hit against a "
               "swapped-out prefix (recompute avoided)"),
    MetricSpec("serve_host_tier_pages", "gauge",
               "KV pages currently resident in the host-DRAM tier"),
    MetricSpec("serve_host_tier_bytes", "gauge",
               "bytes held by the host-DRAM page tier (against "
               "APEX_TPU_HOST_KV_TIER_BYTES)"),
    MetricSpec("serve_host_tier_evictions_total", "counter",
               "pages dropped from the HOST tier entirely (host-LRU "
               "under byte-budget pressure) — a re-request recomputes"),
    MetricSpec("serve_prefix_host_hits_total", "counter",
               "admissions whose matched prefix was (partly) host-"
               "resident and was served by swap-in uploads"),
    # -- speculative decoding (ISSUE 15): the verify step's accept/
    #    reject accounting.  Drafted counts what the verify executable
    #    SCORED (k per active slot per round, padding drafts
    #    included); accepted excludes the bonus token; emitted =
    #    accepted + bonus = tokens handed to requests by verify steps.
    MetricSpec("serve_spec_verify_steps_total", "counter",
               "batched speculative verify executions (one slab of "
               "k drafts + bonus per active slot)"),
    MetricSpec("serve_spec_drafted_tokens_total", "counter",
               "draft tokens scored by verify steps (k per active "
               "slot per round)"),
    MetricSpec("serve_spec_accepted_tokens_total", "counter",
               "draft tokens accepted (matched the target's greedy "
               "token; bonus tokens not counted)"),
    MetricSpec("serve_spec_emitted_tokens_total", "counter",
               "tokens emitted by verify steps (accepted drafts + "
               "one bonus/correction per slot per round)"),
    MetricSpec("serve_spec_acceptance_rate", "gauge",
               "lifetime accepted/drafted ratio, 0..1 (set after "
               "every verify round)"),
    # -- request tracing + SLO accounting (ISSUE 13) ----------------------
    MetricSpec("serve_trace_spans_total", "counter",
               "trace_span events emitted by the request tracer "
               "(APEX_TPU_TRACE-sampled request lifecycles)"),
    MetricSpec("serve_requests_shed_total", "counter",
               "queued requests rejected by the overload shedding "
               "advisory (lowest effective priority first), keyed by "
               "tenant", labels=("tenant",)),
    MetricSpec("serve_overload", "gauge",
               "overload advisory (0/1): sustained queue pressure or "
               "backpressure with no free-page recovery over the "
               "detector window"),
    MetricSpec("slo_burn_rate", "gauge",
               "per-window error-budget burn rate, keyed by SLO: "
               "window violation fraction / error budget (1.0 = "
               "consuming budget exactly at the sustainable rate)",
               labels=("slo",)),
    MetricSpec("slo_error_budget_remaining", "gauge",
               "cumulative error budget remaining, keyed by SLO: "
               "1 - violations/(budget * samples), floored at 0",
               labels=("slo",)),
    MetricSpec("slo_violations_total", "counter",
               "samples over their SLO threshold (bucket resolution), "
               "keyed by SLO", labels=("slo",)),
    MetricSpec("slo_tenant_goodput", "gauge",
               "per-tenant admission goodput: admitted / (admitted + "
               "validation rejects + sheds), 0..1",
               labels=("tenant",)),
    # -- fleet front door (ISSUE 19): the multi-replica router.  The
    #    replica label is the replica ordinal as a string; "router" on
    #    the shed family marks front-door rejects that never reached
    #    any replica's queue.
    MetricSpec("fleet_requests_submitted_total", "counter",
               "requests entering the fleet front door (before any "
               "routing decision)"),
    MetricSpec("fleet_requests_routed_total", "counter",
               "requests routed to a replica, keyed by replica ordinal",
               labels=("replica",)),
    MetricSpec("fleet_requests_shed_total", "counter",
               "requests shed by cross-replica overload routing, keyed "
               "by the replica whose queue lost them (\"router\" = "
               "rejected at the front door before reaching any queue)",
               labels=("replica",)),
    MetricSpec("fleet_prefix_affinity_hits_total", "counter",
               "routing decisions that landed on a replica holding a "
               "non-zero radix peek match (the prefix's pages — HBM or "
               "host tier — already live there)"),
    MetricSpec("fleet_affinity_spills_total", "counter",
               "affinity routings diverted to the least-loaded replica "
               "because the preferred replica sat over the load spill "
               "threshold (affinity must not starve a replica)"),
    MetricSpec("fleet_routed_prefix_tokens_total", "counter",
               "prompt tokens already cached on the chosen replica at "
               "routing time (read-only peek coverage), keyed by "
               "replica", labels=("replica",)),
    MetricSpec("fleet_replica_queue_depth", "gauge",
               "queued requests per replica as seen at the last "
               "routing decision", labels=("replica",)),
    MetricSpec("fleet_replica_free_pages", "gauge",
               "free KV pages per replica as seen at the last routing "
               "decision", labels=("replica",)),
    MetricSpec("fleet_replica_overloaded", "gauge",
               "per-replica overload advisory (0/1) as seen by the "
               "router (PR 13's detector, consumed as a routing "
               "signal)", labels=("replica",)),
    # -- engine dispatch (host wrappers around the donated executables) ---
    MetricSpec("infer_prefill_dispatch_total", "counter",
               "InferenceEngine.prefill dispatches"),
    MetricSpec("infer_decode_dispatch_total", "counter",
               "InferenceEngine.decode dispatches"),
    MetricSpec("infer_cow_dispatch_total", "counter",
               "InferenceEngine.cow_page dispatches (copy-on-write "
               "page duplications)"),
    MetricSpec("infer_decode_fused_dispatch_total", "counter",
               "decode dispatches lowered through the fused "
               "transformer-block kernel (APEX_TPU_DECODE_FUSION; a "
               "subset of infer_decode_dispatch_total)"),
    MetricSpec("infer_verify_dispatch_total", "counter",
               "InferenceEngine.verify dispatches (speculative "
               "verify steps)"),
    MetricSpec("infer_swap_out_dispatch_total", "counter",
               "InferenceEngine.swap_out_pages batch dispatches "
               "(fixed-width page-gather executions, D2H)"),
    MetricSpec("infer_swap_in_dispatch_total", "counter",
               "InferenceEngine.swap_in_pages batch dispatches "
               "(fixed-width page-scatter executions, H2D)"),
    # -- training (TrainTelemetry) ----------------------------------------
    MetricSpec("train_steps_total", "counter",
               "instrumented train steps dispatched"),
    MetricSpec("train_recompiles_total", "counter",
               "train steps that triggered a NEW compile after warmup "
               "(must stay 0: the step is ONE donated executable)"),
    MetricSpec("train_overflow_skips_total", "counter",
               "steps whose update was skipped on grad overflow "
               "(found_inf, resolved one step late)"),
    MetricSpec("train_tokens_per_s", "gauge",
               "tokens / measured step wall time"),
    MetricSpec("train_loss", "gauge",
               "unscaled loss (deferred: reflects the PREVIOUS step)"),
    MetricSpec("train_loss_scale", "gauge",
               "dynamic loss scale (deferred: previous step)"),
    MetricSpec("train_grad_norm", "gauge",
               "global grad norm when supplied (deferred: previous step)"),
    MetricSpec("train_exposed_comm_residual_us", "gauge",
               "measured step time minus comm_model.step_time_estimate "
               "overlap_us — the un-modeled exposed-comm residual"),
    # -- training MFU + goodput (ISSUE 10) --------------------------------
    MetricSpec("train_mfu", "gauge",
               "model-FLOP utilisation per measured step: armed "
               "flops-per-step (compiled truth via xla_stats, or the "
               "analytic model) / step seconds / chip peak FLOPs"),
    MetricSpec("train_model_flops_per_step", "gauge",
               "the flops-per-step the mfu gauge is armed with "
               "(provenance rides the arm_mfu caller: compiled "
               "cost_analysis or hand-derived)"),
    MetricSpec("train_goodput_productive_seconds", "counter",
               "wall seconds attributed to steps that ran and updated "
               "(attribution lands when the step's deferred scalars "
               "resolve, or at flush)"),
    MetricSpec("train_badput_overflow_seconds", "counter",
               "wall seconds of steps whose update was skipped on grad "
               "overflow (found_inf, attributed one step late)"),
    MetricSpec("train_badput_recompile_seconds", "counter",
               "wall seconds of steps that triggered a post-warmup "
               "recompile (the stall the ONE-executable invariant "
               "exists to prevent)"),
    MetricSpec("train_badput_host_gap_seconds", "counter",
               "run wall time covered by NO step interval (input "
               "stalls, eval/checkpoint pauses between flush "
               "boundaries) — settled at flush()"),
    MetricSpec("train_step_seconds", "histogram",
               "per-step wall time: interval between step completions "
               "(steady state; first step = its own dispatch bracket "
               "incl. warmup compile)",
               buckets=STEP_TIME_BUCKETS_S),
    # -- training numerics health (ISSUE 11; created only when the
    #    numerics mode is armed, so pre-PR-11 runs expose none of these)
    MetricSpec("train_grad_norm_hist", "histogram",
               "global unscaled flat-grad L2 norm per observed step "
               "(in-program probe, resolved one step late; nonfinite "
               "norms land on the overflow autopsy, never here)",
               buckets=GRAD_NORM_BUCKETS),
    MetricSpec("train_param_norm", "gauge",
               "fp32 master-param L2 norm (deferred: previous step)"),
    MetricSpec("train_update_ratio", "gauge",
               "||delta w|| / ||w|| of the applied update (deferred: "
               "previous step; 0 on overflow-skipped steps)"),
    MetricSpec("train_leaf_grad_norm", "gauge",
               "per-parameter-leaf unscaled grad L2 norm over the "
               "FlatState leaf layout (deferred: previous step)",
               labels=("leaf",)),
    MetricSpec("train_overflow_leaf_total", "counter",
               "nonfinite grad elements attributed to each parameter "
               "leaf by the overflow autopsy (one step late)",
               labels=("leaf",)),
    MetricSpec("train_nonfinite_grad_elems_total", "counter",
               "total nonfinite grad elements the numerics probes "
               "observed (sum of the per-leaf autopsy counts)"),
    MetricSpec("train_loss_scale_backoffs_total", "counter",
               "dynamic loss-scale halvings (overflow backoffs) seen "
               "in the resolved loss-scale series"),
    MetricSpec("train_loss_scale_growths_total", "counter",
               "dynamic loss-scale doublings (growth-interval growths) "
               "seen in the resolved loss-scale series"),
    # -- measured attribution (ISSUE 14): profiler-trace ingestion.
    #    Set only when a capture was ingested — a run with no trace
    #    exposes none of these (the unavailable: marker rides the
    #    attribution event instead; never a fabricated zero).
    MetricSpec("trace_window_us", "gauge",
               "measured profiler-trace extent (µs): first attributed "
               "op start to last op end across the ingested capture "
               "(slowest rank when several merge)"),
    MetricSpec("trace_step_time_us", "gauge",
               "measured per-step wall time (µs): trace window / the "
               "caller-supplied dispatch count"),
    MetricSpec("trace_mfu", "gauge",
               "measured MFU: compiled FLOPs × steps / measured "
               "compute time / chip peak (train_mfu divides by step "
               "WALL time instead)"),
    MetricSpec("trace_exposed_comm_us", "gauge",
               "measured exposed collective time (µs): collective "
               "intervals NOT covered by concurrent compute over the "
               "trace window (interval-overlap math)"),
    MetricSpec("trace_category_time_us", "gauge",
               "wall time attributed to each op category over the "
               "trace window (per-category interval union, µs; "
               "host_gap = window minus busy)",
               labels=("category",)),
    MetricSpec("trace_rank_step_skew", "gauge",
               "slowest/median rank trace-window ratio across merged "
               "ranks (the straggler indicator; absent on single-rank "
               "captures)"),
    MetricSpec("trace_collective_start_spread_us", "gauge",
               "max cross-rank start-time spread per collective type "
               "(µs; k-th occurrence of the type, starts rebased to "
               "each rank's first op)",
               labels=("collective",)),
]}

#: JSONL event stream: ``{"ts": float, "kind": str, ...kind fields}``.
#: Field types are JSON type names; ``"<type>|null"`` marks a field
#: that may be null (it is still always PRESENT).
EVENT_FIELDS: Dict[str, Dict[str, str]] = {
    "request_submit": {"uid": "int", "prompt_len": "int",
                       "max_new_tokens": "int", "queue_depth": "int"},
    "request_admit": {"uid": "int", "slot": "int", "wait_s": "float",
                      "pages": "int|null", "tenant": "str",
                      "prefix_tokens": "int"},
    "prefill_chunk": {"uid": "int", "start": "int", "tokens": "int"},
    "cow_copy": {"uid": "int", "slot": "int", "src": "int",
                 "dst": "int"},
    # tiered KV memory (ISSUE 18): one event per batched page copy
    # across the HBM<->host boundary.  uid tags swap-ins with the
    # admitting request; swap-outs (eviction-driven) carry null.
    "page_swap": {"uid": "int|null", "direction": "str",
                  "pages": "int"},
    "request_first_token": {"uid": "int", "ttft_s": "float"},
    "request_finish": {"uid": "int", "reason": "str", "tokens": "int",
                       "e2e_s": "float"},
    # overload shedding (ISSUE 13): a QUEUED request rejected by the
    # shedding advisory (validation rejects raise at submit and never
    # reach the stream)
    "request_shed": {"uid": "int", "tenant": "str",
                     "queue_depth": "int"},
    # request tracing (ISSUE 13): one event per closed span of a
    # sampled request's trace; offsets are seconds from submit.
    "trace_span": {"uid": "int", "wave": "int", "span": "str",
                   "seq": "int", "start_s": "float",
                   "dur_s": "float|null", "detail": "str|null"},
    # SLO accounting (ISSUE 13): a window that burned error budget
    # faster than sustainable (burn_rate > 1), or a tenant under its
    # goodput floor (slo="tenant_goodput:<tenant>", burn_rate null,
    # fraction = the goodput, threshold = the floor).
    "slo_violation": {"slo": "str", "window": "int", "samples": "int",
                      "violations": "int", "fraction": "float",
                      "burn_rate": "float|null", "threshold": "float"},
    # overload-advisory flips from the load-trend detector
    "overload": {"overloaded": "bool", "queue_depth": "int",
                 "backpressure_waits": "float",
                 "free_pages": "int|null"},
    # fleet routing (ISSUE 19): one event per front-door decision.
    # uid is the FLEET uid; prefix_tokens is the read-only peek
    # coverage on the chosen replica; spilled marks an affinity pick
    # diverted by the load spill threshold.
    "route_decision": {"uid": "int", "replica": "int", "policy": "str",
                       "prefix_tokens": "int", "queue_depth": "int",
                       "free_pages": "int|null", "overloaded": "bool",
                       "spilled": "bool"},
    "train_step": {"step": "int", "seconds": "float|null",
                   "recompiled": "bool"},
    "train_numerics": {"step": "int", "grad_norm": "float|null",
                       "param_norm": "float|null",
                       "update_ratio": "float|null",
                       "loss_scale": "float|null",
                       "nonfinite_elems": "float"},
    # the overflow autopsy (ISSUE 11): WHICH parameter leaves went
    # nonfinite on a found_inf step, attributed one step late.
    # ``leaves`` is a list of {"leaf": str, "nonfinite": int} objects.
    "overflow_autopsy": {"step": "int", "loss_scale": "float|null",
                         "nonfinite_elems": "float", "leaves": "list"},
    "profile_start": {"dir": "str", "tag": "str"},
    "profile_stop": {"dir": "str", "tag": "str"},
    # profile_capture hardening (ISSUE 14 satellite): an ARMED capture
    # that degraded to a no-op (stale/unwritable dir) instead of
    # silently shadowing an old trace.
    "profile_skipped": {"dir": "str", "tag": "str", "reason": "str"},
    # measured attribution (ISSUE 14): one event per ingested profiler
    # capture — the full record (per-category µs in ``categories``,
    # per-type collectives, cross-rank skew); absent measurements are
    # null next to the provenance marker, never zero.
    "attribution": {"profile_dir": "str", "provenance": "str",
                    "ranks": "int", "window_us": "float|null",
                    "busy_us": "float|null",
                    "host_gap_us": "float|null",
                    "compute_us": "float|null",
                    "exposed_comm_us": "float|null",
                    "coverage": "float|null", "steps": "int|null",
                    "step_us": "float|null", "mfu": "float|null",
                    "mfu_provenance": "str|null",
                    "model_exposed_comm_us": "float|null",
                    "exposed_comm_drift_ratio": "float|null",
                    "categories": "object", "collectives": "object",
                    "skew": "object|null"},
}

COMMON_EVENT_FIELDS: Dict[str, str] = {"ts": "float", "kind": "str"}


def current_schema() -> dict:
    """The schema as one JSON-stable dict (what ``.telemetry_schema.json``
    pins)."""
    return {
        "version": SCHEMA_VERSION,
        "prometheus": {
            name: {
                "type": s.kind,
                "help": s.help,
                "labels": list(s.labels),
                **({"buckets": list(s.buckets)}
                   if s.buckets is not None else {}),
            }
            for name, s in sorted(METRIC_SPECS.items())
        },
        "jsonl": {
            "common": dict(COMMON_EVENT_FIELDS),
            "events": {k: dict(v)
                       for k, v in sorted(EVENT_FIELDS.items())},
        },
    }


def main(argv=None) -> int:  # pragma: no cover - exercised via CLI
    import argparse
    from pathlib import Path

    p = argparse.ArgumentParser(
        prog="python -m apex_tpu_torch.observability.schema",
        description="print or re-pin the telemetry schema")
    p.add_argument("--write", action="store_true",
                   help=f"re-pin <repo>/{SCHEMA_NAME}")
    args = p.parse_args(argv)
    text = json.dumps(current_schema(), indent=1) + "\n"
    if args.write:
        path = Path(__file__).resolve().parents[2] / SCHEMA_NAME
        path.write_text(text, encoding="utf-8")
        print(f"schema written: {path}")
    else:
        print(text, end="")
    return 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
