"""Declarative serving SLOs: error budgets, burn rates, overload.

The fleet question PR 8/10/12 left open — *are we inside our SLOs
right now, and over time?* — answered from signals the stack already
records, with zero new device work:

* :class:`SLOSpec` — a latency objective over one of the pinned
  bucketed histograms (``serve_ttft_seconds`` /
  ``serve_decode_token_seconds``): "quantile ``q`` of samples stay
  under ``threshold_s``".  The implied **error budget** is ``1 - q``
  (the fraction of samples ALLOWED over the threshold).
* :class:`SLOTracker` — windowed accounting straight off the
  histograms' cumulative bucket counts (bucket resolution: the
  threshold clamps DOWN to the largest bucket bound <= threshold, so a
  sample between that bound and the threshold counts against the
  budget — the conservative reading).  Per window it publishes the
  **burn rate** (window violation fraction / error budget; 1.0 =
  consuming budget exactly at the sustainable rate), the cumulative
  **budget remaining** (1 - violations/(budget * samples), floored at
  0), per-``slo``-labeled violation counters, and pinned
  ``slo_violation`` events whenever a window burns faster than its
  budget.  A per-tenant **goodput floor** (admitted / submitted per
  tenant, from the ISSUE-12 tenant counters + the shed counter) rides
  the same window pass.
* :class:`OverloadDetector` — a pure host-side trend rule over
  (queue depth, backpressure waits, free pages): sustained queue
  pressure while the page pool is not recovering flips a **shedding
  advisory** the scheduler's priority admission consumes behind
  ``SlotScheduler(shed_on_overload=True)``; flips emit pinned
  ``overload`` events and drive the ``serve_overload`` gauge.

Everything here is arithmetic on host-side counters the registry
already holds — no device reads, no jitted code, so arming SLOs can
never add a sync or a recompile (the L1 compile-count test pins it).
"""
from __future__ import annotations

import bisect
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from apex_tpu_torch.observability.registry import Histogram, MetricsRegistry

__all__ = ["SLOSpec", "SLOTracker", "OverloadDetector",
           "slo_specs_from_env", "slo_target_us",
           "SLO_METRIC_FAMILIES", "SLO_EVENTS"]

_SLO_TTFT_ENV = "APEX_TPU_SLO_TTFT_US"
_SLO_DECODE_ENV = "APEX_TPU_SLO_DECODE_US"

#: metric families / event kinds this module emits — the schema-guard
#: test pins them into the committed ``.telemetry_schema.json``.
SLO_METRIC_FAMILIES = ("slo_burn_rate", "slo_error_budget_remaining",
                       "slo_violations_total", "slo_tenant_goodput",
                       "serve_overload")
SLO_EVENTS = ("slo_violation", "overload")


@dataclass(frozen=True)
class SLOSpec:
    """One latency objective: ``quantile`` of the samples in
    ``family`` (a pinned bucketed histogram) stay <= ``threshold_s``;
    the error budget is ``1 - quantile``."""
    name: str                 # the `slo` label value, e.g. "ttft_p99"
    family: str               # histogram family the samples live in
    threshold_s: float
    quantile: float = 0.99

    def __post_init__(self):
        if self.threshold_s <= 0:
            raise ValueError(f"{self.name}: threshold_s must be > 0")
        if not 0.0 < self.quantile < 1.0:
            raise ValueError(f"{self.name}: quantile must be in (0,1)")

    @property
    def error_budget(self) -> float:
        return 1.0 - self.quantile


def slo_target_us(env_name: str) -> float:
    """Parse one ``*_US`` SLO knob: target in microseconds, ``0``
    (default) = objective off."""
    env = os.environ.get(env_name)
    if not env:
        return 0.0
    try:
        val = float(env)
    except ValueError as e:
        raise ValueError(
            f"{env_name} must be a latency target in microseconds "
            f"(0 = off), got {env!r}") from e
    if val < 0:
        raise ValueError(f"{env_name} must be >= 0, got {val}")
    return val


def slo_targets() -> Dict[str, float]:
    """Effective knob values in µs (``0`` = off) — bench stamps these
    into infer captures as ``infer_slo_ttft``/``infer_slo_decode``."""
    return {"ttft_us": slo_target_us(_SLO_TTFT_ENV),
            "decode_us": slo_target_us(_SLO_DECODE_ENV)}


def slo_specs_from_env() -> Tuple[SLOSpec, ...]:
    """``APEX_TPU_SLO_TTFT_US`` / ``APEX_TPU_SLO_DECODE_US`` ->
    p99 objectives over the serving histograms (unset/0 = no spec)."""
    specs = []
    ttft = slo_target_us(_SLO_TTFT_ENV)
    if ttft:
        specs.append(SLOSpec("ttft_p99", "serve_ttft_seconds",
                             ttft * 1e-6))
    decode = slo_target_us(_SLO_DECODE_ENV)
    if decode:
        specs.append(SLOSpec("decode_token_p99",
                             "serve_decode_token_seconds",
                             decode * 1e-6))
    return tuple(specs)


class OverloadDetector:
    """Pure trend rule over the scheduler's per-pass load observation.

    Overloaded when, across the last ``window`` observations:

    * queue pressure — the queue has held at or above ``queue_high``
      without draining (non-decreasing depth), OR backpressure waits
      accumulated within the window; AND
    * no recovery — the free-page trend is non-increasing (a dense
      engine has no pool: vacuously true).

    Pure logic, no registry: :meth:`SLOTracker.observe_load` wraps it
    with the gauge + transition events."""

    def __init__(self, *, window: int = 4, queue_high: int = 4):
        if window < 2:
            raise ValueError(f"window must be >= 2, got {window}")
        self.window = int(window)
        self.queue_high = int(queue_high)
        self._hist: List[Tuple[int, float, Optional[int]]] = []
        self.overloaded = False

    def observe(self, queue_depth: int, backpressure_total: float = 0.0,
                free_pages: Optional[int] = None) -> bool:
        self._hist.append((int(queue_depth), float(backpressure_total),
                           free_pages))
        if len(self._hist) > self.window:
            self._hist.pop(0)
        if len(self._hist) < self.window:
            self.overloaded = False
            return False
        depths = [h[0] for h in self._hist]
        bp = [h[1] for h in self._hist]
        pages = [h[2] for h in self._hist]
        queue_sustained = (min(depths) >= self.queue_high
                          and all(b >= a for a, b in
                                  zip(depths, depths[1:])))
        backpressured = bp[-1] > bp[0]
        no_recovery = (any(p is None for p in pages)
                       or all(b <= a for a, b in zip(pages, pages[1:])))
        self.overloaded = ((queue_sustained or backpressured)
                          and no_recovery)
        return self.overloaded


class SLOTracker:
    """Windowed error-budget/burn-rate accounting + the overload
    advisory, computed from instruments in ``registry``.

    The scheduler calls :meth:`observe_load` once per loop pass (cheap:
    one list append + the trend rule) and :meth:`observe_window` at
    wave boundaries; tests drive both directly with hand-built
    histograms."""

    def __init__(self, registry: MetricsRegistry,
                 specs: Optional[Tuple[SLOSpec, ...]] = None, *,
                 tenant_goodput_floor: Optional[float] = None,
                 detector: Optional[OverloadDetector] = None):
        self.registry = registry
        self.specs = (slo_specs_from_env() if specs is None
                      else tuple(specs))
        if tenant_goodput_floor is not None \
                and not 0.0 < tenant_goodput_floor <= 1.0:
            raise ValueError("tenant_goodput_floor must be in (0, 1]")
        self.tenant_goodput_floor = tenant_goodput_floor
        self.detector = detector or OverloadDetector()
        d = registry.declared
        self.burn_rate = d("slo_burn_rate")
        self.budget_remaining = d("slo_error_budget_remaining")
        self.violations = d("slo_violations_total")
        self.tenant_goodput = d("slo_tenant_goodput")
        self.overload_gauge = d("serve_overload")
        self.overload_gauge.set(0)
        # window baselines seed from the histograms' CURRENT state: a
        # tracker attached to a registry that already holds traffic
        # (a second scheduler sharing one telemetry) must not account
        # history as its own first window — that would double-count
        # every prior violation and emit a spurious slo_violation
        # event for a window that served nothing
        self._cum: Dict[str, Tuple[int, int]] = {
            spec.name: self._counts(spec) for spec in self.specs}
        self._windows = 0
        self.violating_tenants: List[str] = []

    # -- histogram bucket math ----------------------------------------------
    def _counts(self, spec: SLOSpec) -> Tuple[int, int]:
        """(total samples, samples over threshold) at bucket
        resolution — cumulative reads off the pinned histogram, never a
        per-sample store."""
        hist = self.registry.declared(spec.family)
        if not isinstance(hist, Histogram):
            raise ValueError(f"{spec.name}: {spec.family} is not a "
                             f"histogram family")
        cum = hist.cumulative_counts()
        total = cum[-1]
        # largest bucket bound <= threshold (tiny relative slack so a
        # threshold equal to a bound, post float noise, lands ON it)
        rank = bisect.bisect_right(hist.buckets,
                                   spec.threshold_s * (1 + 1e-9))
        good = cum[rank - 1] if rank > 0 else 0
        return int(total), int(total - good)

    # -- per-pass load observation ------------------------------------------
    def observe_load(self, queue_depth: int,
                     backpressure_total: float = 0.0,
                     free_pages: Optional[int] = None) -> bool:
        """One scheduler-pass load sample through the overload
        detector; emits an ``overload`` event on every advisory flip
        and returns the current advisory."""
        was = self.detector.overloaded
        now = self.detector.observe(queue_depth, backpressure_total,
                                    free_pages)
        self.overload_gauge.set(1 if now else 0)
        if now != was:
            self.registry.emit_event(
                "overload", overloaded=bool(now),
                queue_depth=int(queue_depth),
                backpressure_waits=float(backpressure_total),
                free_pages=(int(free_pages) if free_pages is not None
                            else None))
        return now

    def shedding_advisory(self) -> bool:
        """True while the overload detector holds its advisory — the
        signal ``SlotScheduler(shed_on_overload=True)`` consumes."""
        return self.detector.overloaded

    # -- windowed accounting -------------------------------------------------
    def observe_window(self) -> dict:
        """Close one accounting window: per-spec burn rate + budget
        gauges/counters off the histogram deltas since the previous
        window, ``slo_violation`` events for every window that burned
        faster than its budget, and the per-tenant goodput-floor pass.
        Returns the window stats (tests hand-check the math)."""
        self._windows += 1
        out: dict = {"window": self._windows, "slos": {}}
        for spec in self.specs:
            total, viol = self._counts(spec)
            p_total, p_viol = self._cum.get(spec.name, (0, 0))
            self._cum[spec.name] = (total, viol)
            w_total = total - p_total
            w_viol = viol - p_viol
            budget = spec.error_budget
            stats = {"samples": w_total, "violations": w_viol,
                     "fraction": None, "burn_rate": None,
                     "budget_remaining": None}
            if w_viol:
                self.violations.inc(w_viol, slo=spec.name)
            if w_total > 0:
                frac = w_viol / w_total
                burn = frac / budget
                stats["fraction"] = frac
                stats["burn_rate"] = burn
                self.burn_rate.set(burn, slo=spec.name)
                if burn > 1.0:
                    self.registry.emit_event(
                        "slo_violation", slo=spec.name,
                        window=self._windows, samples=int(w_total),
                        violations=int(w_viol),
                        fraction=round(frac, 9),
                        burn_rate=round(burn, 9),
                        threshold=spec.threshold_s)
            if total > 0:
                remaining = max(0.0, 1.0 - viol / (budget * total))
                stats["budget_remaining"] = remaining
                self.budget_remaining.set(remaining, slo=spec.name)
            out["slos"][spec.name] = stats
        out["tenants"] = self._tenant_pass()
        return out

    def _tenant_pass(self) -> dict:
        """Per-tenant goodput = admitted / (admitted + validation
        rejects + sheds); tenants below the floor (with at least one
        submission) land on ``violating_tenants`` and emit a
        ``slo_violation`` event (``slo="tenant_goodput:<tenant>"``)."""
        d = self.registry.declared
        admitted = d("serve_tenant_admitted_total")
        rejected = d("serve_tenant_rejected_total")
        shed = d("serve_requests_shed_total")
        tenants = ({k[0] for k in admitted._values}
                   | {k[0] for k in rejected._values}
                   | {k[0] for k in shed._values})
        out: dict = {}
        violating = []
        for tenant in sorted(tenants):
            adm = admitted.value(tenant=tenant)
            bad = (rejected.value(tenant=tenant)
                   + shed.value(tenant=tenant))
            n = adm + bad
            if n <= 0:
                continue
            goodput = adm / n
            self.tenant_goodput.set(goodput, tenant=tenant)
            out[tenant] = goodput
            floor = self.tenant_goodput_floor
            if floor is not None and goodput < floor:
                violating.append(tenant)
                self.registry.emit_event(
                    "slo_violation", slo=f"tenant_goodput:{tenant}",
                    window=self._windows, samples=int(n),
                    violations=int(bad),
                    fraction=round(goodput, 9), burn_rate=None,
                    threshold=floor)
        self.violating_tenants = violating
        return out

    # -- digest ---------------------------------------------------------------
    def summary(self) -> dict:
        """Human-oriented digest (examples/generate.py prints this
        when SLO knobs are armed)."""
        out: dict = {"windows": self._windows,
                     "overloaded": self.detector.overloaded}
        for spec in self.specs:
            entry = {"threshold_s": spec.threshold_s,
                     "quantile": spec.quantile}
            burn = self.burn_rate.value(slo=spec.name)
            if burn is not None:
                entry["burn_rate"] = round(burn, 4)
            rem = self.budget_remaining.value(slo=spec.name)
            if rem is not None:
                entry["budget_remaining"] = round(rem, 4)
            entry["violations"] = int(self.violations.value(slo=spec.name))
            out[spec.name] = entry
        if self.violating_tenants:
            out["violating_tenants"] = list(self.violating_tenants)
        return out
