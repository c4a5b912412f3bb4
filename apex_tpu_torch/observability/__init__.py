"""apex_tpu_torch.observability — the serving telemetry the scheduler
reports through, copied from ``apex_tpu/observability`` with only the
imports changed.

    schema     pinned metric families + JSONL event fields (the same
               families ``.telemetry_schema.json`` pins for the JAX
               package)
    registry   counters / gauges / bucketed histograms with labels
    sinks      JSONL event log + Prometheus text-exposition file
    timers     StepTimer (the port runs eagerly: no compile events)
    serve      ServeTelemetry (SlotScheduler lifecycle: TTFT, decode
               latency, queue depth, finish reasons, page-pool gauges)
    spans      request-scoped tracing (``APEX_TPU_TRACE``)
    slo        declarative SLOs and the overload detector

Knobs keep the JAX package's names: ``APEX_TPU_TELEMETRY=<dir>``
attaches a JSONL sink and a Prometheus file sink to the global registry
at first use; ``APEX_TPU_TRACE`` and ``APEX_TPU_SLO_*_US`` are read by
the tracer and the SLO tracker.
"""
from __future__ import annotations

import os

from apex_tpu_torch.observability.registry import (Counter, Gauge,
                                                   Histogram, Metrics,
                                                   MetricsRegistry,
                                                   global_metrics,
                                                   global_registry,
                                                   reset_global_registry)
from apex_tpu_torch.observability.serve import (FleetTelemetry,
                                                ServeTelemetry)
from apex_tpu_torch.observability.sinks import (JsonlSink, PrometheusSink,
                                                render_prometheus)
from apex_tpu_torch.observability.slo import (OverloadDetector, SLOSpec,
                                              SLOTracker,
                                              slo_specs_from_env)
from apex_tpu_torch.observability.spans import (RequestTracer,
                                                default_trace_sample)
from apex_tpu_torch.observability.timers import (StepSample, StepTimer,
                                                 compile_count)

__all__ = [
    "MetricsRegistry", "Counter", "Gauge", "Histogram",
    "global_registry", "reset_global_registry",
    "JsonlSink", "PrometheusSink", "render_prometheus",
    "StepTimer", "StepSample", "compile_count",
    "ServeTelemetry", "FleetTelemetry",
    "RequestTracer", "default_trace_sample",
    "SLOSpec", "SLOTracker", "OverloadDetector", "slo_specs_from_env",
    "telemetry_enabled", "configure_from_env",
    "Metrics", "global_metrics",
]

_ENV_TELEMETRY = "APEX_TPU_TELEMETRY"


def telemetry_enabled() -> bool:
    """True when ``APEX_TPU_TELEMETRY`` names a sink directory."""
    return os.environ.get(_ENV_TELEMETRY, "0") not in ("", "0")


def configure_from_env(registry=None) -> MetricsRegistry:
    """Attach the env-selected sinks to the (global) registry, once.
    Idempotent PER REGISTRY (the mark lives on the registry object, so
    explicit and implicit callers can't double-attach sinks, and a
    fresh ``reset_global_registry()`` registry configures again) and a
    no-op when the knob is off; returns the registry either way so call
    sites can chain."""
    reg = registry if registry is not None else global_registry()
    if getattr(reg, "_env_sinks_attached", False):
        return reg
    reg._env_sinks_attached = True
    target = os.environ.get(_ENV_TELEMETRY, "0")
    if target not in ("", "0"):
        os.makedirs(target, exist_ok=True)
        reg.add_sink(JsonlSink(os.path.join(target, "telemetry.jsonl")))
        reg.add_sink(PrometheusSink(os.path.join(target, "metrics.prom")))
    return reg
