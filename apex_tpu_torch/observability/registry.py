"""Sync-free metrics registry: counters, gauges, bucketed histograms.

Everything here is host-side bookkeeping on Python floats — an
instrument update is a dict write, never a device read, so instrumenting
the training loop or the serving scheduler adds zero host syncs and
zero recompiles to the jitted paths (the acceptance invariant of
ISSUE 8).  Device scalars reach these instruments only through the
:class:`~apex_tpu.observability.deferred.DeferredScalarCollector`, one
step late.

Instrument families are declared once in
:mod:`apex_tpu.observability.schema`; :meth:`MetricsRegistry.declared`
is the only way production code creates them, so the committed
``.telemetry_schema.json`` guard can promise dashboards that no family
appears or mutates silently.
"""
from __future__ import annotations

import collections
import json
import threading
import time
from typing import Dict, Iterable, Optional, Tuple

from apex_tpu_torch.observability import schema as _schema

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "global_registry", "reset_global_registry", "Metrics",
           "global_metrics"]


def _label_key(declared: Tuple[str, ...], labels: dict) -> tuple:
    if set(labels) != set(declared):
        raise ValueError(
            f"labels {sorted(labels)} do not match the declared label "
            f"names {sorted(declared)}")
    return tuple(str(labels[name]) for name in declared)


class _Instrument:
    kind = ""

    def __init__(self, name: str, help: str = "",
                 labels: Tuple[str, ...] = ()):
        self.name = name
        self.help = help
        self.labels = tuple(labels)
        self._values: dict = {}
        self._lock = threading.Lock()

    def label_keys(self) -> list:
        return sorted(self._values)


class Counter(_Instrument):
    kind = "counter"

    def inc(self, value: float = 1.0, **labels) -> None:
        if value < 0:
            raise ValueError(f"counter {self.name} cannot decrease")
        key = _label_key(self.labels, labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + value

    def value(self, **labels) -> float:
        return self._values.get(_label_key(self.labels, labels), 0.0)

    def total(self) -> float:
        """Sum across every label combination."""
        return sum(self._values.values())


class Gauge(_Instrument):
    kind = "gauge"

    def set(self, value, **labels) -> None:
        self._values[_label_key(self.labels, labels)] = float(value)

    def set_max(self, value, **labels) -> None:
        """Ratchet upward (peak gauges)."""
        key = _label_key(self.labels, labels)
        with self._lock:
            self._values[key] = max(self._values.get(key, float("-inf")),
                                    float(value))

    def value(self, **labels) -> Optional[float]:
        return self._values.get(_label_key(self.labels, labels))


class Histogram(_Instrument):
    """Cumulative-bucket latency histogram (Prometheus semantics): a
    sample lands in every bucket whose upper bound covers it, plus the
    implicit ``+Inf`` bucket; ``sum``/``count`` ride along."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 labels: Tuple[str, ...] = (),
                 buckets: Iterable[float] = ()):
        super().__init__(name, help, labels)
        self.buckets = tuple(sorted(float(b) for b in buckets))
        if not self.buckets:
            raise ValueError(f"histogram {self.name} needs buckets")

    def observe(self, value: float, **labels) -> None:
        key = _label_key(self.labels, labels)
        value = float(value)
        with self._lock:
            entry = self._values.get(key)
            if entry is None:
                entry = {"counts": [0] * (len(self.buckets) + 1),
                         "sum": 0.0, "count": 0}
                self._values[key] = entry
            for i, ub in enumerate(self.buckets):
                if value <= ub:
                    entry["counts"][i] += 1
                    break
            else:
                entry["counts"][-1] += 1          # +Inf bucket
            entry["sum"] += value
            entry["count"] += 1

    def count(self, **labels) -> int:
        entry = self._values.get(_label_key(self.labels, labels))
        return entry["count"] if entry else 0

    def sum(self, **labels) -> float:
        entry = self._values.get(_label_key(self.labels, labels))
        return entry["sum"] if entry else 0.0

    def cumulative_counts(self, **labels) -> list:
        """Per-bucket CUMULATIVE counts (the ``_bucket{le=}`` series,
        +Inf last)."""
        entry = self._values.get(_label_key(self.labels, labels))
        if not entry:
            return [0] * (len(self.buckets) + 1)
        out, acc = [], 0
        for c in entry["counts"]:
            acc += c
            out.append(acc)
        return out

    def quantile(self, q: float, **labels) -> Optional[float]:
        """Bucket-resolution quantile: the smallest bucket upper bound
        covering fraction ``q`` of the samples (None when empty; a mass
        in +Inf reports the largest finite bound)."""
        entry = self._values.get(_label_key(self.labels, labels))
        if not entry or not entry["count"]:
            return None
        target = q * entry["count"]
        acc = 0
        for i, c in enumerate(entry["counts"][:-1]):
            acc += c
            if acc >= target:
                return self.buckets[i]
        return self.buckets[-1]


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricsRegistry:
    """Create-or-get instrument registry + event fan-out to sinks."""

    def __init__(self):
        self._instruments: Dict[str, _Instrument] = {}
        self._sinks: list = []
        self._lock = threading.Lock()

    # -- instruments ---------------------------------------------------
    def _get(self, cls, name: str, help: str, labels=(), **kw):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is not None:
                if not isinstance(inst, cls):
                    raise ValueError(
                        f"{name} already registered as {inst.kind}, "
                        f"not {cls.kind}")
                return inst
            inst = cls(name, help, tuple(labels), **kw)
            self._instruments[name] = inst
            return inst

    def counter(self, name: str, help: str = "", labels=()) -> Counter:
        return self._get(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "", labels=()) -> Gauge:
        return self._get(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "", labels=(),
                  buckets=()) -> Histogram:
        return self._get(Histogram, name, help, labels, buckets=buckets)

    def declared(self, name: str) -> _Instrument:
        """The instrument for a schema-declared family — the ONLY path
        production code uses, so nothing undeclared can be emitted."""
        spec = _schema.METRIC_SPECS.get(name)
        if spec is None:
            raise KeyError(
                f"metric {name!r} is not declared in "
                f"apex_tpu.observability.schema.METRIC_SPECS — declare "
                f"it and re-pin .telemetry_schema.json")
        kw = {"buckets": spec.buckets} if spec.kind == "histogram" else {}
        return self._get(_KINDS[spec.kind], name, spec.help,
                         spec.labels, **kw)

    def instruments(self) -> list:
        return [self._instruments[n] for n in sorted(self._instruments)]

    # -- events + sinks ------------------------------------------------
    def add_sink(self, sink) -> None:
        self._sinks.append(sink)

    @property
    def sinks(self) -> tuple:
        return tuple(self._sinks)

    def emit_event(self, kind: str, **fields) -> None:
        """One JSONL lifecycle event to every sink.  Unknown kinds are a
        programming error (the schema guard pins the stream)."""
        if kind not in _schema.EVENT_FIELDS:
            raise KeyError(
                f"event kind {kind!r} is not declared in "
                f"apex_tpu.observability.schema.EVENT_FIELDS")
        obj = {"ts": time.time(), "kind": kind, **fields}
        for sink in self._sinks:
            sink.event(obj)

    def export(self) -> None:
        """Flush the current state through every sink that renders
        snapshots (the Prometheus file sink)."""
        for sink in self._sinks:
            exp = getattr(sink, "export", None)
            if exp is not None:
                exp(self)

    # -- snapshots -----------------------------------------------------
    def snapshot(self) -> dict:
        """Flat JSON-ready view: counters/gauges keyed by
        ``name`` or ``name{label=value}``, histograms summarized."""
        out: dict = {"counters": {}, "gauges": {}, "histograms": {}}

        def keyed(inst, key):
            if not inst.labels:
                return inst.name
            inner = ",".join(f"{n}={v}"
                             for n, v in zip(inst.labels, key))
            return f"{inst.name}{{{inner}}}"

        for inst in self.instruments():
            if isinstance(inst, Histogram):
                for key, entry in sorted(inst._values.items()):
                    out["histograms"][keyed(inst, key)] = {
                        "count": entry["count"],
                        "sum": round(entry["sum"], 9),
                        "p50": inst.quantile(
                            0.5, **dict(zip(inst.labels, key))),
                        "p99": inst.quantile(
                            0.99, **dict(zip(inst.labels, key))),
                    }
            else:
                kind = ("counters" if isinstance(inst, Counter)
                        else "gauges")
                for key, v in sorted(inst._values.items()):
                    out[kind][keyed(inst, key)] = v
        return out


# -- global registry --------------------------------------------------------

_GLOBAL: Optional[MetricsRegistry] = None


def global_registry() -> MetricsRegistry:
    """The process-wide registry (sinks attach per the
    ``APEX_TPU_TELEMETRY`` knob — see
    :func:`apex_tpu.observability.configure_from_env`)."""
    global _GLOBAL
    if _GLOBAL is None:
        _GLOBAL = MetricsRegistry()
    return _GLOBAL


def reset_global_registry() -> MetricsRegistry:
    """Swap in a fresh global registry (tests)."""
    global _GLOBAL
    _GLOBAL = MetricsRegistry()
    return _GLOBAL


# -- legacy surface ---------------------------------------------------------

class Metrics:
    """The pre-ISSUE-8 ``apex_tpu.utils.metrics.Metrics`` registry,
    kept verbatim so the documented API survives the absorption into
    this subsystem (``apex_tpu.utils.metrics`` re-exports it).  New code
    uses :class:`MetricsRegistry`."""

    def __init__(self):
        self._counters: Dict[str, float] = collections.defaultdict(float)
        self._gauges: Dict[str, float] = {}
        self._step_times: collections.deque = collections.deque(maxlen=64)
        self._last_step: Optional[float] = None

    def count(self, name: str, delta: float = 1.0) -> None:
        self._counters[name] += delta

    def gauge(self, name: str, value) -> None:
        self._gauges[name] = float(value)

    def step(self) -> None:
        """Mark a train-step boundary (drives steps/sec)."""
        now = time.perf_counter()
        if self._last_step is not None:
            self._step_times.append(now - self._last_step)
        self._last_step = now
        self._counters["steps"] += 1

    @property
    def steps_per_sec(self) -> float:
        if not self._step_times:
            return 0.0
        return len(self._step_times) / sum(self._step_times)

    def snapshot(self) -> dict:
        out = dict(self._gauges)
        out.update(self._counters)
        out["steps_per_sec"] = round(self.steps_per_sec, 3)
        return out

    def json_line(self) -> str:
        return json.dumps(self.snapshot(), sort_keys=True)

    def reset(self) -> None:
        self.__init__()


global_metrics = Metrics()
