"""Telemetry sinks: JSONL event log + Prometheus text exposition file.

Both write the PINNED schema (``.telemetry_schema.json`` via
:mod:`apex_tpu.observability.schema`): the JSONL stream is one
``{"ts", "kind", ...}`` object per line, append-only (rotate
externally); the Prometheus sink rewrites one text-exposition file on every
``export`` — the node-exporter "textfile collector" pattern, which
needs no HTTP listener inside the training/serving process.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import IO, Optional

from apex_tpu_torch.observability.registry import (Counter, Gauge, Histogram,
                                             MetricsRegistry)

__all__ = ["JsonlSink", "PrometheusSink", "render_prometheus"]


class JsonlSink:
    """Append one JSON object per line; flushed per event so a crashed
    run keeps everything it logged."""

    def __init__(self, path: str):
        self.path = str(path)
        self._fh: Optional[IO] = None

    def _handle(self) -> IO:
        if self._fh is None or self._fh.closed:
            self._fh = open(self.path, "a", encoding="utf-8")
        return self._fh

    def event(self, obj: dict) -> None:
        fh = self._handle()
        fh.write(json.dumps(obj, sort_keys=True) + "\n")
        fh.flush()

    def close(self) -> None:
        if self._fh is not None and not self._fh.closed:
            self._fh.close()


def _fmt(v: float) -> str:
    """Prometheus sample value: integers stay integral, floats use
    repr-stable shortest form."""
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return format(f, ".10g")


def _labels_str(names, values, extra=()) -> str:
    pairs = [f'{n}="{v}"' for n, v in zip(names, values)]
    pairs += [f'{n}="{v}"' for n, v in extra]
    return "{" + ",".join(pairs) + "}" if pairs else ""


def render_prometheus(registry: MetricsRegistry) -> str:
    """The registry as Prometheus text exposition format 0.0.4:
    ``# HELP`` / ``# TYPE`` headers, cumulative ``_bucket{le=}`` series
    plus ``_sum``/``_count`` for histograms."""
    lines = []
    for inst in registry.instruments():
        lines.append(f"# HELP {inst.name} {inst.help}")
        lines.append(f"# TYPE {inst.name} {inst.kind}")
        if isinstance(inst, (Counter, Gauge)):
            if isinstance(inst, Counter) and not inst.labels \
                    and not inst._values:
                # a never-incremented unlabeled counter still exposes
                # an explicit 0 sample — the pinned-zero families
                # (serve_recompiles_total, ...) must be scrapeable as
                # zero, not absent
                lines.append(f"{inst.name} 0")
            for key in inst.label_keys():
                lines.append(
                    f"{inst.name}{_labels_str(inst.labels, key)} "
                    f"{_fmt(inst._values[key])}")
        elif isinstance(inst, Histogram):
            for key in inst.label_keys():
                labels = dict(zip(inst.labels, key))
                cum = inst.cumulative_counts(**labels)
                bounds = [_fmt(b) for b in inst.buckets] + ["+Inf"]
                for le, c in zip(bounds, cum):
                    lines.append(
                        f"{inst.name}_bucket"
                        f"{_labels_str(inst.labels, key, [('le', le)])} "
                        f"{c}")
                lines.append(
                    f"{inst.name}_sum{_labels_str(inst.labels, key)} "
                    f"{_fmt(inst.sum(**labels))}")
                lines.append(
                    f"{inst.name}_count{_labels_str(inst.labels, key)} "
                    f"{inst.count(**labels)}")
    return "\n".join(lines) + ("\n" if lines else "")


class PrometheusSink:
    """Rewrite one text-exposition file per ``export`` (atomic rename,
    so a scraper never reads a torn file).  Ignores events — lifecycle
    detail belongs to the JSONL stream."""

    def __init__(self, path: str):
        self.path = str(path)

    def event(self, obj: dict) -> None:
        pass

    def export(self, registry: MetricsRegistry) -> None:
        text = render_prometheus(registry)
        d = os.path.dirname(os.path.abspath(self.path)) or "."
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".prom.tmp")
        try:
            with os.fdopen(fd, "w", encoding="utf-8") as fh:
                fh.write(text)
            os.replace(tmp, self.path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
