"""Request-scoped tracing: a structured trace per served request.

Every sampled request gets ONE trace — keyed by ``(uid, wave)`` — made
of spans covering the lifecycle the scheduler already walks::

    queued -> admitted -> prefill_chunk[i] -> cow_copy* -> first_token
           -> decode -> retired(reason)        (or the terminal
                                                `rejected`: a queued
                                                request shed by the
                                                overload advisory)

Each span is emitted as ONE pinned ``trace_span`` JSONL event when it
closes (``{"uid", "wave", "span", "seq", "start_s", "dur_s",
"detail"}``, offsets relative to the trace's submit time), so the
flight recorder can rebuild a per-request waterfall
(``python -m apex_tpu.observability.report <run_dir> --trace <uid>``)
from the event stream alone.

Sync discipline (the sacred invariants): the tracer consumes ONLY the
host-side integers and ``time.perf_counter`` stamps
:class:`~apex_tpu.observability.serve.ServeTelemetry` already holds at
boundaries the scheduler already occupies — it never reads a device
value, never enters jitted code, and flipping ``APEX_TPU_TRACE`` can
therefore never add a sync or a recompile (re-proven by the compile
-count tests in ``tests/L1/test_observability.py``).

Span conservation (ISSUE 13 satellite): a trace that saw ``admitted``
must close with EXACTLY one terminal span (``retired`` with a reason
from the scheduler's ``finish_reasons``, or ``rejected`` for a
shed-while-queued request).  :meth:`RequestTracer.conservation`
exposes the books; the scheduler tests assert ``dangling == []``
alongside the lifecycle conservation law.
"""
from __future__ import annotations

import os
import time
from typing import Dict, List, Optional

from apex_tpu_torch.observability.registry import MetricsRegistry

__all__ = ["RequestTracer", "default_trace_sample",
           "TRACE_METRIC_FAMILIES", "TRACE_EVENTS"]

_TRACE_ENV = "APEX_TPU_TRACE"

#: metric families / event kinds this module emits — the schema-guard
#: test pins them into the committed ``.telemetry_schema.json``.
TRACE_METRIC_FAMILIES = ("serve_trace_spans_total",)
TRACE_EVENTS = ("trace_span",)

#: terminal span names: exactly one of these closes an admitted trace.
TERMINAL_SPANS = ("retired", "rejected")


def default_trace_sample() -> int:
    """``APEX_TPU_TRACE``: request-trace sampling — ``0`` (default)
    off, ``1`` every request, ``N`` one request in N (``uid % N == 0``,
    so the sampled subset is stable across waves).  Host-side only: the
    tracer never touches jitted code, so no value can recompile."""
    env = os.environ.get(_TRACE_ENV)
    if not env:
        return 0
    try:
        val = int(env)
    except ValueError as e:
        raise ValueError(
            f"{_TRACE_ENV} must be an int (0=off, 1=all, N=1-in-N), "
            f"got {env!r}") from e
    if val < 0:
        raise ValueError(f"{_TRACE_ENV} must be >= 0, got {val}")
    return val


class _Trace:
    """Host bookkeeping for one live trace (a handful of ints)."""

    __slots__ = ("uid", "wave", "t0", "seq", "admitted", "t_first")

    def __init__(self, uid: int, wave: int, t0: float):
        self.uid = uid
        self.wave = wave
        self.t0 = t0
        self.seq = 0
        self.admitted = False
        self.t_first: Optional[float] = None   # first-token stamp


class RequestTracer:
    """Emit per-request span events from the scheduler's host
    boundaries (driven by :class:`ServeTelemetry` — never called from
    jitted code).

    ``sample`` defaults from ``APEX_TPU_TRACE``; ``0`` disables every
    method (cheap early-outs on untraced uids).  Closed traces fold
    into counters — the per-trace record is dropped at its terminal
    span, so a long-lived scheduler holds state only for IN-FLIGHT
    requests.
    """

    def __init__(self, registry: MetricsRegistry,
                 sample: Optional[int] = None):
        self.registry = registry
        self.sample = (default_trace_sample() if sample is None
                       else int(sample))
        if self.sample < 0:
            raise ValueError(f"trace sample must be >= 0, "
                             f"got {self.sample}")
        self.spans = registry.declared("serve_trace_spans_total")
        self.wave = 0
        self._live: Dict[int, _Trace] = {}
        # closed-trace books (the per-trace record is gone)
        self.started = 0
        self.admitted = 0
        self.closed: Dict[str, int] = {}       # terminal span -> count
        self.orphan_terminals: List[int] = []  # terminal w/o live trace

    # -- plumbing ------------------------------------------------------------
    def enabled(self) -> bool:
        return self.sample > 0

    def traced(self, uid: int) -> bool:
        """Is this uid in the sampled subset?"""
        return self.sample == 1 or (self.sample > 0
                                    and uid % self.sample == 0)

    def begin_wave(self) -> None:
        """A scheduler ``run()`` started: traces admitted from here
        belong to the next wave."""
        self.wave += 1

    def _emit(self, tr: _Trace, span: str, start_s: float,
              dur_s: Optional[float], detail: Optional[str]) -> None:
        tr.seq += 1
        self.spans.inc()
        self.registry.emit_event(
            "trace_span", uid=int(tr.uid), wave=int(tr.wave),
            span=str(span), seq=int(tr.seq),
            start_s=round(float(start_s), 9),
            dur_s=(round(float(dur_s), 9) if dur_s is not None
                   else None),
            detail=(str(detail) if detail is not None else None))

    # -- lifecycle (mirrors ServeTelemetry's host boundaries) ---------------
    def request_submitted(self, uid: int, t0: float) -> None:
        """Open a trace at submit time (``t0`` = the telemetry's own
        ``perf_counter`` submit stamp, so TTFT and the queued span share
        one timebase).  No event yet — ``queued`` closes at admit."""
        if not self.traced(uid):
            return
        self._live[uid] = _Trace(uid, self.wave, t0)
        self.started += 1

    def request_admitted(self, uid: int, slot: int,
                         pages: Optional[int] = None,
                         prefix_tokens: int = 0) -> None:
        tr = self._live.get(uid)
        if tr is None:
            return
        now = time.perf_counter()
        # the trace belongs to the wave that SERVES it, not the idle
        # counter value at submit time
        tr.wave = self.wave
        tr.admitted = True
        self.admitted += 1
        self._emit(tr, "queued", 0.0, now - tr.t0, None)
        detail = f"slot={int(slot)}"
        if pages is not None:
            detail += f" pages={int(pages)}"
        if prefix_tokens:
            detail += f" prefix_tokens={int(prefix_tokens)}"
        self._emit(tr, "admitted", now - tr.t0, None, detail)

    def prefill_chunk(self, uid: int, t_start: float, dur_s: float,
                      start_tok: int, tokens: int,
                      bucket: Optional[int] = None) -> None:
        """One prefill dispatch bracket closed (monolithic prefill =
        chunk 0 covering the whole uncached tail)."""
        tr = self._live.get(uid)
        if tr is None:
            return
        detail = f"start={int(start_tok)} tokens={int(tokens)}"
        if bucket is not None:
            detail += f" bucket={int(bucket)}"
        self._emit(tr, "prefill_chunk", t_start - tr.t0, dur_s, detail)

    def cow_copy(self, uid: int, src: int, dst: int) -> None:
        tr = self._live.get(uid)
        if tr is None:
            return
        self._emit(tr, "cow_copy", time.perf_counter() - tr.t0, None,
                   f"page {int(src)}->{int(dst)}")

    def first_token(self, uid: int, ttft_s: float) -> None:
        tr = self._live.get(uid)
        if tr is None:
            return
        tr.t_first = tr.t0 + ttft_s
        self._emit(tr, "first_token", ttft_s, None, None)

    def request_finished(self, uid: int, reason: str,
                         n_tokens: int) -> None:
        """Close the decode span (first token -> retire) and emit the
        ``retired`` terminal; the trace record folds into counters."""
        if not self.traced(uid):
            return
        tr = self._live.pop(uid, None)
        if tr is None:
            self.orphan_terminals.append(int(uid))
            return
        now = time.perf_counter()
        if tr.t_first is not None:
            self._emit(tr, "decode", tr.t_first - tr.t0,
                       now - tr.t_first, f"tokens={int(n_tokens)}")
        self._emit(tr, "retired", now - tr.t0, None, str(reason))
        self.closed["retired"] = self.closed.get("retired", 0) + 1

    def request_rejected(self, uid: int, reason: str) -> None:
        """Terminal for a rejected-while-queued request (overload
        shedding): the trace closes with ``rejected`` so nothing
        dangles."""
        if not self.traced(uid):
            return
        tr = self._live.pop(uid, None)
        if tr is None:
            self.orphan_terminals.append(int(uid))
            return
        # same rule as admit: the trace belongs to the wave that
        # handled it — a request shed DURING a wave must not render
        # under the idle pre-wave index it was submitted in
        tr.wave = self.wave
        self._emit(tr, "rejected", time.perf_counter() - tr.t0, None,
                   str(reason))
        self.closed["rejected"] = self.closed.get("rejected", 0) + 1

    # -- span conservation ---------------------------------------------------
    def conservation(self) -> dict:
        """The span-conservation books the scheduler tests assert:
        every trace closes with exactly one terminal span —
        ``started == closed + live``, ``dangling`` (admitted but never
        terminated) and ``orphan_terminals`` (a terminal with no live
        trace: a double retire) both empty at a wave boundary."""
        closed = sum(self.closed.values())
        return {
            "started": self.started,
            "admitted": self.admitted,
            "closed": closed,
            "closed_by_span": dict(sorted(self.closed.items())),
            "live": len(self._live),
            "dangling": sorted(uid for uid, tr in self._live.items()
                               if tr.admitted),
            "orphan_terminals": list(self.orphan_terminals),
        }
