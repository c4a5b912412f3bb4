"""Discrete-event capacity simulator: "how many replicas for this
traffic mix at this SLO?"

Deterministic by construction — VIRTUAL time only (a float event
clock, never the wall clock), arrivals either fixed-spacing or drawn
from a SEEDED generator — so the same question always prices the same
answer.  Copied from ``apex_tpu/fleet/capacity.py``; the per-token
service latencies come from MEASURED numbers only: a
:class:`ServiceProfile` built from a run's own prefill tokens/s and
decode µs a token, or :func:`profile_from_captures` over a directory
of captures the caller names.  With no directory it reads nothing
(the repo's ``bench_captures/`` hold TPU-era figures, none of which
is the port's) and returns the ``unavailable:`` profile — the
simulator then refuses to price rather than fabricate numbers.

Model: one replica = ``slots`` servers behind one FIFO queue per
replica, round-robin splitting of arrivals across replicas (the
capacity question is policy-agnostic: affinity changes WHICH replica,
not HOW MANY — its prefix savings only make this estimate
conservative).  A request occupies one server for
``prompt_tokens * prefill_us + decode_tokens * decode_us``; its TTFT
is queue wait + prefill.  This deliberately ignores continuous-
batching overlap (decode batches across slots) — the same
conservatism direction as the padding in the fixed-shape executables.

Drift guard: :func:`drift_ratio` compares a simulator prediction with
a measured capture as ``max(pred/meas, meas/pred)`` (>= 1, lower is
better); the bench fleet leg stamps it as
``fleet_capacity_drift_ratio``, which ``observability/watch.py``
already trends lower-is-better by its ``_drift_ratio`` suffix.
``CAPACITY_DRIFT_TOLERANCE`` is the documented ceiling the watch
baseline starts from.
"""
from __future__ import annotations

import dataclasses
import heapq
import json
import pathlib
import re
from typing import List, Optional, Sequence

import numpy as np

__all__ = ["ServiceProfile", "profile_from_captures", "simulate",
           "required_replicas", "drift_ratio",
           "CAPACITY_DRIFT_TOLERANCE"]

#: Documented predicted-vs-measured agreement ceiling for the single-
#: replica sanity anchor (the bench fleet leg replays its own measured
#: arrivals through the simulator): the M/D/c model above ignores
#: decode batching and chunked-prefill interleaving, so 2x is the
#: honest envelope; the watch trends the stamped ratio DOWNWARD from
#: whatever a round actually achieves.
CAPACITY_DRIFT_TOLERANCE = 2.0

_ROUND_RE = re.compile(r"^r(\d+)_.*\.json$")


@dataclasses.dataclass(frozen=True)
class ServiceProfile:
    """Per-token service latencies (µs) + where they came from.
    ``provenance`` is ``measured:<capture>[:cpu]`` or an
    ``unavailable:`` marker — in the latter case both latencies are
    None and :func:`simulate` refuses to run."""
    prefill_us_per_token: Optional[float]
    decode_us_per_token: Optional[float]
    provenance: str

    @property
    def available(self) -> bool:
        return (self.prefill_us_per_token is not None
                and self.decode_us_per_token is not None)


def profile_from_captures(capdir=None) -> ServiceProfile:
    """Scan a directory of bench captures for measured per-token
    latencies: the NEWEST round (highest ``r<N>_`` prefix) carrying BOTH
    ``infer_prefill_tokens_per_s`` and ``infer_decode_token_us`` wins.
    CPU dryruns qualify (their provenance says so — ``:cpu`` suffix);
    no qualifying capture at all degrades to
    ``unavailable:no_measured_captures``, never fabricated zeros.
    Unlike JAX's, ``capdir=None`` reads no directory at all (no TPU-era
    capture prices the port) and returns that ``unavailable:``
    profile."""
    best = None            # (round, name, prefill_us, decode_us, backend)
    capdir = pathlib.Path(capdir) if capdir is not None else None
    if capdir is not None and capdir.is_dir():
        for path in sorted(capdir.iterdir()):
            m = _ROUND_RE.match(path.name)
            if not m:
                continue
            try:
                data = json.loads(path.read_text())
            except (OSError, json.JSONDecodeError):
                continue
            if not isinstance(data, dict):
                continue
            tps = data.get("infer_prefill_tokens_per_s")
            dus = data.get("infer_decode_token_us")
            if not tps or not dus or tps <= 0 or dus <= 0:
                continue
            cand = (int(m.group(1)), path.name, 1e6 / float(tps),
                    float(dus), str(data.get("backend") or ""))
            if best is None or cand[0] >= best[0]:
                best = cand
    if best is None:
        return ServiceProfile(None, None,
                              "unavailable:no_measured_captures")
    _, name, prefill_us, decode_us, backend = best
    prov = f"measured:{name}" + (":cpu" if backend == "cpu" else "")
    return ServiceProfile(prefill_us, decode_us, prov)


def _arrival_times(n: int, interarrival_us: float,
                   seed: Optional[int]) -> np.ndarray:
    """Virtual arrival clock: fixed spacing (seed None) or a SEEDED
    exponential draw with the same mean — deterministic either way."""
    if seed is None:
        return np.arange(n, dtype=np.float64) * float(interarrival_us)
    gaps = np.random.default_rng(int(seed)).exponential(
        float(interarrival_us), size=n)
    return np.cumsum(gaps) - gaps[0]


def simulate(profile: ServiceProfile, *, replicas: int, slots: int,
             n_requests: int = 256, interarrival_us: float = 1000.0,
             prompt_tokens=64, decode_tokens=16,
             seed: Optional[int] = None) -> dict:
    """Price one traffic mix on ``replicas`` x ``slots`` servers.

    ``prompt_tokens``/``decode_tokens`` are scalars or per-request
    sequences (cycled); arrivals round-robin across replicas, each
    replica FIFO-queues for its ``slots`` servers.  Returns TTFT
    percentiles (µs), utilization, and the virtual makespan — all
    stamped with the profile's provenance.  An ``unavailable:``
    profile returns ``{"provenance": ..., "ttft_p99_us": None, ...}``
    instead of fabricating numbers."""
    if replicas < 1 or slots < 1:
        raise ValueError(
            f"need replicas >= 1 and slots >= 1, got {replicas}/{slots}")
    if not profile.available:
        return {"provenance": profile.provenance, "ttft_p50_us": None,
                "ttft_p99_us": None, "utilization": None,
                "makespan_us": None, "n_requests": int(n_requests)}
    prompts = np.atleast_1d(np.asarray(prompt_tokens, np.float64))
    decodes = np.atleast_1d(np.asarray(decode_tokens, np.float64))
    arrivals = _arrival_times(n_requests, interarrival_us, seed)
    # per-replica server heaps of free-at times (one heap per replica
    # models its private slot pool; the router's policy choice only
    # re-labels WHICH pool, so capacity is policy-agnostic here)
    pools: List[list] = [[0.0] * slots for _ in range(replicas)]
    for pool in pools:
        heapq.heapify(pool)
    ttfts = np.empty(n_requests, np.float64)
    busy = 0.0
    makespan = 0.0
    for i in range(n_requests):
        pool = pools[i % replicas]
        p_us = prompts[i % prompts.shape[0]] \
            * profile.prefill_us_per_token
        d_us = decodes[i % decodes.shape[0]] \
            * profile.decode_us_per_token
        free_at = heapq.heappop(pool)
        start = max(free_at, arrivals[i])
        ttfts[i] = (start - arrivals[i]) + p_us
        done = start + p_us + d_us
        busy += p_us + d_us
        makespan = max(makespan, done)
        heapq.heappush(pool, done)
    util = busy / (replicas * slots * makespan) if makespan > 0 else 0.0
    return {
        "provenance": profile.provenance,
        "ttft_p50_us": float(np.percentile(ttfts, 50)),
        "ttft_p99_us": float(np.percentile(ttfts, 99)),
        "utilization": float(util),
        "makespan_us": float(makespan),
        "n_requests": int(n_requests),
    }


def required_replicas(profile: ServiceProfile, *, slots: int,
                      slo_ttft_us: float, n_requests: int = 256,
                      interarrival_us: float = 1000.0,
                      prompt_tokens=64, decode_tokens=16,
                      seed: Optional[int] = None,
                      max_replicas: int = 64) -> dict:
    """The sizing answer: the smallest replica count whose simulated
    p99 TTFT meets ``slo_ttft_us`` for this mix (monotone in replica
    count — each added replica only removes queue wait).  Returns
    ``{"replicas": n | None, "ttft_p99_us": ..., "provenance": ...}``;
    ``replicas`` is None when even ``max_replicas`` cannot meet the
    SLO (the mix's service time alone exceeds it) or when the profile
    is ``unavailable:``."""
    if not profile.available:
        return {"replicas": None, "ttft_p99_us": None,
                "provenance": profile.provenance}
    last = None
    for n in range(1, int(max_replicas) + 1):
        last = simulate(profile, replicas=n, slots=slots,
                        n_requests=n_requests,
                        interarrival_us=interarrival_us,
                        prompt_tokens=prompt_tokens,
                        decode_tokens=decode_tokens, seed=seed)
        if last["ttft_p99_us"] <= float(slo_ttft_us):
            return {"replicas": n,
                    "ttft_p99_us": last["ttft_p99_us"],
                    "provenance": profile.provenance}
    return {"replicas": None,
            "ttft_p99_us": last["ttft_p99_us"] if last else None,
            "provenance": profile.provenance}


def drift_ratio(predicted_us: Optional[float],
                measured_us: Optional[float]) -> Optional[float]:
    """Predicted-vs-measured agreement as ``max(p/m, m/p)`` — always
    >= 1, lower is better, direction-symmetric (over- and under-
    prediction read the same).  None (not a fake 1.0) when either side
    is missing or non-positive, so an ``unavailable:`` profile can
    never look perfectly calibrated."""
    if not predicted_us or not measured_us:
        return None
    if predicted_us <= 0 or measured_us <= 0:
        return None
    return max(predicted_us / measured_us, measured_us / predicted_us)
