"""Fleet front door: one ``submit()`` over N scheduler replicas.

Copied from ``apex_tpu/fleet/router.py`` with only the imports
changed.  One :class:`~apex_tpu_torch.inference.scheduler.SlotScheduler`
serves one engine (tp=N counts as one engine).  The
:class:`FleetRouter` is the layer above: a host-side router over N
engine+scheduler REPLICAS in one process, on one card or on several
(each engine on its own device); a router over processes is future
work.

Routing policies (``APEX_TPU_FLEET_POLICY``), all behind the same
``submit()``:

``round_robin``
    The baseline: replicas take turns.  Scatters shared prefixes
    across the fleet, so N replicas pay up to N cold prefills for one
    logical prefix — the bench leg's control arm.
``least_loaded``
    Pick the replica with the emptiest queue / fullest free-page pool;
    replicas whose overload advisory
    (:class:`~apex_tpu_torch.observability.slo.OverloadDetector`)
    holds sort last.  Load signal, no locality signal.
``prefix_affinity``
    Peek every replica's radix tree READ-ONLY
    (:meth:`~apex_tpu_torch.inference.prefix_cache.PrefixCache.peek_match`)
    and route to the replica where admission is CHEAPEST
    (:meth:`~apex_tpu_torch.inference.scheduler.SlotScheduler.
    admission_cost` — swap-aware: host-tier hits are discounted, not
    free), so shared prefixes land where their pages — HBM or host
    tier — already live.  A load-aware SPILL threshold keeps affinity
    from starving a replica: when the preferred replica is overloaded
    or its queue is past ``spill_queue_depth``, the request diverts to
    the least-loaded replica instead (counted in
    ``fleet_affinity_spills_total``).

Cross-replica shedding reuses the SLO layer's overload/burn-rate trackers as a
ROUTING signal, not just a report: when every replica's advisory holds
(fleet-wide pressure), each further submit sheds the globally
worst-ranked queued request — lowest effective priority across ALL
replica queues — or rejects the incoming request at the front door
when it ranks at or below that victim.

Conservation (``conservation()``, churn-swept by the tests): every
front-door submit is ROUTED to exactly one replica or SHED at the
router, Σ per-replica submitted == routed, and each replica's own
``submitted == finished + active + rejected`` law keeps holding.

The JAX package's protocol auditor model-checks this state machine
(its "fleet" scope); the port has no auditor of its own yet.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from apex_tpu_torch.observability import MetricsRegistry, ServeTelemetry
from apex_tpu_torch.observability.serve import FleetTelemetry

__all__ = ["FleetRouter", "build_fleet", "POLICIES",
           "fleet_replicas_from_env", "default_fleet_policy",
           "FLEET_REPLICAS_ENV", "FLEET_POLICY_ENV"]

FLEET_REPLICAS_ENV = "APEX_TPU_FLEET_REPLICAS"
FLEET_POLICY_ENV = "APEX_TPU_FLEET_POLICY"

#: policy names accepted by ``FleetRouter(policy=...)`` and the env knob
POLICIES = ("round_robin", "least_loaded", "prefix_affinity")


def fleet_replicas_from_env() -> int:
    """``APEX_TPU_FLEET_REPLICAS``: replica count for the fleet front
    door (``0`` = fleet off, serve behind one standalone scheduler)."""
    env = os.environ.get(FLEET_REPLICAS_ENV)
    if not env:
        return 0
    try:
        val = int(env)
    except ValueError as e:
        raise ValueError(
            f"{FLEET_REPLICAS_ENV} must be an integer replica count, "
            f"got {env!r}") from e
    if val < 0:
        raise ValueError(
            f"{FLEET_REPLICAS_ENV} must be >= 0, got {val}")
    return val


def default_fleet_policy() -> str:
    """``APEX_TPU_FLEET_POLICY``: routing policy when
    ``FleetRouter(policy=None)`` (default ``prefix_affinity``)."""
    env = os.environ.get(FLEET_POLICY_ENV)
    if not env:
        return "prefix_affinity"
    if env not in POLICIES:
        raise ValueError(
            f"{FLEET_POLICY_ENV} must be one of {POLICIES}, got "
            f"{env!r}")
    return env


class FleetRouter:
    """Route requests across ``replicas`` (a list of
    :class:`~apex_tpu_torch.inference.scheduler.SlotScheduler`).

    Each replica should carry its OWN telemetry registry so the
    per-replica conservation halves stay separable (the
    :func:`build_fleet` helper wires this); the router's
    :class:`~apex_tpu_torch.observability.serve.FleetTelemetry` may share a
    registry with at most one of them.

    ``submit()`` decides immediately (no queue at the router — the
    replicas queue) and returns a FLEET uid; ``run()`` drains every
    replica and returns ``{fleet_uid: tokens}``.
    """

    def __init__(self, replicas: List, policy: Optional[str] = None,
                 telemetry: Optional[FleetTelemetry] = None, *,
                 spill_queue_depth: Optional[int] = None,
                 shed_on_overload: bool = False):
        if not replicas:
            raise ValueError("a fleet needs at least one replica")
        self.replicas = list(replicas)
        for idx, rep in enumerate(self.replicas):
            if rep.replica_id is None:
                rep.replica_id = idx
        self.policy = policy if policy is not None \
            else default_fleet_policy()
        if self.policy not in POLICIES:
            raise ValueError(
                f"unknown fleet policy {self.policy!r}; pick one of "
                f"{POLICIES}")
        self.telemetry = (telemetry if telemetry is not None
                          else FleetTelemetry())
        # spill threshold (prefix_affinity): a preferred replica whose
        # queue is this deep (or whose overload advisory holds) loses
        # the request to the least-loaded replica.  Default 2x its
        # slot count: one full wave running + one full wave queued.
        self._spill_depth = spill_queue_depth
        self.shed_on_overload = bool(shed_on_overload)
        self._rr_next = 0                      # round_robin cursor
        self._next_uid = 0
        # fleet uid -> (replica index, local uid); the reverse ride in
        # results()/finish_reasons merging
        self.placements: Dict[int, Tuple[int, int]] = {}
        self.finish_reasons: Dict[int, str] = {}

    # -- load signals --------------------------------------------------------
    def _overloaded(self, rep) -> bool:
        """The SLO trackers as a routing signal: the load-trend
        advisory, OR any armed SLO burning error budget faster than
        sustainable in its last window."""
        if rep.slo.detector.overloaded:
            return True
        for spec in rep.slo.specs:
            burn = rep.slo.burn_rate.value(slo=spec.name)
            if burn is not None and burn > 1.0:
                return True
        return False

    def _free_pages(self, rep) -> Optional[int]:
        return rep.alloc.free_pages if rep.alloc is not None else None

    def _spill_threshold(self, rep) -> int:
        return (self._spill_depth if self._spill_depth is not None
                else 2 * rep.engine.slots)

    def _load_key(self, idx: int) -> tuple:
        """Sort key for least_loaded: advisory-clear first, then
        shallowest queue, then most free pages, then ordinal."""
        rep = self.replicas[idx]
        free = self._free_pages(rep)
        return (1 if self._overloaded(rep) else 0, len(rep.queue),
                -(free if free is not None else 0), idx)

    # -- policies ------------------------------------------------------------
    def _route_round_robin(self, prompt) -> Tuple[int, int, bool]:
        idx = self._rr_next % len(self.replicas)
        self._rr_next += 1
        return idx, 0, False

    def _route_least_loaded(self, prompt) -> Tuple[int, int, bool]:
        idx = min(range(len(self.replicas)), key=self._load_key)
        return idx, 0, False

    def _route_prefix_affinity(self, prompt) -> Tuple[int, int, bool]:
        toks = [int(t) for t in np.asarray(prompt).reshape(-1)]
        best, best_key, best_cov = None, None, 0
        for idx, rep in enumerate(self.replicas):
            cov = (rep.prefix.peek_match(toks)[0]
                   if rep.prefix is not None else 0)
            cost = rep.admission_cost(toks)
            # cheapest admission wins; ties go to the lighter replica
            key = (cost, self._load_key(idx))
            if best_key is None or key < best_key:
                best, best_key, best_cov = idx, key, cov
        rep = self.replicas[best]
        if best_cov and (self._overloaded(rep)
                         or len(rep.queue) >= self._spill_threshold(rep)):
            # load-aware spill: affinity never starves a replica —
            # recomputing the prefix elsewhere beats queueing behind a
            # hot spot
            spill = min(range(len(self.replicas)), key=self._load_key)
            if spill != best:
                return spill, 0, True
        return best, best_cov, False

    # -- cross-replica shedding ----------------------------------------------
    def _fleet_overloaded(self) -> bool:
        return all(self._overloaded(r) for r in self.replicas)

    def _worst_queued(self) -> Optional[Tuple[int, int]]:
        """(replica index, effective priority) of the globally
        worst-ranked queued request — the fleet's shed victim: lowest
        effective priority across every replica queue, deepest queue
        breaking ties."""
        worst, worst_key = None, None
        for idx, rep in enumerate(self.replicas):
            if not rep.queue:
                continue
            req = rep.queue[rep._pick_index(worst=True)]
            pr = req.priority + rep.tenant_priority.get(req.tenant, 0)
            key = (pr, -len(rep.queue), -idx)
            if worst_key is None or key < worst_key:
                worst, worst_key = (idx, pr), key
        return worst

    # -- the front door ------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int = 16,
               eos_id: Optional[int] = None, tenant: str = "default",
               priority: int = 0) -> int:
        """Route one request to a replica; returns its FLEET uid.

        Under fleet-wide overload (every replica's advisory up) with
        ``shed_on_overload=True``, each submit sheds the globally
        worst-ranked queued request first — or, when the INCOMING
        request ranks at or below that victim, rejects it at the front
        door (``finish_reasons[uid] == "shed"``, no replica ever sees
        it)."""
        tel = self.telemetry
        tel.request_submitted()
        uid = self._next_uid
        self._next_uid += 1
        route = getattr(self, f"_route_{self.policy}")
        idx, prefix_tokens, spilled = route(prompt)
        rep = self.replicas[idx]
        if self.shed_on_overload and self._fleet_overloaded():
            worst = self._worst_queued()
            pr_in = int(priority) + rep.tenant_priority.get(
                str(tenant), 0)
            if worst is not None and pr_in <= worst[1]:
                # the incoming request IS the fleet's worst: reject at
                # the front door, never touching a replica queue
                self.finish_reasons[uid] = "shed"
                tel.request_shed(None)
                return uid
            if worst is not None:
                w_idx = worst[0]
                self.replicas[w_idx].shed_worst()
                tel.request_shed(w_idx)
        for i in range(len(self.replicas)):
            r = self.replicas[i]
            tel.replica_load(i, len(r.queue), self._free_pages(r),
                             self._overloaded(r))
        tel.route(uid, idx, self.policy, prefix_tokens=prefix_tokens,
                  queue_depth=len(rep.queue),
                  free_pages=self._free_pages(rep),
                  overloaded=self._overloaded(rep), spilled=spilled)
        # routed is counted by tel.route above even if validation
        # raises below: the replica counts the same request submitted
        # AND rejected, so both conservation halves keep balancing
        local = rep.submit(prompt, max_new_tokens=max_new_tokens,
                           eos_id=eos_id, tenant=tenant,
                           priority=priority)
        self.placements[uid] = (idx, local)
        return uid

    def run(self) -> dict:
        """Drain every replica (process-local: sequentially) and merge
        results under fleet uids.  Replica-side finish reasons (shed
        included) fold into ``finish_reasons``."""
        merged: Dict[int, list] = {}
        locals_out = [rep.run() for rep in self.replicas]
        for uid, (idx, local) in self.placements.items():
            if local in locals_out[idx]:
                merged[uid] = locals_out[idx][local]
            reason = self.replicas[idx].finish_reasons.get(local)
            if reason is not None:
                self.finish_reasons[uid] = reason
        return merged

    # -- accounting ----------------------------------------------------------
    def conservation(self) -> dict:
        """The fleet-level conservation law: the router's
        ``submitted == routed + router-side sheds`` AND
        ``Σ per-replica submitted == routed`` AND every replica's own
        ``submitted == finished + active + rejected``.  ``holds`` is
        the conjunction — the L1 churn sweep asserts it every wave."""
        router = self.telemetry.conservation()
        reps = [r.telemetry.conservation() for r in self.replicas]
        fleet = {k: sum(c[k] for c in reps)
                 for k in ("submitted", "finished", "rejected",
                           "active")}
        holds = (
            router["submitted"] == router["routed"]
            + router["router_shed"]
            and fleet["submitted"] == router["routed"]
            and all(c["submitted"] == c["finished"] + c["active"]
                    + c["rejected"] for c in reps))
        return {"router": router, "replicas": reps, "fleet": fleet,
                "holds": holds}


def build_fleet(engines, policy: Optional[str] = None, *,
                registry: Optional[MetricsRegistry] = None,
                shed_on_overload: bool = False,
                spill_queue_depth: Optional[int] = None,
                **scheduler_kwargs) -> FleetRouter:
    """Wire one :class:`FleetRouter` over ``engines``: one
    :class:`~apex_tpu_torch.inference.scheduler.SlotScheduler` per engine,
    each with its OWN fresh telemetry registry (per-replica
    conservation stays separable), replica ids stamped in order.
    ``registry`` hosts the router's fleet families (fresh when None);
    ``scheduler_kwargs`` pass through to every scheduler."""
    from apex_tpu_torch.inference.scheduler import SlotScheduler
    replicas = [
        SlotScheduler(eng, ServeTelemetry(MetricsRegistry()),
                      replica_id=i, **scheduler_kwargs)
        for i, eng in enumerate(engines)]
    tel = FleetTelemetry(registry if registry is not None
                         else MetricsRegistry())
    return FleetRouter(replicas, policy=policy, telemetry=tel,
                       shed_on_overload=shed_on_overload,
                       spill_queue_depth=spill_queue_depth)
