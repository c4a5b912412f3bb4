"""Fleet front door: the layer ABOVE one engine+scheduler, copied from
``apex_tpu/fleet`` with only the imports changed (and
:func:`profile_from_captures` reading no directory unless given one).

``router``
    :class:`FleetRouter` — one ``submit()`` over N scheduler replicas
    with pluggable routing (``round_robin`` / ``least_loaded`` /
    ``prefix_affinity``), the SLO layer's overload/burn-rate trackers as the
    routing + cross-replica shedding signal, and a fleet-level
    conservation law.
``capacity``
    A deterministic discrete-event simulator pricing replica counts
    against traffic mixes from MEASURED per-token latencies
    (``unavailable:`` provenance when none exist — never fabricated).
"""
from apex_tpu_torch.fleet.capacity import (CAPACITY_DRIFT_TOLERANCE,
                                           ServiceProfile, drift_ratio,
                                           profile_from_captures,
                                           required_replicas, simulate)
from apex_tpu_torch.fleet.router import (FLEET_POLICY_ENV,
                                         FLEET_REPLICAS_ENV, POLICIES,
                                         FleetRouter, build_fleet,
                                         default_fleet_policy,
                                         fleet_replicas_from_env)

__all__ = [
    "FleetRouter", "build_fleet", "POLICIES",
    "fleet_replicas_from_env", "default_fleet_policy",
    "FLEET_REPLICAS_ENV", "FLEET_POLICY_ENV",
    "ServiceProfile", "profile_from_captures", "simulate",
    "required_replicas", "drift_ratio", "CAPACITY_DRIFT_TOLERANCE",
]
