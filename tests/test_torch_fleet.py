"""The fleet front door on the port against the JAX package (CPU).

The port's counterparts of ``tests/L0/run_inference/test_fleet_router.py``
and ``tests/L1/test_fleet_guard.py``.  ``apex_tpu_torch.fleet`` is a copy
of ``apex_tpu/fleet`` over the port's scheduler, so each scenario runs
on both packages' fleets, over engines on the same seeded numpy weights
(host tiers armed where JAX's tests arm them), and must route, shed,
serve and conserve alike: the same placements, the same fleet counters,
the same tokens.  The capacity simulator must give JAX's numbers on the
same profile and seed, and the port's ``profile_from_captures()`` with
no directory reads nothing and returns the ``unavailable:`` profile.
"""
import json

import numpy as np
import pytest
import torch

import apex_tpu_torch.fleet as tfleet
from apex_tpu_torch.fleet import (CAPACITY_DRIFT_TOLERANCE, FleetRouter,
                                  POLICIES, ServiceProfile, build_fleet,
                                  default_fleet_policy, drift_ratio,
                                  fleet_replicas_from_env,
                                  profile_from_captures, required_replicas,
                                  simulate)
from apex_tpu_torch.inference import (InferenceEngine, SlotScheduler,
                                      params_from_jax)
from apex_tpu_torch.inference.scheduler import HOST_HIT_TOKEN_COST
from apex_tpu_torch.observability import MetricsRegistry, ServeTelemetry
from apex_tpu_torch.transformer.testing import GPTConfig

from _torch_isolation import restore_torch_from_amp  # noqa: F401
from test_torch_host_tier import GPT_SMALL, PREFIX16, _np_tree

PREFIX = PREFIX16
N_REPLICAS = 3
WAVES = 200
#: three distinct page-aligned 16-token prefixes (page_size 8)
PREFIXES = [[int(t) for t in (np.arange(16) * (5 + 2 * i) + 2 + i) % 64]
            for i in range(N_REPLICAS)]
PROF_ARGS = (10.0, 100.0, "measured:test")


# -- both packages' pieces ---------------------------------------------------

class _Port:
    """The port's side of a scenario."""
    build_fleet = staticmethod(build_fleet)
    FleetRouter = FleetRouter
    SlotScheduler = SlotScheduler

    @staticmethod
    def engine(host_tier_bytes=0, num_pages=16):
        cfg = GPTConfig(**GPT_SMALL)
        params = params_from_jax("gpt", cfg, _np_tree(), device="cpu")
        return InferenceEngine("gpt", cfg, params, slots=2, max_seq=64,
                               page_size=8, num_pages=num_pages,
                               cache_dtype=torch.float32,
                               host_tier_bytes=host_tier_bytes,
                               device="cpu")

    @staticmethod
    def telemetry():
        return ServeTelemetry(MetricsRegistry())


class _Jax:
    """The JAX package's side (JAX imported when first used)."""

    def __getattr__(self, name):
        from apex_tpu import fleet
        from apex_tpu.inference import SlotScheduler as JaxScheduler
        return {"build_fleet": fleet.build_fleet,
                "FleetRouter": fleet.FleetRouter,
                "SlotScheduler": JaxScheduler}[name]

    @staticmethod
    def engine(host_tier_bytes=0, num_pages=16):
        import jax.numpy as jnp
        from apex_tpu.inference import InferenceEngine as JaxEngine
        from apex_tpu.transformer import parallel_state
        from apex_tpu.transformer.testing import GPTConfig as JGPTConfig
        parallel_state.destroy_model_parallel()
        parallel_state.initialize_model_parallel(1)
        return JaxEngine("gpt", JGPTConfig(**GPT_SMALL), _np_tree(),
                         slots=2, max_seq=64, page_size=8,
                         num_pages=num_pages, cache_dtype=jnp.float32,
                         host_tier_bytes=host_tier_bytes)

    @staticmethod
    def telemetry():
        from apex_tpu.observability import (MetricsRegistry as JRegistry,
                                            ServeTelemetry as JTelemetry)
        return JTelemetry(JRegistry())


SIDES = {"port": _Port(), "jax": _Jax()}


def _both(scenario):
    """Run ``scenario(side)`` on both packages; the results must be
    equal, and the port's is returned."""
    got = scenario(SIDES["port"])
    want = scenario(SIDES["jax"])
    assert got == want, (got, want)
    return got


def _fleet_books(fleet):
    return {"placements": dict(fleet.placements),
            "finish": dict(fleet.finish_reasons),
            "conservation": fleet.conservation()}


# -- the read-only peek and the admission cost -------------------------------

def test_peek_match_is_read_only():
    def scenario(side):
        sched = side.SlotScheduler(side.engine(), telemetry=side.telemetry())
        sched.submit(PREFIX + [1, 2], max_new_tokens=2)
        sched.run()
        pc = sched.prefix
        clock0 = pc._clock
        first = pc.peek_match(PREFIX + [1, 2])
        for _ in range(10):
            assert pc.peek_match(PREFIX + [1, 2]) == first
        assert pc._clock == clock0
        assert pc.peek_match([63, 62, 61]) == (0, 0, 0)
        return first
    covered, hbm, host = _both(scenario)
    assert covered >= 16 and hbm >= 2 and host == 0


def test_admission_cost_ordering_hbm_host_cold():
    """Full-HBM hit < host-tier hit < cold, and the arithmetic: the host
    hit pays the uncovered tail in full plus ``HOST_HIT_TOKEN_COST`` a
    host-covered token."""
    def scenario(side):
        eng = side.engine(host_tier_bytes=1 << 20)
        sched = side.SlotScheduler(eng, telemetry=side.telemetry())
        prompt = PREFIX + [1, 2]
        sched.submit(prompt, max_new_tokens=2)
        sched.run()
        cold = [int(t) for t in (np.arange(16) * 7 + 3) % 64] + [1, 2]
        cost_hbm = sched.admission_cost(prompt)
        cost_cold = sched.admission_cost(cold)
        sched.prefix.evict_lru(eng.num_pages)
        sched.drain_pending_swaps()
        assert sched.host_store.pages > 0
        return cost_hbm, sched.admission_cost(prompt), cost_cold
    hbm, host, cold = _both(scenario)
    assert hbm < host < cold
    assert cold == pytest.approx(18.0)
    assert host == pytest.approx(2.0 + HOST_HIT_TOKEN_COST * 16)


def test_admission_cost_without_prefix_cache_is_full_price():
    sched = SlotScheduler(_Port.engine(), telemetry=_Port.telemetry(),
                          prefix_cache=False)
    assert sched.admission_cost(PREFIX) == pytest.approx(16.0)


# -- routing policies ---------------------------------------------------------

def test_round_robin_stripes_uids():
    def scenario(side):
        fleet = side.build_fleet([side.engine() for _ in range(3)],
                                 policy="round_robin")
        for i in range(6):
            uid = fleet.submit(PREFIX + [i, i + 1], max_new_tokens=2)
            assert fleet.placements[uid][0] == i % 3
        out = fleet.run()
        assert fleet.conservation()["holds"]
        return out, _fleet_books(fleet)
    _both(scenario)


def test_least_loaded_prefers_empty_queue():
    def scenario(side):
        fleet = side.build_fleet([side.engine(), side.engine()],
                                 policy="least_loaded")
        fleet.replicas[0].submit(PREFIX + [9, 9], max_new_tokens=2)
        uid = fleet.submit(PREFIX + [1, 2], max_new_tokens=2)
        return fleet.placements[uid][0]
    assert _both(scenario) == 1


def test_prefix_affinity_chases_cached_pages():
    """After a seeding wave, requests sharing the prefix route to the
    replica that holds it, with the counters and route_decision events
    to show for it; host-tier replicas as JAX's fleet tests build."""
    def scenario(side):
        fleet = side.build_fleet(
            [side.engine(host_tier_bytes=1 << 20) for _ in range(2)],
            policy="prefix_affinity")
        events = []
        fleet.telemetry.registry.add_sink(
            type("S", (), {"event": lambda self, e: events.append(e),
                           "export": lambda self, fams: None})())
        seed = fleet.submit(PREFIX + [1, 2], max_new_tokens=2)
        fleet.run()
        home = fleet.placements[seed][0]
        outs = {}
        for i in range(3, 9, 2):
            uid = fleet.submit(PREFIX + [i, i + 1], max_new_tokens=2)
            assert fleet.placements[uid][0] == home
            outs.update(fleet.run())
        routes = [(e["policy"], e.get("replica")) for e in events
                  if e["kind"] == "route_decision"]
        tel = fleet.telemetry
        return (outs, routes, int(tel.affinity_hits.total()),
                int(tel.routed_prefix_tokens.total()), _fleet_books(fleet))
    _, routes, hits, tokens, books = _both(scenario)
    assert routes and all(p == "prefix_affinity" for p, _ in routes)
    assert hits >= 3 and tokens >= 3 * 16
    assert books["conservation"]["holds"]


def test_affinity_routes_to_host_tier_hits():
    """The swap-aware cost in routing: a prefix evicted to one replica's
    host tier still draws its requests there (a host hit is cheaper
    than a cold prefill elsewhere), and the hit is served by swap-in."""
    def scenario(side):
        fleet = side.build_fleet(
            [side.engine(host_tier_bytes=1 << 20) for _ in range(2)],
            policy="prefix_affinity")
        seed = fleet.submit(PREFIX + [1, 2], max_new_tokens=2)
        fleet.run()
        home = fleet.placements[seed][0]
        rep = fleet.replicas[home]
        rep.prefix.evict_lru(rep.engine.num_pages)
        uid = fleet.submit(PREFIX + [3, 4], max_new_tokens=2)
        out = fleet.run()
        return (fleet.placements[uid][0] == home, out,
                int(rep.telemetry.prefix_host_hits.total()),
                int(rep.telemetry.swap_in_pages.total()))
    same, _, hits, swapped = _both(scenario)
    assert same and hits == 1 and swapped == 2


def test_affinity_spills_off_deep_queue():
    def scenario(side):
        fleet = side.build_fleet([side.engine(), side.engine()],
                                 policy="prefix_affinity",
                                 spill_queue_depth=1)
        seed = fleet.submit(PREFIX + [1, 2], max_new_tokens=2)
        fleet.run()
        home = fleet.placements[seed][0]
        fleet.replicas[home].submit(PREFIX + [40, 41], max_new_tokens=2)
        uid = fleet.submit(PREFIX + [3, 4], max_new_tokens=2)
        return (fleet.placements[uid][0] != home,
                int(fleet.telemetry.affinity_spills.total()))
    assert _both(scenario) == (True, 1)


def test_unknown_policy_rejected():
    with pytest.raises(ValueError):
        FleetRouter([SlotScheduler(_Port.engine(),
                                   telemetry=_Port.telemetry())],
                    policy="hash_ring")
    with pytest.raises(ValueError):
        build_fleet([])


# -- env knobs ----------------------------------------------------------------

def test_fleet_env_knob_readers_as_jax(monkeypatch):
    from apex_tpu import fleet as jfleet

    def both(fn_name):
        got = getattr(tfleet, fn_name)()
        assert got == getattr(jfleet, fn_name)()
        return got

    monkeypatch.delenv("APEX_TPU_FLEET_REPLICAS", raising=False)
    monkeypatch.delenv("APEX_TPU_FLEET_POLICY", raising=False)
    assert both("fleet_replicas_from_env") == 0
    assert both("default_fleet_policy") == "prefix_affinity"
    monkeypatch.setenv("APEX_TPU_FLEET_REPLICAS", "4")
    monkeypatch.setenv("APEX_TPU_FLEET_POLICY", "least_loaded")
    assert both("fleet_replicas_from_env") == 4
    assert both("default_fleet_policy") == "least_loaded"
    for raw in ("-1", "two"):
        monkeypatch.setenv("APEX_TPU_FLEET_REPLICAS", raw)
        for fn in (fleet_replicas_from_env, jfleet.fleet_replicas_from_env):
            with pytest.raises(ValueError):
                fn()
    monkeypatch.setenv("APEX_TPU_FLEET_POLICY", "hash_ring")
    for fn in (default_fleet_policy, jfleet.default_fleet_policy):
        with pytest.raises(ValueError):
            fn()
    assert POLICIES == jfleet.POLICIES
    for p in POLICIES:
        monkeypatch.setenv("APEX_TPU_FLEET_POLICY", p)
        assert both("default_fleet_policy") == p


# -- the capacity simulator ---------------------------------------------------

SIM_CASES = [
    dict(replicas=2, slots=2, n_requests=64, interarrival_us=500.0,
         prompt_tokens=32, decode_tokens=8, seed=7),
    dict(replicas=2, slots=2, n_requests=64, interarrival_us=500.0,
         prompt_tokens=32, decode_tokens=8, seed=None),
    dict(replicas=3, slots=4, n_requests=128, interarrival_us=100.0,
         prompt_tokens=[64, 1024, 300], decode_tokens=[16, 32], seed=3),
]


@pytest.mark.parametrize("case", range(len(SIM_CASES)))
def test_simulate_gives_jax_numbers(case):
    from apex_tpu import fleet as jfleet
    kw = SIM_CASES[case]
    got = simulate(ServiceProfile(*PROF_ARGS), **kw)
    assert got == jfleet.simulate(jfleet.ServiceProfile(*PROF_ARGS), **kw)
    assert got == simulate(ServiceProfile(*PROF_ARGS), **kw)


def test_more_replicas_never_hurt_ttft():
    prof, prev = ServiceProfile(*PROF_ARGS), None
    for n in (1, 2, 4, 8):
        r = simulate(prof, replicas=n, slots=2, n_requests=128,
                     interarrival_us=100.0, prompt_tokens=64,
                     decode_tokens=16, seed=3)
        if prev is not None:
            assert r["ttft_p99_us"] <= prev + 1e-9
        prev = r["ttft_p99_us"]
    assert prev >= 64 * prof.prefill_us_per_token - 1e-9


@pytest.mark.parametrize("slo", [2000.0, 320.0, 50.0])
def test_required_replicas_gives_jax_numbers(slo):
    from apex_tpu import fleet as jfleet
    kw = dict(slots=2, slo_ttft_us=slo, n_requests=128,
              interarrival_us=100.0, prompt_tokens=64, decode_tokens=16,
              seed=3)
    got = required_replicas(ServiceProfile(*PROF_ARGS), **kw)
    assert got == jfleet.required_replicas(
        jfleet.ServiceProfile(*PROF_ARGS), **kw)
    if got["replicas"] is not None:
        assert got["ttft_p99_us"] <= slo
    if slo < 64 * PROF_ARGS[0]:                  # below one prefill
        assert got["replicas"] is None


def test_profile_from_captures_reads_no_tpu_capture(tmp_path):
    """With no directory the port reads nothing (the repo's TPU-era
    captures are no measurement of the port) and refuses to price; JAX's
    default still reads its committed captures."""
    prof = profile_from_captures()
    assert not prof.available
    assert prof.provenance == "unavailable:no_measured_captures"
    assert simulate(prof, replicas=2, slots=2)["ttft_p99_us"] is None
    assert required_replicas(prof, slots=2,
                             slo_ttft_us=1.0)["replicas"] is None
    assert profile_from_captures(tmp_path) == prof


def test_profile_from_captures_newest_round_wins_as_jax(tmp_path):
    from apex_tpu import fleet as jfleet
    (tmp_path / "r3_old.json").write_text(json.dumps(
        {"infer_prefill_tokens_per_s": 1e5, "infer_decode_token_us": 50.0}))
    (tmp_path / "r7_new.json").write_text(json.dumps(
        {"infer_prefill_tokens_per_s": 2e5, "infer_decode_token_us": 25.0,
         "backend": "cpu"}))
    (tmp_path / "r9_partial.json").write_text(json.dumps(
        {"infer_decode_token_us": 10.0}))
    (tmp_path / "notes.txt").write_text("not a capture")
    prof = profile_from_captures(tmp_path)
    assert prof.provenance == "measured:r7_new.json:cpu"
    assert prof.prefill_us_per_token == pytest.approx(5.0)
    assert prof.decode_us_per_token == pytest.approx(25.0)
    jprof = jfleet.profile_from_captures(tmp_path)
    assert (prof.prefill_us_per_token, prof.decode_us_per_token,
            prof.provenance) == (jprof.prefill_us_per_token,
                                 jprof.decode_us_per_token, jprof.provenance)


def test_drift_ratio_symmetric_and_null_safe():
    from apex_tpu import fleet as jfleet
    for p, m in ((100.0, 200.0), (200.0, 100.0), (None, 100.0),
                 (100.0, None), (0.0, 100.0), (100.0, -1.0), (3.0, 7.5)):
        assert drift_ratio(p, m) == jfleet.drift_ratio(p, m)
    assert drift_ratio(100.0, 200.0) == pytest.approx(2.0)
    assert CAPACITY_DRIFT_TOLERANCE == jfleet.CAPACITY_DRIFT_TOLERANCE


def test_bad_sim_shapes_rejected():
    prof = ServiceProfile(*PROF_ARGS)
    with pytest.raises(ValueError):
        simulate(prof, replicas=0, slots=2)
    with pytest.raises(ValueError):
        simulate(prof, replicas=2, slots=0)


# -- the guard's churn and shed storm -----------------------------------------

def _assert_books(fleet, ctx):
    law = fleet.conservation()
    assert law["holds"], (ctx, law)
    for rep in fleet.replicas:
        al = rep.alloc
        assert al.live_pages + al.free_pages == al.num_pages, ctx
        assert rep.prefix.host_pages == rep.host_store.pages, ctx


def test_churn_sweep_conserves_as_jax():
    """``test_fleet_guard``'s 200-wave sweep over three host-tier
    replicas (affinity routing, rotating prefixes, evictions to the host
    tier, replica-side sheds), books after every wave; the same
    placements, tokens and counters as JAX's fleet."""
    def scenario(side):
        fleet = side.build_fleet(
            [side.engine(host_tier_bytes=1 << 20)
             for _ in range(N_REPLICAS)], policy="prefix_affinity")
        outs = {}
        for w in range(WAVES):
            t1, t2 = (w * 7 + 1) % 64, (w * 11 + 2) % 64
            fleet.submit(PREFIXES[w % 3] + [t1, t2], max_new_tokens=2)
            fleet.submit(PREFIXES[(w + 1) % 3] + [t2, t1], max_new_tokens=2)
            if w % 5 == 2:
                rep = fleet.replicas[w % 3]
                rep.prefix.evict_lru(rep.engine.num_pages)
            if w % 7 == 3:
                idx = max(range(N_REPLICAS),
                          key=lambda i: len(fleet.replicas[i].queue))
                if fleet.replicas[idx].queue:
                    fleet.replicas[idx].shed_worst()
            outs.update(fleet.run())
            _assert_books(fleet, w)
        tel = fleet.telemetry
        per_replica = [int(tel.routed.value(replica=str(i)) or 0)
                       for i in range(N_REPLICAS)]
        swaps = [(int(r.telemetry.swap_out_pages.total()),
                  int(r.telemetry.swap_in_pages.total()))
                 for r in fleet.replicas]
        return (outs, per_replica, swaps, int(tel.routed.total()),
                int(tel.affinity_hits.total()), _fleet_books(fleet))
    _, per_replica, swaps, routed, hits, _ = _both(scenario)
    assert routed == 2 * WAVES and hits > 0
    assert all(n > 0 for n in per_replica), per_replica
    assert all(out > 0 for out, _ in swaps)


def test_seeded_skewed_tenant_shed_burst_converges_as_jax(monkeypatch):
    """Every replica burning its TTFT budget: each submit of a seeded
    burst either rejects the newcomer at the front door or sheds the
    fleet's worst queued request, leaving the one highest-priority
    survivor; as JAX's fleet does."""
    monkeypatch.setenv("APEX_TPU_SLO_TTFT_US", "1")

    def scenario(side):
        fleet = side.build_fleet(
            [side.engine(host_tier_bytes=1 << 20)
             for _ in range(N_REPLICAS)], policy="round_robin",
            shed_on_overload=True)
        for i in range(N_REPLICAS):
            fleet.submit(PREFIXES[i] + [1, 2], max_new_tokens=2)
        fleet.run()
        assert all(fleet._overloaded(r) for r in fleet.replicas)
        _assert_books(fleet, "armed")
        prios = [int(p) for p in np.random.default_rng(19).permutation(10)]
        uids = {p: fleet.submit(PREFIXES[p % 3] + [p, 3], max_new_tokens=2,
                                tenant=f"t{p % 2}", priority=p)
                for p in prios}
        queued = [req.priority for rep in fleet.replicas
                  for req in rep.queue]
        law = fleet.conservation()
        out = fleet.run()
        shed = sorted(p for p in prios
                      if fleet.finish_reasons.get(uids[p]) == "shed")
        _assert_books(fleet, "after burst")
        return queued, law, uids[max(prios)] in out, shed, max(prios)
    queued, law, survived, shed, top = _both(scenario)
    assert queued == [top] and law["holds"] and survived
    assert len(shed) == 9 and top not in shed
