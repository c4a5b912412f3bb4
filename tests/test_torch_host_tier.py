"""The host page tier on the port against the JAX package (CPU).

The port's counterparts of ``tests/L0/run_inference/test_host_tier.py``,
``test_deferred_swap.py`` and ``tests/L1/test_host_tier_guard.py``'s
churn.  The same seeded numpy pools and weights go into both packages:

* the copy functions (``extract_pages``, ``restore_pages``) against
  JAX's, bit for bit on fp32 and bf16 pools,
  the clip and drop rules for ids outside the pool included, and their
  validation messages;
* the engine's swap-out slabs against the JAX engine's: a bf16 pool's
  ``uint16`` bits against JAX's bf16 slab viewed as ``uint16``; the
  dispatch counts a batch; ``page_host_bytes``; the env knobs;
* the deferred swap-out (``PendingSwapOut``) and the copied host store;
* the scheduler end to end: a hit after eviction swaps the prefix back
  in and serves the cold run's tokens, bit for bit, and JAX's engine's
  on the same weights, at tp = 1 in this process and at tp = 2 in two
  spawned gloo ranks (one process a rank, as
  ``tests/test_torch_tp_serving.py`` runs them), whose slabs side by
  side on the kv-head axis, in rank order, are JAX's tp = 2 slab.
"""
import datetime

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from apex_tpu_torch.inference import InferenceEngine, SlotScheduler, kv_cache
from apex_tpu_torch.inference import params_from_jax
from apex_tpu_torch.inference.engine import (PendingSwapOut,
                                             host_kv_tier_bytes)
from apex_tpu_torch.inference.kv_cache import HostPageStore, _DeferredSlab
from apex_tpu_torch.inference.weights import gpt_param_shapes
from apex_tpu_torch.observability import MetricsRegistry, ServeTelemetry
from apex_tpu_torch.ops import _build
from apex_tpu_torch.transformer.testing import GPTConfig

from _torch_isolation import restore_torch_from_amp  # noqa: F401

LAYERS, KVH, PS, D, SLOTS, MPPS, PAGES = 2, 2, 4, 8, 3, 4, 6
#: JAX's test engine: GPT, 1 layer, 2 heads of 16, page 8, 16 pages
GPT_SMALL = dict(vocab_size=64, hidden_size=32, num_layers=1,
                 num_attention_heads=2, max_seq_length=64,
                 hidden_dropout=0.0, attention_dropout=0.0)
ENGINE = dict(slots=2, max_seq=64, page_size=8, num_pages=16)
PREFIX = [int(t) for t in (np.arange(24) * 7 + 3) % 64]    # 3 full pages
PREFIX16 = [int(t) for t in (np.arange(16) * 5 + 2) % 64]
DTYPES = ["float32", "bfloat16"]


def _np_pool(seed=0):
    rng = np.random.RandomState(seed)
    shape = (PAGES + 1, LAYERS, KVH, PS, D)
    return (rng.randn(*shape).astype(np.float32),
            rng.randn(*shape).astype(np.float32))


def _bits(x) -> np.ndarray:
    """An array's bits: bf16 (a torch tensor, a numpy uint16 or an
    ml_dtypes array) as uint16, anything else as itself."""
    if torch.is_tensor(x):
        x = (x.view(torch.int16).numpy().view(np.uint16)
             if x.dtype == torch.bfloat16 else x.numpy())
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype.name == "bfloat16" else x


def _caches(dtype, seed=0):
    """The same seeded pool in both packages: (port cache, JAX cache)."""
    import jax.numpy as jnp
    from apex_tpu.inference import kv_cache as jkv
    k, v = _np_pool(seed)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    tc = kv_cache.init_paged_cache(PAGES, LAYERS, KVH, PS, D, slots=SLOTS,
                                   max_pages_per_slot=MPPS, dtype=tdt,
                                   device="cpu")
    tc.k.copy_(torch.from_numpy(k))
    tc.v.copy_(torch.from_numpy(v))
    jc = jkv.init_paged_cache(PAGES, LAYERS, KVH, PS, D, slots=SLOTS,
                              max_pages_per_slot=MPPS, dtype=jdt)
    jc = jc.replace(k=jnp.asarray(k, jdt), v=jnp.asarray(v, jdt))
    return tc, jc


def _assert_pool(tc, jc):
    assert np.array_equal(_bits(tc.k), _bits(np.asarray(jc.k)))
    assert np.array_equal(_bits(tc.v), _bits(np.asarray(jc.v)))


# -- the copy functions ------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_extract_restore_roundtrip_matches_jax(dtype):
    """JAX's round trip: pages [4, 1] out, back in at [0, 3]; the slabs
    and the whole pool after it equal JAX's bit for bit."""
    import jax.numpy as jnp
    from apex_tpu.inference import kv_cache as jkv
    tc, jc = _caches(dtype)
    k0 = tc.k.clone()
    ks, vs = kv_cache.extract_pages(tc, [4, 1])
    jks, jvs = jkv.extract_pages(jc, jnp.asarray([4, 1], jnp.int32))
    assert np.array_equal(_bits(ks), _bits(np.asarray(jks)))
    assert np.array_equal(_bits(vs), _bits(np.asarray(jvs)))
    assert torch.equal(ks, k0[[4, 1]])
    out = kv_cache.restore_pages(tc, np.array([0, 3]), ks, vs)
    assert out is tc                                  # in place
    jc = jkv.restore_pages(jc, jnp.asarray([0, 3], jnp.int32), jks, jvs)
    _assert_pool(tc, jc)
    assert torch.equal(tc.k[0], k0[4]) and torch.equal(tc.k[2], k0[2])


@pytest.mark.parametrize("dtype", DTYPES)
def test_extract_clips_restore_drops_as_jax(dtype):
    """Ids outside the pool: extract clamps them (JAX's ``mode="clip"``:
    the trash page for ids past the pool, page 0 for negative ids),
    restore drops them (``mode="drop"``, a negative id counting from the
    end first), so padding lanes never touch live pages."""
    import jax.numpy as jnp
    from apex_tpu.inference import kv_cache as jkv
    tc, jc = _caches(dtype, seed=1)
    ids = [2, PAGES, PAGES + 5, -3]
    ks, vs = kv_cache.extract_pages(tc, torch.tensor(ids))
    jks, jvs = jkv.extract_pages(jc, jnp.asarray(ids, jnp.int32))
    assert np.array_equal(_bits(ks), _bits(np.asarray(jks)))
    assert np.array_equal(_bits(vs), _bits(np.asarray(jvs)))
    rng = np.random.RandomState(2)
    slab = rng.randn(5, LAYERS, KVH, PS, D).astype(np.float32)
    drop = [PAGES + 1, -1, -(PAGES + 3), 0, 3 * PAGES]
    kv_cache.restore_pages(tc, drop, torch.from_numpy(slab),
                           torch.from_numpy(-slab))
    jslab = jnp.asarray(slab, getattr(jnp, dtype))
    jc = jkv.restore_pages(jc, jnp.asarray(drop, jnp.int32), jslab, -jslab)
    _assert_pool(tc, jc)
    # every lane out of range: the pool stays as it was, bit for bit
    before = tc.k.clone()
    kv_cache.restore_pages(tc, [PAGES + 1, -(PAGES + 2)],
                           torch.zeros(2, LAYERS, KVH, PS, D),
                           torch.zeros(2, LAYERS, KVH, PS, D))
    assert torch.equal(tc.k, before)


def test_copy_functions_validation_as_jax():
    import jax.numpy as jnp
    from apex_tpu.inference import kv_cache as jkv
    tc, jc = _caches("float32")
    for mod, cache, ids in ((kv_cache, tc, torch.zeros(2, 2, dtype=torch.int32)),
                            (jkv, jc, jnp.zeros((2, 2), jnp.int32))):
        with pytest.raises(ValueError, match="rank-1 int32 vector, got "
                                             r"shape \(2, 2\)"):
            mod.extract_pages(cache, ids)
    bad = np.zeros((2, LAYERS, KVH, PS + 1, D), np.float32)
    msgs = []
    for mod, cache, slab in ((kv_cache, tc, torch.from_numpy(bad)),
                             (jkv, jc, jnp.asarray(bad))):
        with pytest.raises(ValueError, match="swap-in slabs must be") as e:
            mod.restore_pages(cache, np.array([0, 1], np.int32), slab, slab)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


# -- the host store and the knobs --------------------------------------------

def test_host_store_budget_handles_and_deferred_entries():
    """The copied store: a strict byte budget, race-tolerant pops, and
    deferred entries booked at once and materialized on first read."""

    class Pending:
        calls = 0

        def resolve(self):
            Pending.calls += 1
            k = np.arange(24, dtype=np.uint16).reshape(3, 8)
            return k, k + 1

    st = HostPageStore(3 * 128, 128)
    a = st.put(np.ones(2), np.ones(2))
    h1, h2 = st.put_deferred(2, Pending())
    assert (st.pages, st.bytes_used, Pending.calls) == (3, 384, 0)
    with pytest.raises(ValueError, match="over budget"):
        st.put(None, None)
    assert st.snapshot() == {a: "resident", h1: "deferred", h2: "deferred"}
    k, v = st.get(h2)
    assert Pending.calls == 1 and k.dtype == np.uint16
    assert np.array_equal(k, np.arange(8, 16)) and np.array_equal(v, k + 1)
    assert not isinstance(st._slabs[h2], _DeferredSlab)
    assert st.pop(h1) is not None and st.pop(h1) is None
    with pytest.raises(KeyError):
        st.get(h1)


def test_env_knobs_as_jax(monkeypatch):
    from apex_tpu.inference import kv_cache as jkv
    from apex_tpu.inference.engine import host_kv_tier_bytes as jax_tier
    for name in ("APEX_TPU_SWAP_BATCH_PAGES", "APEX_TPU_HOST_KV_TIER_BYTES"):
        monkeypatch.delenv(name, raising=False)
    assert kv_cache.default_swap_batch_pages() == \
        jkv.default_swap_batch_pages() == 8
    assert host_kv_tier_bytes() == jax_tier() == 0
    monkeypatch.setenv("APEX_TPU_SWAP_BATCH_PAGES", "4")
    monkeypatch.setenv("APEX_TPU_HOST_KV_TIER_BYTES", "4096")
    assert kv_cache.default_swap_batch_pages() == 4
    assert host_kv_tier_bytes() == jax_tier() == 4096
    for knob, bad, fns in (
            ("APEX_TPU_SWAP_BATCH_PAGES", ("0", "x"),
             (kv_cache.default_swap_batch_pages,
              jkv.default_swap_batch_pages)),
            ("APEX_TPU_HOST_KV_TIER_BYTES", ("-1", "x"),
             (host_kv_tier_bytes, jax_tier))):
        for raw in bad:
            monkeypatch.setenv(knob, raw)
            msgs = []
            for fn in fns:
                with pytest.raises(ValueError, match=knob) as e:
                    fn()
                msgs.append(str(e.value))
            assert msgs[0] == msgs[1]


# -- the engines -------------------------------------------------------------

def _np_tree(seed=0):
    """A seeded numpy GPT tree both packages take (JAX's bare tree):
    linears N(0, 1/fan_in), biases N(0, 0.02^2), norms 1 + N(0, 0.1^2),
    the word embedding N(0, 1), positions N(0, 0.1^2)."""
    cfg = GPTConfig(**GPT_SMALL)
    rng = np.random.RandomState(seed)
    tree: dict = {}
    for path, shape in sorted(gpt_param_shapes(cfg).items()):
        t = rng.randn(*shape)
        if path[-1] == "bias":
            t = 0.02 * t
        elif path[-1] == "position_embeddings":
            t = 0.1 * t
        elif len(shape) == 1:
            t = 1 + 0.1 * t
        elif "embed" not in "/".join(path):
            t = t / np.sqrt(shape[1])
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = t.astype(np.float32)
    return tree


def _port_engine(cache_dtype="float32", tp=1, **kw):
    cfg = GPTConfig(**GPT_SMALL)
    params = params_from_jax("gpt", cfg, _np_tree(), device="cpu")
    return InferenceEngine("gpt", cfg, params, cache_dtype=getattr(
        torch, cache_dtype), device="cpu", tp=tp, **dict(ENGINE, **kw))


def _jax_engine(cache_dtype="float32", tp=1, **kw):
    import jax.numpy as jnp
    from apex_tpu.inference import InferenceEngine as JaxEngine
    from apex_tpu.transformer import parallel_state
    from apex_tpu.transformer.testing import GPTConfig as JGPTConfig
    parallel_state.destroy_model_parallel()
    parallel_state.initialize_model_parallel(1)
    return JaxEngine("gpt", JGPTConfig(**GPT_SMALL), _np_tree(),
                     cache_dtype=getattr(jnp, cache_dtype), tp=tp,
                     **dict(ENGINE, **kw))


def _jax_sched(eng):
    from apex_tpu.inference import SlotScheduler as JaxScheduler
    from apex_tpu.observability import (MetricsRegistry as JRegistry,
                                        ServeTelemetry as JTelemetry)
    return JaxScheduler(eng, telemetry=JTelemetry(JRegistry()))


def _sched(eng, **kw):
    return SlotScheduler(eng, telemetry=ServeTelemetry(MetricsRegistry()),
                         **kw)


def _fill(eng, cache, seed=5):
    """The pool's pages set to seeded numpy values (the whole pool of
    ``eng``'s geometry; a tp rank keeps its heads); returns them."""
    shape = (eng.num_pages + 1, eng.dims["layers"],
             eng.tp_dims["kv_heads_pool"], eng.page_size,
             eng.dims["head_dim"])
    rng = np.random.RandomState(seed)
    k, v = (rng.randn(*shape).astype(np.float32) for _ in range(2))
    h = cache.k.shape[2]
    rank = getattr(eng, "rank", 0)
    cache.k.copy_(torch.from_numpy(k[:, :, rank * h:(rank + 1) * h]))
    cache.v.copy_(torch.from_numpy(v[:, :, rank * h:(rank + 1) * h]))
    return k, v


def _jax_filled(eng, seed=5):
    import jax
    k, v = _fill(eng, kv_cache.init_paged_cache(
        eng.num_pages, eng.dims["layers"], eng.tp_dims["kv_heads_pool"],
        eng.page_size, eng.dims["head_dim"], slots=eng.slots,
        max_pages_per_slot=eng.max_pages_per_slot, device="cpu"), seed)
    cache = eng.init_cache()
    return cache.replace(
        k=jax.device_put(k.astype(cache.k.dtype), cache.k.sharding),
        v=jax.device_put(v.astype(cache.v.dtype), cache.v.sharding))


@pytest.mark.parametrize("dtype", DTYPES)
def test_swap_out_slabs_and_dispatch_counts_match_jax(dtype):
    """5 pages at batch 2: three dispatches each way in both packages,
    the slabs JAX's bit for bit (a bf16 pool's as ``uint16`` bits: the
    port hands numpy no bfloat16), ``page_host_bytes`` JAX's; the swap-in
    of those slabs into other pages writes JAX's pool."""
    eng = _port_engine(dtype, host_tier_bytes=1 << 20, swap_batch_pages=2)
    jeng = _jax_engine(dtype, host_tier_bytes=1 << 20, swap_batch_pages=2)
    assert eng.page_host_bytes() == jeng.page_host_bytes() \
        == 2 * 1 * 2 * 8 * 16 * (4 if dtype == "float32" else 2)
    cache = eng.init_cache()
    _fill(eng, cache)
    jcache = _jax_filled(jeng)
    ids = [3, 0, 7, 1, 12]
    outs = []
    for e in (eng, jeng):
        e._refresh_dispatch_counters()
        o0, i0 = (int(e._swap_out_dispatches.total()),
                  int(e._swap_in_dispatches.total()))
        outs.append((e, o0, i0))
    k, v = eng.swap_out_pages(cache, ids)
    jk, jv = jeng.swap_out_pages(jcache, ids)
    assert k.dtype == (np.float32 if dtype == "float32" else np.uint16)
    assert k.shape == (5, 1, 2, 8, 16)
    assert np.array_equal(k, _bits(jk)) and np.array_equal(v, _bits(jv))
    cache = eng.swap_in_pages(cache, [2, 4, 5, 6, 8], k, v)
    jcache = jeng.swap_in_pages(jcache, [2, 4, 5, 6, 8], jk, jv)
    assert np.array_equal(_bits(cache.k), _bits(np.asarray(jcache.k)))
    assert np.array_equal(_bits(cache.v), _bits(np.asarray(jcache.v)))
    for e, o0, i0 in outs:
        assert int(e._swap_out_dispatches.total()) - o0 == 3
        assert int(e._swap_in_dispatches.total()) - i0 == 3
    with pytest.raises(ValueError, match="one entry per page id"):
        eng.swap_in_pages(cache, [1, 2], k, v)
    with pytest.raises(ValueError, match="at least one page"):
        eng.swap_out_pages(cache, [])


def test_swap_in_casts_floating_slabs_and_reads_uint16_as_bf16():
    """JAX's ``astype``: an fp32 slab into a bf16 pool rounds to bf16;
    ``uint16`` bits land unchanged."""
    eng = _port_engine("bfloat16", host_tier_bytes=1 << 20)
    cache = eng.init_cache()
    x = np.random.RandomState(6).randn(1, 1, 2, 8, 16).astype(np.float32)
    want = _bits(torch.from_numpy(x).to(torch.bfloat16))
    for slab in (x, want):
        cache.k.zero_()
        eng.swap_in_pages(cache, [4], slab, slab)
        assert np.array_equal(_bits(cache.k[4:5]), want)


def test_engine_tier_validation_as_jax():
    """The dense cache with a tier, a negative budget and a zero batch
    raise JAX's ``ValueError``s; the tier is off by default, and then no
    scheduler arms a store."""
    cfg = GPTConfig(**GPT_SMALL)
    params = params_from_jax("gpt", cfg, _np_tree(), device="cpu")
    with pytest.raises(ValueError, match="paged"):
        InferenceEngine("gpt", cfg, params, slots=2, max_seq=64,
                        host_tier_bytes=1 << 20, device="cpu")
    with pytest.raises(ValueError, match="host_tier_bytes must be >= 0"):
        _port_engine(host_tier_bytes=-1)
    with pytest.raises(ValueError, match="swap_batch_pages must be >= 1"):
        _port_engine(host_tier_bytes=1 << 20, swap_batch_pages=0)
    eng = _port_engine()
    assert eng.host_tier_bytes == 0 and eng.swap_batch_pages == 8
    assert _sched(eng).host_store is None
    dense = InferenceEngine("gpt", cfg, params, slots=2, max_seq=64,
                            device="cpu")
    assert dense.swap_batch_pages is None
    for fn in (dense.page_host_bytes, lambda: dense.swap_out_pages(
            None, [0]), lambda: dense.swap_in_pages(None, [0], [0], [0])):
        with pytest.raises(ValueError, match="dense slot cache"):
            fn()


def test_deferred_swap_out_resolves_once_and_survives_overwrite():
    """``defer=True``: a ``PendingSwapOut`` that resolves once (the same
    arrays every time) to the eager slabs, bit for bit, though the pages
    were overwritten in place before ``resolve()``."""
    eng = _port_engine("bfloat16", host_tier_bytes=1 << 20,
                       swap_batch_pages=2)
    cache = eng.init_cache()
    _fill(eng, cache)
    ids = [0, 1, 2]
    k_e, v_e = eng.swap_out_pages(cache, ids)
    pending = eng.swap_out_pages(cache, ids, defer=True)
    assert isinstance(pending, PendingSwapOut) and not pending.done
    cache.k[torch.tensor(ids)] = 0
    cache.v[torch.tensor(ids)] = 7
    k_d, v_d = pending.resolve()
    assert pending.done and pending.resolve()[0] is k_d
    assert np.array_equal(k_d, k_e) and np.array_equal(v_d, v_e)


# -- the scheduler end to end -------------------------------------------------

def _books(sched):
    al = sched.alloc
    assert al.live_pages + al.free_pages == al.num_pages
    assert al.weighted_live() == sched.prefix.pinned_pages + sum(
        len(st.pages) for st in sched._run_slots if st is not None)
    assert sched.prefix.host_pages == sched.host_store.pages


def _hit_after_eviction(eng, sched):
    """JAX's tentpole run: serve, evict every page to the host tier,
    serve the same prompt again (a host hit); returns both streams and
    the counters."""
    tel = sched.telemetry
    u0 = sched.submit(PREFIX + [9], max_new_tokens=4)
    ref = sched.run()[u0]
    freed = sched.prefix.evict_lru(eng.num_pages)
    host = sched.prefix.host_pages
    out0 = int(tel.swap_out_pages.total())
    u1 = sched.submit(PREFIX + [9], max_new_tokens=4)
    out = sched.run()[u1]
    return dict(ref=ref, out=out, freed=freed, host=host, out0=out0,
                swap_in=int(tel.swap_in_pages.total()),
                host_hits=int(tel.prefix_host_hits.total()),
                after=(sched.prefix.host_pages, sched.host_store.pages))


def _cold(eng, prompt, n):
    sched = _sched(eng, prefix_cache=False)
    u = sched.submit(prompt, max_new_tokens=n)
    return sched.run()[u]


@pytest.mark.parametrize("dtype", DTYPES)
def test_hit_after_eviction_swaps_in_and_serves_the_cold_tokens(dtype):
    """The tentpole at tp = 1: after evict -> swap-out -> hit -> swap-in
    the tokens are the cold run's (no prefix cache) bit for bit and the
    JAX engine's on the same weights; the counters and the books as in
    JAX's test."""
    eng = _port_engine(dtype, host_tier_bytes=1 << 20)
    _build.reset_launch_counts()
    sched = _sched(eng)
    got = _hit_after_eviction(eng, sched)
    _books(sched)
    jeng = _jax_engine(dtype, host_tier_bytes=1 << 20)
    want = _hit_after_eviction(jeng, _jax_sched(jeng))
    assert got == want
    assert got["out"] == got["ref"] == _cold(eng, PREFIX + [9], 4)
    assert (got["freed"], got["host"], got["out0"]) == (4, 3, 3)
    assert (got["swap_in"], got["host_hits"], got["after"]) == (3, 1, (0, 0))
    assert not any(_build.launch_counts().values())


def test_boundary_subpage_match_on_host_edge():
    """A hit whose boundary falls inside a host-resident page: the
    swapped-in copy is the request's own (no COW), the rows past the
    boundary masked by ``prefill_from``; the tokens are a cold run's."""
    eng = _port_engine(host_tier_bytes=1 << 20)
    long = [int(t) for t in (np.arange(32) * 5 + 1) % 64]    # 4 pages
    probe = long[:28] + [7]
    ref = _cold(eng, probe, 4)
    sched = _sched(eng)
    sched.submit(long, max_new_tokens=2)
    sched.run()
    sched.prefix.evict_lru(eng.num_pages)
    assert sched.prefix.host_pages == 4
    u = sched.submit(probe, max_new_tokens=4)
    assert sched.run()[u] == ref
    tel = sched.telemetry
    assert int(tel.swap_in_pages.total()) == 4
    assert int(tel.prefix_host_hits.total()) == 1
    assert int(tel.cow_copies.total()) == 0


def _churn(eng, sched):
    """JAX's scheduler churn: four waves of three prompts over the
    3-page prefix, every page evicted to the host tier after waves 0
    and 2; books after every wave."""
    rng = np.random.RandomState(3)
    outs = {}
    for wave in range(4):
        for _ in range(3):
            tail = [int(t) for t in rng.randint(0, 64, 2)]
            sched.submit(PREFIX + tail, max_new_tokens=2)
        outs.update(sched.run())
        al = sched.alloc
        assert al.live_pages + al.free_pages == al.num_pages
        assert al.weighted_live() == sched.prefix.pinned_pages
        assert sched.prefix.host_pages == sched.host_store.pages
        if wave % 2 == 0:
            sched.prefix.evict_lru(eng.num_pages)
            assert sched.prefix.host_pages == sched.host_store.pages
    tel = sched.telemetry
    return dict(outs=[outs[u] for u in sorted(outs)],
                swap=(int(tel.swap_in_pages.total()),
                      int(tel.swap_out_pages.total()),
                      int(tel.prefix_host_hits.total())),
                free=sched.alloc.free_pages)


def test_scheduler_churn_waves_conserve_as_jax():
    eng = _port_engine(host_tier_bytes=1 << 20)
    got = _churn(eng, _sched(eng))
    jeng = _jax_engine(host_tier_bytes=1 << 20)
    assert got == _churn(jeng, _jax_sched(jeng))
    assert len(got["outs"]) == 12 and got["swap"][0] > 0


def test_warm_swap_churn_guard_books():
    """``tests/L1/test_host_tier_guard.py``'s churn (its compile count
    has no counterpart: nothing is compiled): two full round trips of
    evict -> swap-out -> hit -> swap-in, the tokens a cold run's, the
    counters and books as the guard holds them."""
    eng = _port_engine(host_tier_bytes=1 << 20)
    sched = _sched(eng)
    prefix = PREFIX16

    def wave(prompts):
        for p in prompts:
            sched.submit(p, max_new_tokens=3)
        return sched.run()

    wave([prefix + [1, 2]])
    assert sched.prefix.evict_lru(eng.num_pages) > 0
    wave([prefix + [1, 2]])
    sched.prefix.evict_lru(eng.num_pages)
    out1 = wave([prefix + [1, 2], prefix + [9]])
    sched.prefix.evict_lru(eng.num_pages)
    out2 = wave([prefix + [1, 2]])
    cold = _cold(eng, prefix + [1, 2], 3)
    assert list(out2.values()) == [cold] and cold in out1.values()
    tel = sched.telemetry
    assert int(tel.swap_in_pages.total()) >= 4
    assert int(tel.swap_out_pages.total()) >= 4
    assert int(tel.prefix_host_hits.total()) >= 3
    _books(sched)


def test_scheduler_drains_pending_swaps_at_the_wave_boundary():
    """The offload is deferred: eviction leaves pending drains and
    placeholders; the wave boundary (or a hit) resolves them."""
    eng = _port_engine(host_tier_bytes=1 << 20)
    sched = _sched(eng)
    sched.submit(PREFIX16 + [1, 2], max_new_tokens=3)
    sched.run()
    assert sched._pending_swaps == []
    assert sched.prefix.evict_lru(eng.num_pages) > 0
    assert len(sched._pending_swaps) >= 1
    assert any(isinstance(s, _DeferredSlab)
               for s in sched.host_store._slabs.values())
    assert sched.drain_pending_swaps() >= 1
    assert sched.drain_pending_swaps() == 0
    sched.submit(PREFIX16 + [9], max_new_tokens=3)
    out = sched.run()
    assert all(len(v) == 3 for v in out.values())
    assert int(sched.telemetry.prefix_host_hits.total()) == 1
    _books(sched)
    # a hit before any drain resolves the placeholders lazily
    sched.prefix.evict_lru(eng.num_pages)
    sched.submit(PREFIX16 + [9], max_new_tokens=3)
    sched.run()
    assert sched._pending_swaps == []
    assert int(sched.telemetry.prefix_host_hits.total()) == 2
    _books(sched)


# -- tp = 2: spawned gloo ranks ----------------------------------------------

def _rank_main(rank, tp, store_path, out_path):
    """One spawned rank: the filled pool's swap-out slabs, the
    hit-after-eviction run and the churn, into ``out_path.<rank>``."""
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store_path, tp), rank=rank,
        world_size=tp, timeout=datetime.timedelta(seconds=120))
    try:
        out = {}
        eng = _port_engine(tp=tp, host_tier_bytes=1 << 20,
                           swap_batch_pages=2)
        cache = eng.init_cache()
        _fill(eng, cache)
        out["slabs"] = eng.swap_out_pages(cache, [3, 0, 7, 1, 12])
        out["page_host_bytes"] = eng.page_host_bytes()
        eng = _port_engine(tp=tp, host_tier_bytes=1 << 20)
        out["hit"] = _hit_after_eviction(eng, _sched(eng))
        eng = _port_engine(tp=tp, host_tier_bytes=1 << 20)
        out["churn"] = _churn(eng, _sched(eng))
        out["launches"] = sum(_build.launch_counts().values())
    finally:
        dist.destroy_process_group()
    torch.save(out, f"{out_path}.{rank}")


@pytest.fixture(scope="module")
def tp2_ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("tier_tp2")
    mp.start_processes(_rank_main, nprocs=2, start_method="spawn",
                       args=(2, str(d / "store"), str(d / "out")))
    return [torch.load(f"{d / 'out'}.{r}", weights_only=False)
            for r in range(2)]


def test_tp2_rank_slabs_are_jax_tp2_slab(tp2_ranks):
    """Each rank moves its own kv-head shard, with no collective; the
    two ranks' slabs side by side on the kv-head axis, in rank order,
    are JAX's tp = 2 slab bit for bit, and both ranks book JAX's whole
    page in ``page_host_bytes``."""
    jeng = _jax_engine(tp=2, host_tier_bytes=1 << 20, swap_batch_pages=2)
    jk, jv = jeng.swap_out_pages(_jax_filled(jeng), [3, 0, 7, 1, 12])
    for r in tp2_ranks:
        assert r["slabs"][0].shape == (5, 1, 1, 8, 16)
        assert r["page_host_bytes"] == jeng.page_host_bytes()
    for i, want in enumerate((jk, jv)):
        got = np.concatenate([r["slabs"][i] for r in tp2_ranks], axis=2)
        assert np.array_equal(got, np.asarray(want))


def test_tp2_hit_after_eviction_and_churn_as_jax(tp2_ranks):
    """The tp = 2 ranks serve the hit after eviction and the churn as
    the single rank and JAX's tp = 2 engine do: the same tokens, the same
    swap counters and books on both ranks."""
    one = _port_engine(host_tier_bytes=1 << 20)
    hit_one = _hit_after_eviction(one, _sched(one))
    jeng = _jax_engine(tp=2, host_tier_bytes=1 << 20)
    hit_jax = _hit_after_eviction(jeng, _jax_sched(jeng))
    jeng = _jax_engine(tp=2, host_tier_bytes=1 << 20)
    churn_jax = _churn(jeng, _jax_sched(jeng))
    for r in tp2_ranks:
        assert r["hit"] == hit_one == hit_jax
        assert r["churn"] == churn_jax
        assert r["launches"] == 0
