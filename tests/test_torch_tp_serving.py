"""Tensor-parallel serving on the port against the JAX package (CPU).

The port's counterparts of ``tests/L0/run_inference/test_tp_serving.py``.
The JAX side runs in this process on the 8 host devices that
``tests/conftest.py`` pins; the port's ranks run one process a rank,
spawned, over gloo with ``device="cpu"`` (a ``FileStore`` under the
test's ``tmp_path``, so parallel workers never share a port).  The
spawned ranks import this module, torch and the port only: every JAX
import sits inside a JAX-side helper.  One spawn a width serves every
case of that width (the ``port_runs`` fixture), on seeded numpy weights
both packages take (:func:`_np_tree`).

Each serve is JAX's ``_serve``: prefill slot 0, four decode steps with a
half-active batch and, with ``spec_k``, one verify slab, on fp32 weights
and an fp32 pool.  The port's tp = N is held against JAX's tp = N and
against the port's tp = 1: the same tokens, prefill logits within 1e-4
(JAX's ``_assert_parity``), the same ``n_emit``; every rank's tokens are
identical.  In process: ``tp_dims``, ``expand_kv_for_tp``,
``param_partition_specs``, ``fused_partition_specs`` and
``shard_tree`` against JAX's specs on the same numpy tree; the fused
block's rank-partial plain version against JAX's ``fused_block_decode(
partial_out=True)`` (Pallas in interpret mode), and the ranks' partials
summed, plus ``x`` (and ``bo``), against JAX's attention-only block;
the engine's contract (paged, generative, its group).
"""
import datetime

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from apex_tpu_torch.inference import (InferenceEngine, SamplingConfig,
                                      SlotScheduler, params_from_jax)
from apex_tpu_torch.inference import models as tmodels
from apex_tpu_torch.inference.weights import (gpt_param_shapes,
                                              llama_param_shapes)
from apex_tpu_torch.ops import _build
from apex_tpu_torch.ops import paged_attention as tpa
from apex_tpu_torch.transformer.testing import GPTConfig, LlamaConfig

from _torch_isolation import restore_torch_from_amp  # noqa: F401

#: JAX's ``_gpt`` / ``_llama`` configurations
GPT_SMALL = dict(vocab_size=64, hidden_size=32, num_layers=1,
                 num_attention_heads=2, max_seq_length=64,
                 hidden_dropout=0.0, attention_dropout=0.0)
GPT = dict(vocab_size=128, hidden_size=64, num_layers=2,
           num_attention_heads=4, max_seq_length=128, hidden_dropout=0.0,
           attention_dropout=0.0)


def _llama_cfg(kvh, heads=4):
    return dict(vocab_size=128, hidden_size=64, num_layers=2,
                num_attention_heads=heads, num_kv_heads=kvh,
                max_seq_length=128)


#: the serves of the parity tests: name -> (kind, config, fusion, spec_k)
CASES = {"gpt_small": ("gpt", GPT_SMALL, "0", 0),
         "gpt_f0": ("gpt", GPT, "0", 0), "gpt_f1": ("gpt", GPT, "1", 0),
         "llama_kvh4": ("llama", _llama_cfg(4), "0", 0),
         "llama_kvh2": ("llama", _llama_cfg(2), "0", 0),
         "llama_kvh1": ("llama", _llama_cfg(1), "0", 0),
         "gpt_spec": ("gpt", GPT, "0", 2),
         "llama_spec": ("llama", _llama_cfg(2), "0", 2)}
#: the cases each width serves (JAX's test matrix)
WIDTH_CASES = {2: list(CASES), 4: ["gpt_f0", "gpt_f1", "llama_kvh4",
                                   "llama_kvh2", "llama_kvh1"]}
ENGINE = dict(slots=2, paged=True, page_size=16, num_pages=12,
              sampling=SamplingConfig())
#: the churn's shared prefix (two full pages) and its two-request burst
PREFIX = list(range(1, 33))
BURST = [PREFIX + [40 + i, 50 + i] for i in range(2)]
TOL = 1e-4


def _np_tree(kind, cfg_kw, seed=0):
    """A seeded numpy tree with the model's key paths (the bare tree):
    linears N(0, 1/fan_in), biases N(0, 0.02^2), norms 1 + N(0, 0.1^2),
    embeddings N(0, 1) (GPT's position table N(0, 0.1^2)), so the
    logits have clear top-2 margins."""
    cfg = (GPTConfig if kind == "gpt" else LlamaConfig)(**cfg_kw)
    shapes = (gpt_param_shapes if kind == "gpt" else llama_param_shapes)(cfg)
    rng = np.random.RandomState(seed)
    tree: dict = {}
    for path, shape in sorted(shapes.items()):
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


# -- the JAX side (JAX imported here only) -----------------------------------

def _jax_cfg(kind, cfg_kw):
    from apex_tpu.transformer import parallel_state
    from apex_tpu.transformer.testing import (GPTConfig as JGPTConfig,
                                              LlamaConfig as JLlamaConfig)
    parallel_state.destroy_model_parallel()
    parallel_state.initialize_model_parallel(1)
    return (JGPTConfig if kind == "gpt" else JLlamaConfig)(**cfg_kw)


def _jax_serve(name, tp):
    """JAX's ``_serve`` at ``tp`` on an fp32 pool."""
    import jax.numpy as jnp
    from apex_tpu.inference import InferenceEngine as JaxEngine
    from apex_tpu.inference.sampling import SamplingConfig as JSampling
    kind, cfg_kw, fusion, spec_k = CASES[name]
    cfg, tree = _jax_cfg(kind, cfg_kw), _np_tree(kind, cfg_kw)
    kw = dict(ENGINE, sampling=JSampling())
    eng = JaxEngine(kind, cfg, tree, cache_dtype=jnp.float32, spec_k=spec_k,
                    decode_fusion=fusion, tp=tp, **kw)
    out = _serve(eng, spec_k, lambda t: np.asarray(t))
    out["cache_hbm_bytes"] = eng.cache_hbm_bytes()
    return out


def _jax_specs(kind, cfg_kw, tp):
    """JAX's kv-expanded tree, its spec tree as shard dims, and its fused
    layout with its fused specs as dims."""
    import jax
    from apex_tpu.inference import models as jmodels
    cfg, tree = _jax_cfg(kind, cfg_kw), _np_tree(kind, cfg_kw)
    full = jmodels.expand_kv_for_tp(kind, cfg, tree, tp)
    specs = jmodels.param_partition_specs(kind, cfg, full, tp)
    fused = jmodels.fused_layer_params(kind, cfg, full)
    fspecs = jmodels.fused_partition_specs(fused, tp)
    to_np = (lambda t: jax.tree_util.tree_map(np.asarray, t))
    return (cfg, tree, to_np(full), _dims_of(specs), to_np(fused),
            [_dims_of(s) for s in fspecs])


def _dims_of(specs):
    """A PartitionSpec tree as the port's shard dims: the index of the
    sharded axis, or None."""
    from jax.sharding import PartitionSpec
    if isinstance(specs, dict):
        return {k: _dims_of(v) for k, v in specs.items()}
    assert isinstance(specs, PartitionSpec)
    axes = [i for i, a in enumerate(specs) if a is not None]
    return axes[0] if axes else None


# -- the port side (spawned ranks and the in-process tp = 1) -----------------

def _serve(eng, spec_k, to_np):
    """Prefill slot 0, decode 4 steps with a half-active batch, verify one
    slab (``spec_k``): JAX's ``_serve``, on either package's engine."""
    cache = eng.init_cache()
    pages = eng.new_allocator().acquire(4)
    cache, tok, logits = eng.prefill(cache, list(range(1, 11)), 0,
                                     pages=pages)
    toks = [int(tok)]
    last = np.array([int(tok), 0], np.int32)
    active = np.array([True, False])
    for _ in range(4):
        cache, nt, _, _ = eng.decode(cache, last, active)
        toks.append(int(to_np(nt)[0]))
        last = np.asarray(to_np(nt), np.int32)
    spec = None
    if spec_k:
        slab = np.zeros((2, spec_k + 1), np.int32)
        slab[0, 0] = toks[-1]
        cache, vt, n_emit, _ = eng.verify(cache, slab, active)
        spec = (to_np(vt)[0].tolist(), int(to_np(n_emit)[0]))
    return dict(toks=toks, logits=np.asarray(to_np(logits), np.float32),
                spec=spec)


def _port_engine(kind, cfg_kw, tree, tp, **kw):
    cfg = (GPTConfig if kind == "gpt" else LlamaConfig)(**cfg_kw)
    params = params_from_jax(kind, cfg, tree, device="cpu")
    return InferenceEngine(kind, cfg, params, cache_dtype=torch.float32,
                           device="cpu", tp=tp, **dict(ENGINE, **kw))


def _port_serve(name, tree, tp):
    kind, cfg_kw, fusion, spec_k = CASES[name]
    eng = _port_engine(kind, cfg_kw, tree, tp, spec_k=spec_k,
                       decode_fusion=fusion)
    out = _serve(eng, spec_k, lambda t: t.detach().cpu().numpy())
    cache = eng.init_cache()
    out.update(cache_hbm_bytes=eng.cache_hbm_bytes(),
               pool_shape=tuple(cache.k.shape),
               kv_heads_pool=eng.tp_dims["kv_heads_pool"],
               param_bytes=sum(t.numel() * t.element_size() for t in
                               _leaves(eng.params)),
               launches=sum(_build.launch_counts().values()))
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    return [tree]


def _churn(eng, registry_cls, telemetry_cls, sched_cls):
    """JAX's churn without its compile count: a seeding wave of the
    burst's first prompt, then the burst, which hits the two-page prefix
    (one copy-on-write for the unaligned boundary); the scheduler's
    prefix and COW books and the allocator's conservation law."""
    tel = telemetry_cls(registry_cls())
    sched = sched_cls(eng, telemetry=tel)
    sched.submit(list(BURST[0]), max_new_tokens=2)
    sched.run()
    for p in BURST:
        sched.submit(list(p), max_new_tokens=2)
    outs = sched.run()
    s = tel.summary()
    alloc = sched.alloc
    assert alloc.free_pages + alloc.live_pages == eng.num_pages
    return dict(books=(s.get("prefix_hit_tokens", 0),
                       int(tel.prefix_hits.total()), s.get("cow_copies", 0),
                       alloc.free_pages),
                outs=sorted(map(tuple, outs.values())))


def _port_churn(tree, tp):
    from apex_tpu_torch.observability import MetricsRegistry, ServeTelemetry
    eng = _port_engine("gpt", GPT, tree, tp)
    return _churn(eng, MetricsRegistry, ServeTelemetry, SlotScheduler)


def _rank_main(rank, tp, store_path, trees, out_path):
    """One spawned rank: every serve of its width, then the churn (at tp
    = 2), into ``out_path.<rank>``."""
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store_path, tp), rank=rank,
        world_size=tp, timeout=datetime.timedelta(seconds=120))
    try:
        out = {name: _port_serve(name, trees[name], tp)
               for name in WIDTH_CASES[tp]}
        if tp == 2:
            out["churn"] = _port_churn(trees["gpt_f0"], tp)
    finally:
        dist.destroy_process_group()
    torch.save(out, f"{out_path}.{rank}")


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    """``port_runs(tp)``: every case of width ``tp`` served by ``tp``
    spawned ranks, once per module, as ``[rank] -> {case: result}``."""
    runs = {}

    def get(tp):
        if tp not in runs:
            d = tmp_path_factory.mktemp(f"tp{tp}")
            trees = {name: _np_tree(kind, cfg_kw)
                     for name, (kind, cfg_kw, _, _) in CASES.items()}
            mp.start_processes(_rank_main, nprocs=tp, start_method="spawn",
                               args=(tp, str(d / "store"), trees,
                                     str(d / "out")))
            runs[tp] = [torch.load(f"{d / 'out'}.{r}", weights_only=False)
                        for r in range(tp)]
        return runs[tp]
    return get


def _port_tp1(name):
    kind, cfg_kw, _, _ = CASES[name]
    return _port_serve(name, _np_tree(kind, cfg_kw), 1)


def _assert_parity(base, got, tol=TOL):
    assert base["toks"] == got["toks"], (base["toks"], got["toks"])
    assert base["spec"] == got["spec"], (base["spec"], got["spec"])
    assert float(np.max(np.abs(base["logits"] - got["logits"]))) < tol


def _assert_case(name, tp, port_runs):
    """The port's tp = N ranks against JAX's tp = N and the port's tp =
    1; every rank the same tokens; a CPU serve launches no kernel.
    Returns the ranks', JAX's and the port's tp = 1 results."""
    ranks = [r[name] for r in port_runs(tp)]
    for r in ranks[1:]:
        assert r["toks"] == ranks[0]["toks"] and r["spec"] == ranks[0]["spec"]
        assert np.array_equal(r["logits"], ranks[0]["logits"])
    jax_n, one = _jax_serve(name, tp), _port_tp1(name)
    _assert_parity(jax_n, ranks[0])
    _assert_parity(one, ranks[0])
    assert all(r["launches"] == 0 for r in ranks)
    return ranks, jax_n, one


# -- parity: the port's ranks against JAX and the port's single rank --------

def test_gpt_tp2_parity_and_per_rank_hbm_fast(port_runs):
    """GPT paged tp = 2 serves the same tokens (and prefill logits) as
    JAX's tp = 2 and the port's single rank; each rank's pool holds half
    the kv heads (JAX's per-rank bytes), and its weights plus pool fit
    well under 3/4 of the single rank's."""
    ranks, jax_two, one = _assert_case("gpt_small", 2, port_runs)
    for r in ranks:
        assert r["cache_hbm_bytes"] * 2 == one["cache_hbm_bytes"]
        assert r["cache_hbm_bytes"] == jax_two["cache_hbm_bytes"]
        assert r["pool_shape"][2] == r["kv_heads_pool"] // 2
        assert r["param_bytes"] + r["cache_hbm_bytes"] < 0.75 * (
            one["param_bytes"] + one["cache_hbm_bytes"])


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("fusion", ["0", "1"])
def test_gpt_tp_matrix(tp, fusion, port_runs):
    """GPT paged, per-op and fused decode (the rank-partial block, the
    all_reduce and the MLP outside it), at tp 2 and 4."""
    _assert_case(f"gpt_f{fusion}", tp, port_runs)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("kvh", [4, 2, 1])
def test_llama_kv_replication_tp_matrix(kvh, tp, port_runs):
    """LLaMA MHA/GQA/MQA under tp: kv heads shard where tp divides them
    and replicate below tp (tp 4 over 2 kv heads carries each twice; MQA
    replicates its one head tp ways)."""
    ranks = _assert_case(f"llama_kvh{kvh}", tp, port_runs)[0]
    want = kvh * max(tp // kvh, 1)
    assert all(r["kv_heads_pool"] == want
               and r["pool_shape"][2] == want // tp for r in ranks)


@pytest.mark.parametrize("kind", ["gpt", "llama"])
def test_spec_verify_tp2_parity(kind, port_runs):
    """The verify slab scores alike on the ranks: the same tokens and
    n_emit."""
    ranks = _assert_case(f"{kind}_spec", 2, port_runs)[0]
    assert ranks[0]["spec"] is not None


def test_allocator_prefix_churn_invariant_under_tp(port_runs):
    """The page table, allocator, prefix cache and COW are host-side and
    the same on every rank: a shared-prefix burst on the tp = 2 ranks
    keeps the single rank's and JAX's tp = 2 hit, COW and free-page
    books and the conservation law, and serves the same tokens."""
    from apex_tpu.inference import InferenceEngine as JaxEngine
    from apex_tpu.inference import SlotScheduler as JaxScheduler
    from apex_tpu.inference.sampling import SamplingConfig as JSampling
    from apex_tpu.observability import (MetricsRegistry as JRegistry,
                                        ServeTelemetry as JTelemetry)
    import jax.numpy as jnp
    ranks = [r["churn"] for r in port_runs(2)]
    one = _port_churn(_np_tree("gpt", GPT), 1)
    jeng = JaxEngine("gpt", _jax_cfg("gpt", GPT), _np_tree("gpt", GPT),
                     cache_dtype=jnp.float32, tp=2,
                     **dict(ENGINE, sampling=JSampling()))
    jax_two = _churn(jeng, JRegistry, JTelemetry, JaxScheduler)
    assert one["books"][0] > 0 and one["books"][2] > 0   # hits and a COW
    for r in ranks:
        assert r == ranks[0]
        assert r["books"] == one["books"] == jax_two["books"]
        assert r["outs"] == one["outs"]


# -- the engine's contract --------------------------------------------------

def test_tp_requires_paged_generative():
    """JAX's ValueErrors, raised before any process group is asked for:
    the dense cache, tp 0, a tp that splits a head; BERT at tp 2."""
    cfg = GPTConfig(**GPT)
    params = params_from_jax("gpt", cfg, _np_tree("gpt", GPT),
                             device="cpu")
    with pytest.raises(ValueError, match="PAGED"):
        InferenceEngine("gpt", cfg, params, slots=2, max_seq=64, tp=2,
                        device="cpu")
    kw = dict(slots=2, paged=True, page_size=16, num_pages=8, device="cpu")
    with pytest.raises(ValueError):
        InferenceEngine("gpt", cfg, params, tp=0, **kw)
    with pytest.raises(ValueError, match="does not divide"):
        InferenceEngine("gpt", cfg, params, tp=3, **kw)
    with pytest.raises(ValueError, match="encode-only"):
        InferenceEngine("bert", cfg, params, tp=2, device="cpu")


def test_serve_tp_env_knob(monkeypatch):
    """APEX_TPU_SERVE_TP as JAX reads it: unset or 0 is 1, an explicit
    engine tp wins (no group is asked for), garbage raises."""
    from apex_tpu.inference.engine import serve_tp as jax_serve_tp
    from apex_tpu_torch.inference.engine import serve_tp
    monkeypatch.delenv("APEX_TPU_SERVE_TP", raising=False)
    assert serve_tp() == jax_serve_tp() == 1
    monkeypatch.setenv("APEX_TPU_SERVE_TP", "0")
    assert serve_tp() == jax_serve_tp() == 1
    monkeypatch.setenv("APEX_TPU_SERVE_TP", "2")
    assert serve_tp() == jax_serve_tp() == 2
    cfg = GPTConfig(**GPT_SMALL)
    params = params_from_jax("gpt", cfg, _np_tree("gpt", GPT_SMALL),
                             device="cpu")
    eng = InferenceEngine("gpt", cfg, params, slots=1, paged=True,
                          page_size=16, num_pages=4, tp=1, device="cpu")
    assert eng.tp == 1 and eng.group is None and eng.rank == 0
    for bad in ("banana", "-2"):
        monkeypatch.setenv("APEX_TPU_SERVE_TP", bad)
        for fn in (serve_tp, jax_serve_tp):
            with pytest.raises(ValueError, match="APEX_TPU_SERVE_TP"):
                fn()


@pytest.fixture
def world_of_one(tmp_path):
    """An initialised gloo world of one rank, torn down after the test."""
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_a_group_whose_size_is_not_tp_raises(world_of_one):
    """With torch.distributed up, a tp = 2 engine on the world group of
    one rank raises, as does asking for a serving group wider than the
    world; tp = 1 takes no group."""
    from apex_tpu_torch.transformer.parallel_state import serving_group
    cfg = GPTConfig(**GPT_SMALL)
    params = params_from_jax("gpt", cfg, _np_tree("gpt", GPT_SMALL),
                             device="cpu")
    kw = dict(slots=1, paged=True, page_size=16, num_pages=4, device="cpu")
    with pytest.raises(RuntimeError, match="process group of 2 ranks"):
        InferenceEngine("gpt", cfg, params, tp=2, **kw)
    with pytest.raises(RuntimeError, match="process group of 2 ranks"):
        InferenceEngine("gpt", cfg, params, tp=2, group=dist.group.WORLD,
                        **kw)
    with pytest.raises(RuntimeError, match="needs 2 ranks"):
        serving_group(2)
    assert serving_group(1) is dist.group.WORLD
    assert InferenceEngine("gpt", cfg, params, tp=1, **kw).group is None


# -- the shard helpers against JAX's specs ----------------------------------

@pytest.mark.parametrize("kind,cfg_kw,tp", [
    ("gpt", GPT, 2), ("gpt", GPT, 4), ("llama", _llama_cfg(4), 2),
    ("llama", _llama_cfg(2), 4), ("llama", _llama_cfg(1), 4),
    ("llama", _llama_cfg(1, heads=8), 2)])
def test_shards_match_the_jax_specs(kind, cfg_kw, tp):
    """``tp_dims``, ``expand_kv_for_tp``, ``param_partition_specs``,
    ``fused_partition_specs`` and every rank's ``shard_tree`` against
    JAX's on the same numpy tree; the ranks' shards reassemble the
    expanded tree."""
    from apex_tpu.inference import models as jmodels
    jcfg, tree, jfull, jdims, jfused, jfdims = _jax_specs(kind, cfg_kw, tp)
    cfg = (GPTConfig if kind == "gpt" else LlamaConfig)(**cfg_kw)
    assert tmodels.tp_dims(kind, cfg, tp) == jmodels.tp_dims(kind, jcfg, tp)
    params = params_from_jax(kind, cfg, tree, device="cpu")
    full = tmodels.expand_kv_for_tp(kind, cfg, params, tp)
    dims = tmodels.param_partition_specs(kind, cfg, full, tp)
    assert dims == jdims
    fused = tmodels.fused_layer_params(kind, cfg, full)
    fdims = tmodels.fused_partition_specs(fused, tp)
    assert fdims == jfdims

    def check(got, want, spec, rank):
        if isinstance(want, dict):
            assert sorted(got) == sorted(want)
            for k in want:
                check(got[k], want[k], spec[k], rank)
            return
        if spec is not None:
            want = np.split(np.asarray(want), tp, axis=spec)[rank]
        assert got.is_contiguous()
        np.testing.assert_array_equal(got.numpy(), want)

    for rank in range(tp):
        check(tmodels.shard_tree(full, dims, tp, rank), jfull, jdims, rank)
        for blk, jblk, spec in zip(fused, jfused, fdims):
            check(tmodels.shard_tree(blk, spec, tp, rank), jblk, spec, rank)
    assert tmodels.param_partition_specs(kind, cfg, full, 1) == \
        _map_none(jdims)


def _map_none(tree):
    return {k: _map_none(v) for k, v in tree.items()} \
        if isinstance(tree, dict) else None


def test_partition_specs_name_the_module_tp_does_not_divide():
    """A vocab that tp does not divide raises, naming the leaf, as in
    JAX."""
    cfg_kw = dict(GPT, vocab_size=130)
    cfg = GPTConfig(**cfg_kw)
    params = params_from_jax("gpt", cfg, _np_tree("gpt", cfg_kw),
                             device="cpu")
    with pytest.raises(ValueError, match="word_embeddings"):
        tmodels.param_partition_specs("gpt", cfg, params, 4)


# -- the fused block's rank-partial instance (V6) ---------------------------

HIDDEN, D, PS, MPPS = 64, 16, 8, 4
LENGTHS = [0, 5, 8, 23]


def _fused_case(kind, kvh, heads, seed):
    """A random fused-layout layer (every vector fp32), one layer of a
    2-layer pool, its page table and RoPE rows, all numpy."""
    rng = np.random.RandomState(seed)
    slots = len(LENGTHS)

    def lin(i, o):
        return (rng.randn(i, o) / np.sqrt(i)).astype(np.float32)

    def vec(n, base=0.0):
        return (base + 0.1 * rng.randn(1, n)).astype(np.float32)

    blk = {"ln1_w": vec(HIDDEN, 1.0), "wq": lin(HIDDEN, heads * D),
           "wk": lin(HIDDEN, kvh * D), "wv": lin(HIDDEN, kvh * D),
           "wo": lin(heads * D, HIDDEN)}
    if kind == "gpt":
        blk.update(ln1_b=vec(HIDDEN), bq=vec(heads * D), bk=vec(kvh * D),
                   bv=vec(kvh * D), bo=vec(HIDDEN))
    n_pages = slots * MPPS
    pool_k = rng.randn(n_pages + 1, 2, kvh, PS, D).astype(np.float32)
    pool_v = rng.randn(n_pages + 1, 2, kvh, PS, D).astype(np.float32)
    perm = rng.permutation(n_pages)
    table = np.full((slots, MPPS), n_pages, np.int32)
    cursor = 0
    for s, n in enumerate(LENGTHS):
        need = -(-n // PS)
        table[s, :need] = perm[cursor:cursor + need]
        cursor += need
    x = rng.randn(slots, HIDDEN).astype(np.float32)
    pos = np.asarray(LENGTHS)
    ang = pos[:, None] / 10000.0 ** (np.arange(0, D, 2) / D)[None]
    cos = np.concatenate([np.cos(ang)] * 2, axis=1).astype(np.float32)
    sin = np.concatenate([np.sin(ang)] * 2, axis=1).astype(np.float32)
    return x, blk, pool_k[:, 1], pool_v[:, 1], table, \
        np.asarray(LENGTHS, np.int32), cos, sin


def _jax_block(kind, x, blk, pk, pv, table, lengths, cos, sin, **kw):
    import jax.numpy as jnp
    from apex_tpu.ops import paged_attention as jpa
    rope = {} if kind == "gpt" else dict(cos=jnp.asarray(cos),
                                         sin=jnp.asarray(sin))
    out = jpa.fused_block_decode(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in blk.items()},
        jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(table),
        jnp.asarray(lengths), kind=kind, eps=1e-5, fuse_mlp=False, **rope,
        **kw)
    return [np.asarray(t) for t in out]


def _port_block(kind, x, blk, pk, pv, table, lengths, cos, sin, **kw):
    rope = {} if kind == "gpt" else dict(cos=torch.from_numpy(cos),
                                         sin=torch.from_numpy(sin))
    out = tpa.fused_block_decode(
        torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in blk.items()},
        torch.from_numpy(pk), torch.from_numpy(pv), torch.from_numpy(table),
        torch.from_numpy(lengths), kind=kind, eps=1e-5, fuse_mlp=False,
        **rope, **kw)
    return [t.numpy() for t in out]


@pytest.mark.parametrize("kind,kvh", [("llama", 2), ("llama", 1),
                                      ("gpt", 4)])
def test_partial_out_plain_matches_jax(kind, kvh):
    """The port's rank-partial block (its plain version, on the CPU)
    against JAX's ``fused_block_decode(partial_out=True)`` (the Pallas
    kernel in interpret mode) on one rank's shard: wq [64, 32] and wo
    [32, 64] at 2 of 4 heads, lengths 0, 5, 8 and 23; fp32 within 1e-5
    (the same math, sums in another order)."""
    heads = 2
    case = _fused_case(kind, kvh if kind == "llama" else heads, heads,
                       seed=kvh)
    got = _port_block(kind, *case, partial_out=True)
    want = _jax_block(kind, *case, partial_out=True)
    for name, g, w in zip(("partial", "k_tok", "v_tok"), got, want):
        np.testing.assert_allclose(g, w.reshape(g.shape), rtol=0, atol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("kind", ["llama", "gpt"])
def test_rank_partials_sum_to_the_attention_block(kind, tp):
    """Each rank's shard of a whole layer (heads over tp, its kv heads,
    wo's rows) through the port's rank-partial block: the partials
    summed, plus x (and bo once), are JAX's whole attention-only block
    within 1e-5."""
    heads, kvh = 4, (4 if kind == "gpt" else 2)
    x, blk, pk, pv, table, lengths, cos, sin = _fused_case(kind, kvh, heads,
                                                           seed=tp)
    want = _jax_block(kind, x, blk, pk, pv, table, lengths, cos, sin)[0]
    rep = max(tp // kvh, 1)
    pk_r, pv_r = (np.repeat(p, rep, axis=1) for p in (pk, pv))
    wk = np.repeat(blk["wk"].reshape(HIDDEN, kvh, D), rep, axis=1)
    wv = np.repeat(blk["wv"].reshape(HIDDEN, kvh, D), rep, axis=1)
    full = dict(blk, wk=wk.reshape(HIDDEN, -1), wv=wv.reshape(HIDDEN, -1))
    if kind == "gpt":
        for n in ("bk", "bv"):
            full[n] = np.repeat(blk[n].reshape(1, kvh, D), rep,
                                axis=1).reshape(1, -1)
    spec = tmodels.fused_partition_specs([full], tp)[0]
    total = x.copy() + (blk["bo"] if kind == "gpt" else 0)
    for rank in range(tp):
        shard = {k: np.split(v, tp, axis=spec[k])[rank]
                 if spec[k] is not None else v for k, v in full.items()}
        kv_slice = np.split(pk_r, tp, axis=1)[rank], \
            np.split(pv_r, tp, axis=1)[rank]
        total = total + _port_block(
            kind, x, {k: np.ascontiguousarray(v) for k, v in shard.items()},
            *(np.ascontiguousarray(t) for t in kv_slice), table, lengths,
            cos, sin, partial_out=True)[0]
    np.testing.assert_allclose(total, want, rtol=0, atol=1e-5)
