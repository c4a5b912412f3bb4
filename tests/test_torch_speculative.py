"""Speculative decoding and the pure step factories on the port, against
the JAX package (CPU, fp32).

Models: GPT (hidden 32, 2 heads of 16, vocab 64) and LLaMA with GQA
(hidden 32, 4 heads over 2 kv heads, vocab 64), 2 layers, max_seq 64;
the paged engines on pages of 8 (24 pages), the dense ones on the slot
cache.  The same seeded JAX ``model.init`` tree goes to both packages
(``params_from_jax``); every cache is fp32.  Tolerance for attention
outputs, logits and cache rows: 1e-4 absolute, as the serving tests
state it (fp32 on both sides; reduction orders differ: XLA against
PyTorch, and the port's paged decode plain version is a base-2 softmax
where the JAX gather chain is a natural one).  Greedy tokens, ``n_emit``,
``truncated`` and lengths must be equal.

Then the port counterparts of the JAX package's speculative tests
(``tests/L0/run_inference/test_speculative.py``): the spec stream is
the plain greedy stream whatever the drafter, rejection is a length
rollback, slab rows past the window never land on live rows, and the
drafters keep their contracts.
"""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.inference import InferenceEngine as JaxEngine
from apex_tpu.inference import engine as jengine
from apex_tpu.inference import kv_cache as jkv
from apex_tpu.inference import models as jmodels
from apex_tpu.inference.sampling import SamplingConfig as JaxSampling
from apex_tpu.ops import attention as jattn
from apex_tpu.ops import paged_attention as jpa
from apex_tpu.transformer import parallel_state
from apex_tpu.transformer.testing import GPTConfig as JaxGPTConfig
from apex_tpu.transformer.testing import LlamaConfig as JaxLlamaConfig
from apex_tpu.transformer.testing import gpt_model_provider as jax_gpt
from apex_tpu.transformer.testing import llama_model_provider as jax_llama
from apex_tpu_torch.inference import (EngineDrafter, InferenceEngine,
                                      NGramDrafter, ReplayDrafter,
                                      SlotScheduler, kv_cache,
                                      make_decode_fn, make_prefill_fn,
                                      make_verify_fn, params_from_jax)
from apex_tpu_torch.inference import models as tmodels
from apex_tpu_torch.inference.sampling import SamplingConfig
from apex_tpu_torch.observability import MetricsRegistry, ServeTelemetry
from apex_tpu_torch.ops import _build
from apex_tpu_torch.ops import attention as tattn
from apex_tpu_torch.ops import paged_attention as tpa
from apex_tpu_torch.transformer.testing import GPTConfig, LlamaConfig

from _torch_isolation import restore_torch_from_amp  # noqa: F401

ATOL = 1e-4
VOCAB, MAX_SEQ = 64, 64
GPT_CFG = dict(vocab_size=VOCAB, hidden_size=32, num_layers=2,
               num_attention_heads=2, max_seq_length=MAX_SEQ,
               hidden_dropout=0.0, attention_dropout=0.0)
LLAMA_CFG = dict(vocab_size=VOCAB, hidden_size=32, num_layers=2,
                 num_attention_heads=4, num_kv_heads=2,
                 max_seq_length=MAX_SEQ)
PAGED = dict(page_size=8, num_pages=24)
K = 3


def _init(kind):
    parallel_state.destroy_model_parallel()
    parallel_state.initialize_model_parallel(1)
    if kind == "gpt":
        jcfg, cfg, provider = (JaxGPTConfig(**GPT_CFG), GPTConfig(**GPT_CFG),
                               jax_gpt)
    else:
        jcfg, cfg, provider = (JaxLlamaConfig(**LLAMA_CFG),
                               LlamaConfig(**LLAMA_CFG), jax_llama)
    jparams = provider(jcfg).init(jax.random.PRNGKey(0),
                                  jnp.zeros((1, 4), jnp.int32))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return dict(kind=kind, jcfg=jcfg, jparams=jparams, cfg=cfg,
                tparams=params_from_jax(kind, cfg, tree, device="cpu"))


@pytest.fixture(scope="module")
def models():
    return {kind: _init(kind) for kind in ("gpt", "llama")}


def _geometry(paged):
    return dict(slots=2, max_seq=MAX_SEQ, **(PAGED if paged else {}))


def _port(m, paged, **kw):
    return InferenceEngine(m["kind"], m["cfg"], m["tparams"],
                           cache_dtype=torch.float32, device="cpu",
                           **_geometry(paged), **kw)


def _jax(m, paged, **kw):
    parallel_state.destroy_model_parallel()
    parallel_state.initialize_model_parallel(1)
    return JaxEngine(m["kind"], m["jcfg"], m["jparams"],
                     cache_dtype=jnp.float32, **_geometry(paged), **kw)


def _prompts(seed, lens):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, VOCAB, size=n).tolist() for n in lens]


def _same_cache(j, t, paged):
    """Every row equal within ATOL; paged, apart from the trash page (the
    JAX append drops a slab row past the window, the port's writes it
    there), and the page table, lengths and capacities equal."""
    cut = slice(0, -1) if paged else slice(None)
    for name in ("k", "v"):
        np.testing.assert_allclose(getattr(t, name)[cut].numpy(),
                                   np.asarray(getattr(j, name))[cut],
                                   atol=ATOL, err_msg=name)
    names = ("lengths", "page_table", "capacity") if paged else ("lengths",)
    for name in names:
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)))


def _prefill_both(je, te, prompts, budgets):
    """Prefill each prompt into its slot on both engines (paged: a
    reservation of prompt + budget tokens); returns both caches and the
    first tokens."""
    jc, tc = je.init_cache(), te.init_cache()
    ja = je.new_allocator() if je.paged else None
    ta = te.new_allocator() if te.paged else None
    firsts = []
    for slot, (p, budget) in enumerate(zip(prompts, budgets)):
        jp = tp = None
        if je.paged:
            jp = ja.acquire(ja.pages_needed(len(p) + budget))
            tp = ta.acquire(ta.pages_needed(len(p) + budget))
            assert list(jp) == list(tp)
        jc, jt, _ = je.prefill(jc, p, slot, pages=jp)
        tc, tt, _ = te.prefill(tc, p, slot, pages=tp)
        assert int(tt) == int(np.asarray(jt))
        firsts.append(int(tt))
    return jc, tc, firsts


def _continuation(m, seq, n):
    """The greedy continuation of ``seq``, ``n`` tokens, from the port's
    full-forward prefill."""
    seq = list(seq)
    for _ in range(n):
        logits, _, _ = tmodels.prefill_forward(
            m["kind"], m["cfg"], m["tparams"], torch.tensor([seq]))
        seq.append(int(logits[-1, 0].argmax()))
    return seq[-n:]


# -- the attention functions -----------------------------------------------

def _slab_case(kvh, group, seed, w=24, d=8, sq=K + 1):
    rng = np.random.RandomState(seed)
    slots = 5
    q = rng.randn(slots, kvh * group, sq, d).astype(np.float32)
    wk = rng.randn(slots, kvh, w, d).astype(np.float32)
    wv = rng.randn(slots, kvh, w, d).astype(np.float32)
    # an empty slot, one mid-window, one whose slab crosses the window's
    # end, one at the last row, one at capacity (every row past it)
    lengths = np.asarray([0, 9, w - 2, w - 1, w], np.int32)
    return q, wk, wv, lengths


@pytest.mark.parametrize("kvh,group", [(4, 1), (2, 2), (1, 4)],
                         ids=["mha", "gqa", "mqa"])
def test_slab_decode_attention_matches_jax(kvh, group):
    q, wk, wv, lengths = _slab_case(kvh, group, kvh)
    want = np.asarray(jattn.slab_decode_attention(
        jnp.asarray(q), jnp.asarray(wk), jnp.asarray(wv),
        jnp.asarray(lengths)))
    got = tattn.slab_decode_attention(
        torch.from_numpy(q), torch.from_numpy(wk), torch.from_numpy(wv),
        torch.from_numpy(lengths))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    w = wk.shape[2]
    for slot, n in enumerate(lengths):
        past = [r for r in range(q.shape[2]) if n + r >= w]
        assert bool((got[slot, :, past] == 0).all())
    # S = 1 is decode_attention's plain chain on the slot's window + 1
    one = tattn.slab_decode_attention(
        torch.from_numpy(q[:, :, :1]), torch.from_numpy(wk),
        torch.from_numpy(wv), torch.from_numpy(lengths))
    dec = tattn.decode_attention(
        torch.from_numpy(q[:, :, :1]), torch.from_numpy(wk),
        torch.from_numpy(wv), torch.from_numpy(np.minimum(lengths + 1, w)),
        use_kernel=False)
    live = lengths < w
    np.testing.assert_allclose(one.numpy()[live], dec.numpy()[live],
                               atol=1e-6)


def _pool_case(seed, kvh=2, group=2, d=8, ps=8, mpps=4, sq=K + 1):
    """A pool of two layers (layer 1's strided view), each slot's pages
    in a random order, lengths 0, mid-window, across the window's end
    and at it."""
    rng = np.random.RandomState(seed)
    slots = 4
    n_pages = slots * mpps
    pool_k = rng.randn(n_pages + 1, 2, kvh, ps, d).astype(np.float32)
    pool_v = rng.randn(n_pages + 1, 2, kvh, ps, d).astype(np.float32)
    table = rng.permutation(n_pages).reshape(slots, mpps).astype(np.int32)
    lengths = np.asarray([0, 11, mpps * ps - 2, mpps * ps], np.int32)
    q = rng.randn(slots, kvh * group, sq, d).astype(np.float32)
    return q, pool_k, pool_v, table, lengths


def test_paged_slab_attention_matches_jax():
    q, pk, pv, table, lengths = _pool_case(3)
    want = np.asarray(jpa.paged_slab_attention(
        jnp.asarray(q), jnp.asarray(pk[:, 1]), jnp.asarray(pv[:, 1]),
        jnp.asarray(table), jnp.asarray(lengths)))
    tk, tv = torch.from_numpy(pk)[:, 1], torch.from_numpy(pv)[:, 1]
    before = _build.launch_counts()
    got = tpa.paged_slab_attention(torch.from_numpy(q), tk, tv,
                                   torch.from_numpy(table),
                                   torch.from_numpy(lengths))
    assert _build.launch_counts() == before        # the CPU launches nothing
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    assert bool((got[3] == 0).all())               # every row past the window


def test_slab_fold_is_the_same_function():
    """The CUDA route's fold (``slots * S`` virtual slots of a q_len-1
    decode, lengths computed on the device) through the paged decode
    kernel's plain version gives the plain slab function: the rows past
    the window get length 0 and emit 0."""
    q, pk, pv, table, lengths = _pool_case(4, group=4, d=16, ps=16, mpps=3)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, pk[:, 1], pv[:, 1]))
    tt, tl = torch.from_numpy(table), torch.from_numpy(lengths)
    slots, h, sq, d = q.shape
    q3, fold_table, live = tpa._slab_fold(tq, tt, tl, 3 * 16)
    w = 3 * 16
    want_live = [[(n + r + 1) if n + r < w else 0 for r in range(sq)]
                 for n in lengths]
    assert live.tolist() == sum(want_live, [])
    assert live.dtype == torch.int32 and fold_table.dtype == torch.int32
    assert torch.equal(fold_table, tt.repeat_interleave(sq, dim=0))
    out = tpa.paged_decode_reference(q3, tk, tv, fold_table, live, d ** -0.5)
    got = out.reshape(slots, sq, h, d).transpose(1, 2)
    ref = tpa.paged_slab_reference(tq, tk, tv, tt, tl, d ** -0.5)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5)


# -- the cache updates -----------------------------------------------------

def _cache_pair(paged):
    if paged:
        j = jkv.init_paged_cache(10, 2, 2, 4, 3, slots=3,
                                 max_pages_per_slot=3)
        t = kv_cache.init_paged_cache(10, 2, 2, 4, 3, slots=3,
                                      max_pages_per_slot=3,
                                      dtype=torch.float32, device="cpu")
        table = np.asarray([[4, 7, 1], [0, 2, 10], [9, 10, 10]], np.int32)
        cap = np.asarray([12, 8, 4], np.int32)
        j = j.replace(page_table=jnp.asarray(table), capacity=jnp.asarray(cap))
        t.page_table.copy_(torch.from_numpy(table))
        t.capacity.copy_(torch.from_numpy(cap))
    else:
        j = jkv.init_cache(3, 2, 2, 12, 3)
        t = kv_cache.init_cache(3, 2, 2, 12, 3, dtype=torch.float32,
                                device="cpu")
    rng = np.random.RandomState(5)
    init = rng.randn(*t.k.shape).astype(np.float32)
    j = j.replace(k=jnp.asarray(init), v=jnp.asarray(-init))
    t.k.copy_(torch.from_numpy(init))
    t.v.copy_(torch.from_numpy(-init))
    return j, t


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_append_slab_and_advance_by_match_jax(paged):
    """Lengths mid-window, across the window's end and at it (paged:
    across a reservation's end too); every layer takes a slab, then the
    slots advance by per-slot counts: every live row, length, capacity
    and flag as in JAX."""
    j, t = _cache_pair(paged)
    lengths = np.asarray([10, 6, 3] if paged else [2, 10, 12], np.int32)
    j = jkv.set_lengths(j, lengths)
    t = kv_cache.set_lengths(t, lengths)
    rng = np.random.RandomState(6)
    for layer in range(2):
        ks, vs = (rng.randn(3, 2, K + 1, 3).astype(np.float32)
                  for _ in range(2))
        j = jkv.append_slab(j, layer, jnp.asarray(ks), jnp.asarray(vs))
        t = kv_cache.append_slab(t, layer, torch.from_numpy(ks),
                                 torch.from_numpy(vs))
    _same_cache(j, t, paged)
    for active, delta in (([True, True, False], [4, 1, 3]),
                          ([True, False, True], [2, 2, 4])):
        j, jtr = jkv.advance_by(j, np.asarray(active),
                                np.asarray(delta, np.int32))
        t, ttr = kv_cache.advance_by(t, np.asarray(active),
                                     np.asarray(delta, np.int32))
        assert ttr.tolist() == np.asarray(jtr).tolist()
        _same_cache(j, t, paged)


# -- the verify forward and step ---------------------------------------------

CASES = [("gpt", True), ("llama", True), ("gpt", False), ("llama", False)]
IDS = ["gpt-paged", "llama-paged", "gpt-dense", "llama-dense"]


def _verify_state(m, paged):
    """Both engines with slot 0 prefilled and slot 1 prefilled then set
    to its capacity (paged: a reservation of 2 pages; dense: max_seq),
    so every row of its slab is past what it owns."""
    je, te = _jax(m, paged, spec_k=K), _port(m, paged, spec_k=K)
    prompts = _prompts(7, [13, 10])
    jc, tc, firsts = _prefill_both(je, te, prompts, [16, 5])
    cap = 16 if paged else MAX_SEQ
    jc = jkv.set_lengths(jc, np.asarray([13, cap], np.int32))
    tc = kv_cache.set_lengths(tc, np.asarray([13, cap], np.int32))
    return je, te, jc, tc, prompts, firsts


@pytest.mark.parametrize("kind,paged", CASES, ids=IDS)
def test_verify_forward_matches_jax(models, kind, paged):
    m = models[kind]
    je, te, jc, tc, prompts, firsts = _verify_state(m, paged)
    slab = np.asarray(_prompts(8, [K + 1, K + 1]), np.int32)
    jl, jc = jmodels.verify_forward(kind, m["jcfg"], m["jparams"], jc,
                                    jnp.asarray(slab))
    tl, tc = tmodels.verify_forward(kind, m["cfg"], m["tparams"], tc,
                                    torch.from_numpy(slab))
    assert tuple(tl.shape) == (2, K + 1, VOCAB)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    _same_cache(jc, tc, paged)
    assert tc.lengths.tolist() == [13, 16 if paged else MAX_SEQ]


@pytest.mark.parametrize("kind,paged", CASES, ids=IDS)
def test_engine_verify_matches_jax(models, kind, paged):
    """Slot 0 drafts its true continuation (all accepted, n_emit k + 1);
    slot 1 is at capacity (flagged truncated, its length held): tokens,
    n_emit, truncated and the caches as in JAX."""
    m = models[kind]
    je, te, jc, tc, prompts, firsts = _verify_state(m, paged)
    slab = np.zeros((2, K + 1), np.int32)
    slab[:, 0] = firsts
    slab[0, 1:] = _continuation(m, prompts[0] + firsts[:1], K)
    slab[1, 1:] = 5
    jc, jt, jn, jtr = je.verify(jc, slab)
    tc, tt, tn, ttr = te.verify(tc, slab)
    assert tt.device.type == tn.device.type == ttr.device.type == "cpu"
    assert tt.tolist() == np.asarray(jt).tolist()
    assert tn.tolist() == np.asarray(jn).tolist()
    assert ttr.tolist() == np.asarray(jtr).tolist() == [False, True]
    assert tn[0] == K + 1 and tt[0, :K].tolist() == slab[0, 1:].tolist()
    _same_cache(jc, tc, paged)


@pytest.mark.parametrize("kind,paged", CASES, ids=IDS)
def test_step_factories_match_jax(models, kind, paged):
    """One prefill, two decode steps and one verify step through the
    three factories of each package, on the same operands: greedy
    tokens equal, logits and caches within ATOL."""
    m = models[kind]
    greedy_j, greedy_t = JaxSampling(), SamplingConfig()
    jpre = jax.jit(jengine.make_prefill_fn(kind, m["jcfg"], greedy_j,
                                           paged=paged))
    tpre = make_prefill_fn(kind, m["cfg"], greedy_t, paged=paged)
    jdec = jax.jit(jengine.make_decode_fn(kind, m["jcfg"], greedy_j))
    tdec = make_decode_fn(kind, m["cfg"], greedy_t)
    jver = jax.jit(jengine.make_verify_fn(kind, m["jcfg"], greedy_j, K))
    tver = make_verify_fn(kind, m["cfg"], greedy_t, K)
    je, te = _jax(m, paged), _port(m, paged)
    jc, tc = je.init_cache(), te.init_cache()
    key, gen = jax.random.PRNGKey(0), torch.Generator()
    prompt = _prompts(9, [11])[0]
    padded = np.zeros((64,), np.int32)
    padded[:11] = prompt
    for slot in range(2):
        tail = ()
        if paged:
            row = kv_cache.page_row(range(4 * slot, 4 * slot + 4), 8, 24)
            tail = (row, 0)
        jc, jt, jl = jpre(jc, m["jparams"], jnp.asarray(padded),
                          np.int32(slot), np.int32(11),
                          *(jnp.asarray(a) for a in tail), key, 0)
        tc, tt, tl = tpre(tc, m["tparams"], torch.from_numpy(padded), slot,
                          11, *tail, gen, 0)
        assert int(tt) == int(jt)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    toks = np.asarray([int(tt)] * 2, np.int32)
    active = np.asarray([True, False])
    for step in (1, 2):
        jc, jt, jl, jtr = jdec(jc, m["jparams"], jnp.asarray(toks),
                               jnp.asarray(active), key, step)
        tc, tt, tl, ttr = tdec(tc, m["tparams"], torch.from_numpy(toks),
                               torch.from_numpy(active), gen, step)
        assert tt.tolist() == np.asarray(jt).tolist()
        assert ttr.tolist() == np.asarray(jtr).tolist()
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
        _same_cache(jc, tc, paged)
        toks = tt.numpy()
    slab = np.asarray(_prompts(10, [K + 1, K + 1]), np.int32)
    slab[:, 0] = toks
    jc, jt, jn, jtr = jver(jc, m["jparams"], jnp.asarray(slab),
                           jnp.asarray([True, True]), key, 3)
    tc, tt, tn, ttr = tver(tc, m["tparams"], torch.from_numpy(slab),
                           torch.tensor([True, True]), gen, 3)
    assert tt.tolist() == np.asarray(jt).tolist()
    assert tn.tolist() == np.asarray(jn).tolist()
    assert ttr.tolist() == np.asarray(jtr).tolist()
    _same_cache(jc, tc, paged)


def test_engine_methods_run_the_factories_bodies(models, monkeypatch):
    """The engine's prefill, decode and verify call the functions the
    factories built, once each, with the engine's generator."""
    m = models["gpt"]
    eng = _port(m, True, spec_k=K)
    calls = []
    for name in ("_prefill_raw", "_decode_raw", "_verify_raw"):
        fn = getattr(eng, name)

        def spy(*args, _fn=fn, _name=name):
            calls.append((_name, args[-2] is eng._gen, args[-1]))
            return _fn(*args)

        monkeypatch.setattr(eng, name, spy)
    cache = eng.init_cache()
    alloc = eng.new_allocator()
    cache, tok, _ = eng.prefill(cache, [1, 2, 3], 0,
                                pages=alloc.acquire(alloc.pages_needed(8)))
    cache, toks, _, _ = eng.decode(cache, [int(tok), 0], [True, False])
    eng.verify(cache, np.zeros((2, K + 1), np.int32), [True, False])
    assert calls == [("_prefill_raw", True, 0), ("_decode_raw", True, 1),
                     ("_verify_raw", True, 2)]


def test_spec_stream_matches_the_jax_engine(models):
    """The whole speculative serve (the scheduler's verify waves, the
    default n-gram drafter) emits the JAX engine's tokens."""
    m = models["llama"]
    prompts = [list((np.arange(10) * 3 + i) % VOCAB) for i in range(3)]
    from apex_tpu.inference import SlotScheduler as JaxScheduler
    from apex_tpu.observability import MetricsRegistry as JaxRegistry
    from apex_tpu.observability import ServeTelemetry as JaxTelemetry
    je = _jax(m, True, spec_k=K)
    js = JaxScheduler(je, telemetry=JaxTelemetry(JaxRegistry()))
    ju = [js.submit(p, max_new_tokens=8) for p in prompts]
    jout = js.run()
    out, tel = _serve(m, prompts, paged=True, spec_k=K)
    assert out == [jout[u] for u in ju]
    assert int(tel.spec_verify_steps.total()) > 0


# -- the port counterparts of the JAX package's speculative tests -----------

def _serve(m, prompts, mnt=8, drafter=None, paged=True, **kw):
    eng = _port(m, paged, **kw)
    tel = ServeTelemetry(MetricsRegistry())
    sched = SlotScheduler(eng, telemetry=tel, drafter=drafter)
    uids = [sched.submit(p, max_new_tokens=mnt) for p in prompts]
    out = sched.run()
    return [out[u] for u in uids], tel


@pytest.mark.parametrize("kind", ["gpt", "llama"])
def test_spec_stream_equals_plain_greedy_paged(models, kind):
    m = models[kind]
    prompts = [list((np.arange(10) * 3 + i) % VOCAB) for i in range(3)]
    base, _ = _serve(m, prompts)
    spec, tel = _serve(m, prompts, spec_k=K)
    assert base == spec
    assert int(tel.spec_verify_steps.total()) > 0
    assert int(tel.recompiles.total()) == 0
    # conservation: every emitted token reached a request
    assert int(tel.spec_emitted.total()) == \
        int(tel.tokens_generated.total()) - len(prompts)


@pytest.mark.parametrize("kind", ["gpt", "llama"])
def test_spec_stream_equals_plain_greedy_dense(models, kind):
    """The verify slab is layout-agnostic: the dense slot cache rolls
    back by the same length reset."""
    m = models[kind]
    prompts = [list((np.arange(10) * 3 + i) % VOCAB) for i in range(3)]
    base, _ = _serve(m, prompts, paged=False)
    spec, _ = _serve(m, prompts, paged=False, spec_k=4)
    assert base == spec


def test_poisoned_drafts_still_emit_target_stream(models):
    """A drafter that lies costs speculation upside only: every round
    rejects and emits the bonus token, the stream is the target's."""
    m = models["gpt"]
    prompts = [list((np.arange(10) * 3) % VOCAB)]
    base, _ = _serve(m, prompts)
    bad = next(t for t in range(VOCAB - 1, -1, -1) if t not in base[0])
    poisoned = ReplayDrafter({tuple(prompts[0]): [bad] * 16})
    spec, tel = _serve(m, prompts, spec_k=K, drafter=poisoned)
    assert spec == base
    assert int(tel.spec_accepted.total()) == 0
    assert int(tel.spec_emitted.total()) == len(base[0]) - 1


def test_replay_drafter_reaches_full_acceptance(models):
    m = models["llama"]
    prompts = [list((np.arange(9) * 5 + i) % VOCAB) for i in range(2)]
    base, _ = _serve(m, prompts)
    script = {tuple(p): toks for p, toks in zip(prompts, base)}
    spec, tel = _serve(m, prompts, spec_k=4, drafter=ReplayDrafter(script))
    assert spec == base
    drafted = int(tel.spec_drafted.total())
    accepted = int(tel.spec_accepted.total())
    assert accepted / drafted >= 0.5
    assert int(tel.spec_verify_steps.total()) <= 2
    emitted = int(tel.spec_emitted.total())
    assert emitted / (drafted // 4) >= 1.5


def test_verify_rollback_lengths_and_pages(models):
    """engine.verify: lengths advance by n_emit, the page table is
    untouched; with the true continuation every draft is accepted and
    the emitted tokens are the decode steps' tokens."""
    m = models["gpt"]
    eng = _port(m, True, spec_k=K)
    prompt = list((np.arange(10) * 3) % VOCAB)

    def prefilled():
        alloc = eng.new_allocator()
        cache = eng.init_cache()
        toks = []
        for slot in range(2):
            pages = alloc.acquire(alloc.pages_needed(len(prompt) + 8))
            cache, tok, _ = eng.prefill(cache, prompt, slot, pages=pages)
            toks.append(int(tok))
        return cache, toks

    cache, toks = prefilled()
    table = cache.page_table.clone()
    before = cache.lengths.clone()
    slab = np.zeros((2, K + 1), np.int32)
    slab[:, 0] = toks
    slab[:, 1:] = next(t for t in range(VOCAB) if t not in toks)
    cache, out, n_emit, truncated = eng.verify(cache, slab)
    assert not truncated.any()
    assert torch.equal(cache.page_table, table)
    assert torch.equal(cache.lengths, before + n_emit)
    # the true continuation: K greedy decode steps
    c, _ = prefilled()
    t = np.asarray(toks, np.int32)
    stream = []
    for _ in range(K):
        c, nxt, _, _ = eng.decode(c, t)
        t = nxt.numpy()
        stream.append(t.copy())
    slab3 = np.zeros((2, K + 1), np.int32)
    slab3[:, 0] = toks
    for j in range(K):
        slab3[:, 1 + j] = stream[j]
    cache3, _ = prefilled()
    cache3, out3, n_emit3, _ = eng.verify(cache3, slab3)
    assert n_emit3.tolist() == [K + 1, K + 1]
    for j in range(K):
        assert out3[:, j].tolist() == stream[j].tolist()


def test_append_slab_paged_sends_rows_past_the_window_to_the_trash_page():
    """Rows inside the window land at (page, offset); rows past it go to
    the trash page: no other page changes."""
    cache = kv_cache.init_paged_cache(6, 1, 1, 4, 2, slots=1,
                                      max_pages_per_slot=2,
                                      dtype=torch.float32, device="cpu")
    cache.page_table.copy_(torch.tensor([[0, 1]], dtype=torch.int32))
    cache.lengths.fill_(6)
    cache.capacity.fill_(8)
    k = torch.arange(8, dtype=torch.float32).reshape(1, 1, 4, 2) + 1.0
    before = cache.k.clone()
    cache = kv_cache.append_slab(cache, 0, k, k)
    after = cache.k
    assert torch.equal(after[1, 0, 0, 2], k[0, 0, 0])
    assert torch.equal(after[1, 0, 0, 3], k[0, 0, 1])
    changed = [p for p in range(7) if not torch.equal(after[p], before[p])]
    assert changed == [1, cache.null_page]


def test_append_slab_dense_drops_rows_past_max_seq_never_clamps():
    """A dense slab crossing max_seq writes its in-window rows and drops
    the rest; a slot at capacity changes no row (a clamp would overwrite
    its last live row)."""
    cache = kv_cache.init_cache(2, 1, 1, 8, 2, dtype=torch.float32,
                                device="cpu")
    cache.k.copy_(torch.randn(cache.k.shape, generator=torch.Generator()
                              .manual_seed(0)))
    cache.lengths.copy_(torch.tensor([6, 8], dtype=torch.int32))
    before = cache.k.clone()
    slab = 100 + torch.arange(2 * 4 * 2, dtype=torch.float32).reshape(
        2, 1, 4, 2)
    cache = kv_cache.append_slab(cache, 0, slab, slab)
    assert torch.equal(cache.k[0, 0, 0, 6:], slab[0, 0, :2])
    assert torch.equal(cache.k[0, 0, 0, :6], before[0, 0, 0, :6])
    assert torch.equal(cache.k[1], before[1])


def test_advance_by_clamps_and_flags():
    cache = kv_cache.init_paged_cache(6, 1, 1, 4, 2, slots=2,
                                      max_pages_per_slot=2,
                                      dtype=torch.float32, device="cpu")
    cache.lengths.copy_(torch.tensor([6, 0], dtype=torch.int32))
    cache.capacity.copy_(torch.tensor([8, 0], dtype=torch.int32))
    cache, trunc = kv_cache.advance_by(cache, np.asarray([True, True]),
                                       np.asarray([4, 4], np.int32))
    # slot 0 wanted 10 > cap 8: clamped and flagged; slot 1 has capacity
    # 0 (never admitted): clamped to 0, not flagged
    assert cache.lengths.tolist() == [8, 0]
    assert trunc.tolist() == [True, False]


def test_set_lengths_rollback():
    cache = kv_cache.init_cache(2, 1, 1, 16, 2, dtype=torch.float32,
                                device="cpu")
    cache.lengths.copy_(torch.tensor([9, 4], dtype=torch.int32))
    cache = kv_cache.set_lengths(cache, np.asarray([5, 4], np.int32))
    assert cache.lengths.tolist() == [5, 4]


def test_ngram_drafter_prompt_lookup():
    d = NGramDrafter(max_ngram=3)
    d.begin(0, [1, 2, 3, 4, 1, 2, 3], first_token=4)
    assert d.draft(0, 3) == [1, 2, 3]
    d.observe(0, [9])
    assert d.draft(0, 3) == []
    d.retire(0)
    assert d.draft(0, 3) == []


def test_ngram_drafter_min_ngram_refuses_coincidence():
    d = NGramDrafter(max_ngram=3, min_ngram=2)
    d.begin(0, [1, 2, 3], first_token=1)
    assert d.draft(0, 2) == []
    d2 = NGramDrafter(max_ngram=3, min_ngram=1)
    d2.begin(0, [1, 2, 3], first_token=1)
    assert d2.draft(0, 2) == [2, 3]


@pytest.mark.parametrize("kind", ["gpt", "llama"])
def test_engine_drafter_self_draft_full_acceptance(models, kind):
    """A draft engine on the SAME weights drafts the target's stream:
    acceptance near 1, the draft cache's rollback keeping it consistent;
    the draft engine holds no copy of the weights."""
    m = models[kind]
    prompts = [list((np.arange(9) * 5 + i) % VOCAB) for i in range(2)]
    base, _ = _serve(m, prompts)
    draft = _port(m, False)
    target_w = m["tparams"]
    assert all(a.data_ptr() == b.data_ptr() for a, b in zip(
        jax.tree_util.tree_leaves(draft.params),
        jax.tree_util.tree_leaves(target_w)))
    spec, tel = _serve(m, prompts, spec_k=K, drafter=EngineDrafter(draft))
    assert spec == base
    assert int(tel.spec_accepted.total()) / int(
        tel.spec_drafted.total()) >= 0.7


def test_engine_drafter_rejects_misconfiguration(models):
    m = models["gpt"]
    with pytest.raises(ValueError):
        EngineDrafter(_port(m, True))         # a paged draft cache
    with pytest.raises(ValueError):
        EngineDrafter(_port(m, False,
                            sampling=SamplingConfig(temperature=0.7)))


def test_verify_requires_greedy_and_k(models):
    m = models["gpt"]
    with pytest.raises(ValueError):
        make_verify_fn("gpt", m["cfg"], SamplingConfig(), k=0)
    with pytest.raises(ValueError):
        make_verify_fn("gpt", m["cfg"], SamplingConfig(temperature=0.5), k=2)
    eng = _port(m, False)
    with pytest.raises(ValueError, match="spec_k"):
        eng.verify(eng.init_cache(), np.zeros((2, 3), np.int32))
    eng = _port(m, False, spec_k=2)
    with pytest.raises(ValueError, match="slab"):
        eng.verify(eng.init_cache(), np.zeros((2, 4), np.int32))
    with pytest.raises(ValueError, match="greedy"):
        _port(m, True, spec_k=2, sampling=SamplingConfig(temperature=0.5))


@pytest.mark.parametrize("which", ["prefill", "decode", "verify"])
def test_factories_take_tp_1_and_name_the_later_slice(models, which):
    """tp = 1 builds a step; tp = 2 without an initialised
    torch.distributed raises, naming what the rank must call first."""
    cfg, greedy = models["gpt"]["cfg"], SamplingConfig()
    build = {"prefill": lambda tp: make_prefill_fn("gpt", cfg, greedy,
                                                   tp=tp),
             "decode": lambda tp: make_decode_fn("gpt", cfg, greedy, tp=tp),
             "verify": lambda tp: make_verify_fn("gpt", cfg, greedy, 2,
                                                 tp=tp)}[which]
    assert callable(build(1))
    with pytest.raises(RuntimeError, match="init_process_group"):
        build(2)
    with pytest.raises(ValueError):
        build(0)


def test_verify_step_histogram_sample_is_per_token():
    """The decode-latency histogram sees a verify step's per-token
    latency (step seconds over the mean tokens emitted a slot); the raw
    step time goes to ``spec_step_seconds``."""
    tel = ServeTelemetry(MetricsRegistry())
    with tel.verify_step(2) as holder:
        time.sleep(0.02)
        holder["tokens"] = 8.0         # 4 tokens per active slot
    assert tel.spec_step_seconds >= 0.02
    assert tel.decode_token_seconds.count() == 1
    assert tel.decode_token_seconds.sum() <= tel.spec_step_seconds / 2
    assert int(tel.spec_verify_steps.total()) == 1


def test_default_spec_k_env(monkeypatch, models):
    from apex_tpu_torch.inference.speculative import default_spec_k
    monkeypatch.delenv("APEX_TPU_SPEC_K", raising=False)
    assert default_spec_k() == 0
    monkeypatch.setenv("APEX_TPU_SPEC_K", "4")
    assert default_spec_k() == 4
    # the env knob arms speculation on an engine built without spec_k
    assert _port(models["gpt"], True).spec_k == 4
    monkeypatch.setenv("APEX_TPU_SPEC_K", "-1")
    with pytest.raises(ValueError):
        default_spec_k()
    monkeypatch.setenv("APEX_TPU_SPEC_K", "many")
    with pytest.raises(ValueError):
        default_spec_k()


def test_verify_dispatch_counter(models):
    from apex_tpu_torch import observability as obs
    reg = obs.reset_global_registry()
    m = models["gpt"]
    eng = _port(m, False, spec_k=K)
    cache = eng.init_cache()
    eng.verify(cache, np.zeros((2, K + 1), np.int32))
    eng.verify(cache, np.zeros((2, K + 1), np.int32))
    assert int(reg.declared("infer_verify_dispatch_total").total()) == 2
    assert int(reg.declared("infer_decode_dispatch_total").total()) == 0
