"""The serving slice end to end: the port's paged LLaMA engine against
the JAX package's on the same converted weights (CPU, fp32).

Config: 2 layers, hidden 128, 4 heads over 2 kv heads (GQA group 2),
ffn 256, vocab 256, max_seq 128, page 16.  The JAX engine runs its
Pallas kernels in interpret mode (paged kernel forced with
``paged_attn_max_pages=0``); both engines keep an fp32 cache.
Tolerance for logits: 1e-4 absolute — fp32 on both sides, the two
differing in reduction order (blockwise online softmax vs one-pass,
XLA vs PyTorch matmuls) over two layers.  Greedy tokens must be equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.inference import InferenceEngine as JaxEngine
from apex_tpu.inference import SlotScheduler as JaxScheduler
from apex_tpu.inference import models as jmodels
from apex_tpu.inference.sampling import SamplingConfig as JaxSampling
from apex_tpu.inference.sampling import _top_k_mask as jax_top_k_mask
from apex_tpu.observability import MetricsRegistry as JaxRegistry
from apex_tpu.observability import ServeTelemetry as JaxTelemetry
from apex_tpu.transformer import parallel_state
from apex_tpu.transformer.testing import LlamaConfig as JaxLlamaConfig
from apex_tpu.transformer.testing import llama_model_provider
from apex_tpu_torch.inference import InferenceEngine, SlotScheduler
from apex_tpu_torch.inference import models as tmodels
from apex_tpu_torch.inference import params_from_jax
from apex_tpu_torch.inference.sampling import (SamplingConfig,
                                               _top_k_mask, sample_token)
from apex_tpu_torch.observability import MetricsRegistry, ServeTelemetry
from apex_tpu_torch.transformer.testing import LlamaConfig

from _torch_isolation import restore_torch_from_amp  # noqa: F401

CFG = dict(vocab_size=256, hidden_size=128, num_layers=2,
           num_attention_heads=4, num_kv_heads=2, ffn_hidden_size=256,
           max_seq_length=128)
ENGINE = dict(slots=2, max_seq=128, page_size=16, num_pages=24)
ATOL = 1e-4


@pytest.fixture(scope="module")
def model():
    parallel_state.destroy_model_parallel()
    parallel_state.initialize_model_parallel(1)
    jcfg = JaxLlamaConfig(**CFG)
    jparams = llama_model_provider(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    cfg = LlamaConfig(**CFG)
    tparams = params_from_jax("llama", cfg, tree, device="cpu")
    return jcfg, jparams, cfg, tparams


def _engines(model):
    jcfg, jparams, cfg, tparams = model
    je = JaxEngine("llama", jcfg, jparams, cache_dtype=jnp.float32,
                   paged_attn_max_pages=0, **ENGINE)
    te = InferenceEngine("llama", cfg, tparams, cache_dtype=torch.float32,
                         device="cpu", **ENGINE)
    return je, te


def _prompts(seed, lens):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, CFG["vocab_size"], size=n).tolist() for n in lens]


def test_params_from_jax_keeps_paths_values_and_layouts(model):
    _, jparams, cfg, tparams = model
    flat_j = jax.tree_util.tree_flatten_with_path(jparams)[0]
    assert len(flat_j) == 3 + 8 * CFG["num_layers"]
    for path, leaf in flat_j:
        node = tparams
        for key in path:
            node = node[key.key]
        assert isinstance(node, torch.Tensor)
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    # the bare tree (no "params") and bf16 leaves convert too
    bare = jax.tree_util.tree_map(
        lambda a: np.asarray(a.astype(jnp.bfloat16)), jparams["params"])
    tb = params_from_jax("llama", cfg, bare, device="cpu")
    w = tb["layer_0"]["attention"]["kv_proj"]["weight"]
    assert w.dtype == torch.bfloat16 and tuple(w.shape) == (128, 128)
    with pytest.raises(ValueError, match="shape"):
        params_from_jax("llama", LlamaConfig(**dict(CFG, ffn_hidden_size=64)),
                        bare, device="cpu")


@pytest.mark.parametrize("n", [1, 64])
def test_prefill_logits_match_jax(model, n):
    jcfg, jparams, cfg, tparams = model
    toks = np.asarray(_prompts(n, [n])[0], np.int32)[None]
    jl, jk, jv = jax.jit(jmodels.prefill_forward, static_argnums=(0, 1))(
        "llama", jcfg, jparams, jnp.asarray(toks))
    tl, tk, tv = tmodels.prefill_forward("llama", cfg, tparams,
                                         torch.from_numpy(toks))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=ATOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL)
    jl, _, _ = jax.jit(jmodels.prefill_forward, static_argnums=(0, 1))(
        "llama", jcfg, jparams, jnp.asarray(toks), n)
    tl, _, _ = tmodels.prefill_forward("llama", cfg, tparams,
                                       torch.from_numpy(toks), n)
    assert tuple(tl.shape) == (1, CFG["vocab_size"])
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)


def test_greedy_decode_steps_match_jax_paged_engine(model):
    """Two slots prefilled, then 8 batched greedy decode steps: logits
    within tolerance at every step, tokens equal."""
    je, te = _engines(model)
    prompts = _prompts(1, [9, 30])
    jc, tc = je.init_cache(), te.init_cache()
    ja, ta = je.new_allocator(), te.new_allocator()
    last = np.zeros((2,), np.int32)
    for slot, p in enumerate(prompts):
        need = ja.pages_needed(len(p) + 8)
        jpages, tpages = ja.acquire(need), ta.acquire(need)
        assert jpages == tpages
        jc, jt, jlog = je.prefill(jc, p, slot, pages=jpages)
        tc, tt, tlog = te.prefill(tc, p, slot, pages=tpages)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   atol=ATOL)
        assert int(tt) == int(jt)
        last[slot] = int(tt)
    for _ in range(8):
        jc, jt, jlog, jtr = je.decode(jc, last)
        tc, tt, tlog, ttr = te.decode(tc, last)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   atol=ATOL)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        assert not ttr.any() and not np.asarray(jtr).any()
        last = tt.numpy().astype(np.int32)
    np.testing.assert_array_equal(tc.lengths.numpy(), np.asarray(jc.lengths))


def test_generate_matches_jax_engine(model):
    je, te = _engines(model)
    prompts = _prompts(2, [5, 17, 40])     # 3 requests over 2 slots
    assert te.generate(prompts, max_new_tokens=6) == [
        [int(t) for t in o] for o in je.generate(prompts, max_new_tokens=6)]


def test_prefix_hit_and_chunked_prefill_match_jax(model):
    """The copied SlotScheduler over both engines: a first wave fills
    the prefix cache; the second wave's prompts extend that prefix (a
    hit, resumed mid-page after a COW) or repeat it exactly, and every
    prefill runs in 32-token chunks — the warm prefix-window path."""
    je, te = _engines(model)
    base = _prompts(3, [45])[0]
    wave1 = [base + [7, 8, 9]]
    wave2 = [base + [1, 2, 3, 4, 5], list(wave1[0]), base[:37]]
    jtel = JaxTelemetry(JaxRegistry(), trace=0)
    ttel = ServeTelemetry(MetricsRegistry(), trace=0)
    js = JaxScheduler(je, jtel, prefix_cache=True, prefill_chunk=32)
    ts = SlotScheduler(te, ttel, prefix_cache=True, prefill_chunk=32)
    for wave in (wave1, wave2):
        juids = [js.submit(p, max_new_tokens=5) for p in wave]
        tuids = [ts.submit(p, max_new_tokens=5) for p in wave]
        jout, tout = js.run(), ts.run()
        assert [tout[u] for u in tuids] == [
            [int(t) for t in jout[u]] for u in juids]
    assert ttel.prefix_hits.total() == jtel.prefix_hits.total() >= 3
    assert ttel.cow_copies.total() == jtel.cow_copies.total() >= 1
    assert ttel.prefill_chunks.total() == jtel.prefill_chunks.total() > 0


def test_prefill_plus_greedy_decode_equals_full_forward_argmax(model):
    """The JAX package's acceptance rule, on the port alone: every
    generated token is the argmax of a full forward over the sequence
    so far."""
    _, _, cfg, tparams = model
    te = InferenceEngine("llama", cfg, tparams, cache_dtype=torch.float32,
                         device="cpu", **ENGINE)
    prompt = _prompts(4, [21])[0]
    got = te.generate([prompt], max_new_tokens=6)[0]
    seq = list(prompt)
    for _ in range(6):
        logits, _, _ = tmodels.prefill_forward(
            "llama", cfg, tparams, torch.tensor([seq], dtype=torch.int32))
        seq.append(int(logits[-1, 0].argmax()))
    assert got == seq[len(prompt):]


def test_top_k_mask_matches_jax_and_samples_follow_distribution():
    rng = np.random.RandomState(5)
    logits = rng.randn(3, 50).astype(np.float32)
    got = _top_k_mask(torch.from_numpy(logits), 7).numpy()
    ref = np.asarray(jax_top_k_mask(jnp.asarray(logits), 7))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(ref))
    np.testing.assert_array_equal(got[~np.isinf(got)], ref[~np.isinf(ref)])
    # torch.Generator bits differ from jax.random's: hold the sampled
    # frequencies against the masked softmax instead (5000 draws;
    # limit 0.03 is > 4 standard errors of any frequency)
    cfg = SamplingConfig(temperature=0.7, top_k=5)
    assert cfg == SamplingConfig(**JaxSampling(0.7, 5).__dict__)
    row = torch.from_numpy(np.repeat(logits[:1], 5000, axis=0))
    gen = torch.Generator().manual_seed(0)
    toks = sample_token(row, gen, cfg).numpy()
    freq = np.bincount(toks, minlength=50) / toks.size
    want = torch.softmax(_top_k_mask(row[:1] / 0.7, 5), -1)[0].numpy()
    assert set(np.nonzero(freq)[0]) <= set(np.nonzero(want)[0])
    np.testing.assert_allclose(freq, want, atol=0.03)
