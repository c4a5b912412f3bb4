"""Port parity: the dense slot cache of ``apex_tpu_torch.inference.
kv_cache`` and ``decode_attention`` against the JAX package, and a dense
LLaMA engine against the JAX dense engine (CPU, fp32).

The JAX cache mutations are pure (a new cache per call), the port's
update the cache in place, so each test applies the same sequence to
both and compares every array bit for bit (fp32 copies, no
arithmetic) — the capacity clamp and the ``truncated`` flags included.
``decode_attention`` takes the same seeded inputs on both sides, on
both of its branches (the plain grouped chain, forced with
``xla_max_seq``; the masked flash path, forced with ``use_kernel``,
Pallas in interpret mode on the JAX side), MHA, GQA and MQA, with a
slot of length 0: 1e-5 absolute (fp32, another reduction order).  The
engine: 2 layers, hidden 128, 4 heads over 2 kv heads, logits within
1e-4 (as ``test_torch_serving.py``), tokens equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.inference import InferenceEngine as JaxEngine
from apex_tpu.inference import kv_cache as jkv
from apex_tpu.ops import attention as jattn
from apex_tpu.transformer import parallel_state
from apex_tpu.transformer.testing import LlamaConfig as JaxLlamaConfig
from apex_tpu.transformer.testing import llama_model_provider
from apex_tpu_torch.inference import InferenceEngine, params_from_jax
from apex_tpu_torch.inference import kv_cache as tkv
from apex_tpu_torch.ops import _build
from apex_tpu_torch.ops import attention as tattn
from apex_tpu_torch.transformer.testing import LlamaConfig

from _torch_isolation import restore_torch_from_amp  # noqa: F401

SLOTS, LAYERS, KVH, MAX_SEQ, D = 3, 2, 2, 16, 8


def _pair():
    j = jkv.init_cache(SLOTS, LAYERS, KVH, MAX_SEQ, D, dtype=jnp.float32)
    t = tkv.init_cache(SLOTS, LAYERS, KVH, MAX_SEQ, D, dtype=torch.float32,
                       device="cpu")
    return j, t


def _same(j, t):
    for name in ("k", "v", "lengths"):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)),
                                      err_msg=name)


def _slab(s, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(LAYERS, KVH, s, D).astype(np.float32),
            rng.randn(LAYERS, KVH, s, D).astype(np.float32))


def _tok(seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(SLOTS, KVH, D).astype(np.float32),
            rng.randn(SLOTS, KVH, D).astype(np.float32))


def test_init_geometry():
    j, t = _pair()
    _same(j, t)
    assert (t.slots, t.layers, t.kv_heads, t.max_seq, t.head_dim) == (
        SLOTS, LAYERS, KVH, MAX_SEQ, D)
    assert t.lengths.dtype == torch.int32 and t.device.type == "cpu"


def test_insert_append_advance_match_jax():
    """Prefill two slots (one bucket-padded), append two decode tokens to
    every layer, advance the active ones: every array equal."""
    j, t = _pair()
    for slot, (s, length) in ((0, (8, 5)), (2, (4, 4))):
        k, v = _slab(s, slot)
        j = jkv.insert(j, slot, jnp.asarray(k), jnp.asarray(v), length)
        t = tkv.insert(t, slot, torch.from_numpy(k), torch.from_numpy(v),
                       length)
    _same(j, t)
    active = np.array([True, False, True])
    for step in range(2):
        for layer in range(LAYERS):
            kt, vt = _tok(10 * step + layer)
            j = jkv.append_layer(j, layer, jnp.asarray(kt), jnp.asarray(vt))
            t = tkv.append_layer(t, layer, torch.from_numpy(kt),
                                 torch.from_numpy(vt))
        j, jtr = jkv.advance(j, active)
        t, ttr = tkv.advance(t, active)
        assert ttr.tolist() == np.asarray(jtr).tolist() == [False] * 3
        _same(j, t)
    assert t.lengths.tolist() == [7, 0, 6]


def test_append_at_capacity_clamps_onto_the_last_row_and_truncates():
    """A slot at max_seq: the JAX ``dynamic_update_slice`` clamps the
    write onto row max_seq - 1; the port mirrors it (rows before it
    untouched), and ``advance`` flags the slot and holds its length."""
    j, t = _pair()
    k, v = _slab(MAX_SEQ, 3)
    j = jkv.insert(j, 1, jnp.asarray(k), jnp.asarray(v), MAX_SEQ)
    t = tkv.insert(t, 1, torch.from_numpy(k), torch.from_numpy(v), MAX_SEQ)
    before = t.k[1, 0, :, :MAX_SEQ - 1].clone()
    kt, vt = _tok(4)
    j = jkv.append_layer(j, 0, jnp.asarray(kt), jnp.asarray(vt))
    t = tkv.append_layer(t, 0, torch.from_numpy(kt), torch.from_numpy(vt))
    _same(j, t)
    assert torch.equal(t.k[1, 0, :, MAX_SEQ - 1], torch.from_numpy(kt[1]))
    assert torch.equal(t.k[1, 0, :, :MAX_SEQ - 1], before)
    j, jtr = jkv.advance(j, np.array([True, True, False]))
    t, ttr = tkv.advance(t, np.array([True, True, False]))
    assert ttr.tolist() == np.asarray(jtr).tolist() == [False, True, False]
    _same(j, t)
    assert t.lengths.tolist() == [1, MAX_SEQ, 0]


def test_set_lengths_and_evict_match_jax():
    j, t = _pair()
    for new in ([3, 40, -2], [0, 16, 7]):
        j = jkv.set_lengths(j, np.asarray(new, np.int32))
        t = tkv.set_lengths(t, np.asarray(new, np.int32))
        _same(j, t)
    assert t.lengths.tolist() == [0, 16, 7]
    j = jkv.evict(j, 1)
    t = tkv.evict(t, 1)
    _same(j, t)
    assert t.lengths.tolist() == [0, 0, 7]


def _decode_case(h, kvh, s_cache, seed):
    rng = np.random.RandomState(seed)
    b, d = 4, 16
    q = rng.randn(b, h, 1, d).astype(np.float32)
    k = rng.randn(b, kvh, s_cache, d).astype(np.float32)
    v = rng.randn(b, kvh, s_cache, d).astype(np.float32)
    lengths = np.asarray([0, 1, s_cache // 2 + 3, s_cache], np.int32)
    return q, k, v, lengths


@pytest.mark.parametrize("kvh", [4, 2, 1], ids=["mha", "gqa", "mqa"])
@pytest.mark.parametrize("branch", ["plain", "kernel"])
def test_decode_attention_matches_jax(kvh, branch):
    q, k, v, lengths = _decode_case(4, kvh, 40, seed=kvh)
    kw = (dict(xla_max_seq=4096) if branch == "plain"
          else dict(use_kernel=True))
    ref = np.asarray(jattn.decode_attention(
        *(jnp.asarray(a) for a in (q, k, v, lengths)), **kw))
    _build.reset_launch_counts()
    got = tattn.decode_attention(
        *(torch.from_numpy(a) for a in (q, k, v, lengths)), **kw).numpy()
    assert not any(_build.launch_counts().values())
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    assert got.shape == (4, 4, 1, 16)
    assert np.all(got[0] == 0)                     # a length-0 slot
    # the squeezed [b, h, d] query, and the crossover: a cache longer
    # than xla_max_seq takes the kernel branch, at or below the plain one
    sq = tattn.decode_attention(*(torch.from_numpy(a) for a in (
        q[:, :, 0], k, v, lengths)), xla_max_seq=40 if branch == "plain"
        else 39)
    np.testing.assert_allclose(sq.numpy(), got[:, :, 0], rtol=0, atol=1e-5)


def test_decode_crossover_reads_the_env(monkeypatch):
    assert tattn.decode_xla_max_seq() == 4096 == jattn.decode_xla_max_seq()
    monkeypatch.setenv("APEX_TPU_DECODE_XLA_MAX_SEQ", "17")
    assert tattn.decode_xla_max_seq() == 17 == jattn.decode_xla_max_seq()
    assert tattn.decode_xla_max_seq(5) == 5
    monkeypatch.setenv("APEX_TPU_DECODE_XLA_MAX_SEQ", "x")
    with pytest.raises(ValueError, match="must be an int"):
        tattn.decode_xla_max_seq()


@pytest.mark.parametrize("mask_shape", [(2, 1, 24, 24), (1, 1, 24, 24),
                                        (2, 3, 24, 24), (2, 1, 1, 24)],
                         ids=["per-batch", "one", "per-head", "key-only"])
def test_masked_flash_forward_matches_jax(mask_shape):
    """The public entry with a mask: the port's mask3 and the masked
    kernel's plain version against the JAX flash kernel (interpret
    mode), causal, with fully masked rows; its backward (the masked
    backward's plain version) gives finite grads, JAX's within 1e-5."""
    rng = np.random.RandomState(21)
    q, k, v = (rng.randn(2, 3, 24, 16).astype(np.float32) for _ in range(3))
    mask = rng.rand(*mask_shape) > 0.6
    if mask_shape[2] > 1:
        mask[..., 3, :] = True             # a fully masked row
    else:
        mask[-1] = True                    # every row of the last batch
    ref, vjp = jax.vjp(lambda a, b, c: jattn.flash_attention(
        a, b, c, causal=True, mask=jnp.asarray(mask)),
        *(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    got = tattn.flash_attention(tq, tk, tv, causal=True,
                                mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5)
    got.sum().backward()
    for g, r in zip((tq.grad, tk.grad, tv.grad),
                    vjp(jnp.ones(ref.shape, ref.dtype))):
        assert bool(torch.isfinite(g).all())
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                   atol=1e-5)


CFG = dict(vocab_size=256, hidden_size=128, num_layers=2,
           num_attention_heads=4, num_kv_heads=2, ffn_hidden_size=256,
           max_seq_length=128)
DENSE = dict(slots=2, max_seq=128)


@pytest.fixture(scope="module")
def llama():
    parallel_state.destroy_model_parallel()
    parallel_state.initialize_model_parallel(1)
    jcfg = JaxLlamaConfig(**CFG)
    jparams = llama_model_provider(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))
    cfg = LlamaConfig(**CFG)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    tparams = params_from_jax("llama", cfg, tree, device="cpu")
    je = JaxEngine("llama", jcfg, jparams, cache_dtype=jnp.float32, **DENSE)
    te = InferenceEngine("llama", cfg, tparams, cache_dtype=torch.float32,
                         device="cpu", **DENSE)
    return je, te


def test_dense_llama_engine_geometry(llama):
    _, te = llama
    assert not te.paged and te.page_size is None
    assert te.bucket_for(1) == 64
    # 2 slots x 128 rows x k+v x 2 layers x 2 kv heads x 32 x 4 B
    assert te.cache_hbm_bytes() == 2 * 128 * 2 * 2 * 2 * 32 * 4
    cache = te.init_cache()
    assert isinstance(cache, tkv.KVCache)
    assert tuple(cache.k.shape) == (2, 2, 2, 128, 32)
    with pytest.raises(ValueError, match="paged"):
        te.new_allocator()
    with pytest.raises(ValueError, match="dense slot cache"):
        te.prefill(cache, [1, 2, 3], 0, prefill_from=1)


def test_dense_llama_decode_steps_match_jax(llama):
    je, te = llama
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, 256, size=n).tolist() for n in (9, 70)]
    jc, tc = je.init_cache(), te.init_cache()
    last = np.zeros((2,), np.int32)
    for slot, p in enumerate(prompts):
        jc, jt, jlog = je.prefill(jc, p, slot)
        tc, tt, tlog = te.prefill(tc, p, slot)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-4)
        last[slot] = int(tt)
    for _ in range(6):
        jc, jt, jlog, _ = je.decode(jc, last)
        tc, tt, tlog, _ = te.decode(tc, last)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-4)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        last = tt.numpy().astype(np.int32)
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), atol=1e-4)
    tc = te.evict_slot(tc, 0)
    assert tc.lengths.tolist() == [0, 76]


def test_dense_llama_generate_matches_jax_and_kernel_branch(llama,
                                                            monkeypatch):
    """``generate`` through the copied scheduler on the dense engine
    (no allocator); then the same with the decode crossover at 0, so
    every decode layer takes ``decode_attention``'s masked flash branch
    (its plain version on the CPU): the same tokens."""
    je, te = llama
    rng = np.random.RandomState(2)
    prompts = [rng.randint(0, 256, size=n).tolist() for n in (5, 17, 40)]
    want = [[int(t) for t in o]
            for o in je.generate(prompts, max_new_tokens=6)]
    assert te.generate(prompts, max_new_tokens=6) == want
    monkeypatch.setenv("APEX_TPU_DECODE_XLA_MAX_SEQ", "0")
    assert te.generate(prompts, max_new_tokens=6) == want
