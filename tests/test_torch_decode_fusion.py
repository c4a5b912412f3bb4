"""Fused-block decode on the port against the JAX package (CPU).

The port's ``fused_block_decode`` on CPU tensors (its plain version,
``fused_block_reference``) against the JAX ``fused_block_decode`` (the
Pallas ``_fused_block_kernel`` in interpret mode) on the same seeded
numpy inputs: a toy LLaMA layer (hidden 64, 4 heads of 16 over 4/2/1 kv
heads, ffn 96, page 8), four slots of lengths 0, 5, 8 and 23 (empty, a
partial page, a page boundary, three pages) in one layer of a 3-layer
pool read through its strided view, ``fuse_mlp`` on and off.
Tolerances: fp32 1e-5 absolute (the same fp32 math, sums in another
order: blockwise online softmax against one pass, XLA against PyTorch
matmuls; about 1e-6 is seen at outputs of magnitude 4); bf16 2^-6 of the output's magnitude (the same bf16 rounding
points on both sides, a rounding that lands the other way moves an
element by one bf16 ulp, 2^-8 relative, and its neighbours through the
next product).

Then the fused layout (equal element for element to the JAX one), the
dispatch knobs (the JAX answers for every spelling and precedence), and
a 2-layer fused engine step-locked against the JAX fused engine and the
port's own unfused engine over four decode steps (fp32 weights and
pool: logits within 1e-4, tokens equal outside near-ties), launching no
kernel on the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.inference import InferenceEngine as JaxEngine
from apex_tpu.inference import models as jmodels
from apex_tpu.ops import paged_attention as jpa
from apex_tpu.transformer import parallel_state
from apex_tpu.transformer.testing import LlamaConfig as JaxLlamaConfig
from apex_tpu.transformer.testing import llama_model_provider
from apex_tpu_torch.inference import InferenceEngine, params_from_jax
from apex_tpu_torch.inference import models as tmodels
from apex_tpu_torch.observability import reset_global_registry
from apex_tpu_torch.ops import _build
from apex_tpu_torch.ops import paged_attention as tpa
from apex_tpu_torch.transformer.testing import LlamaConfig
from apex_tpu_torch.transformer.testing.standalone_llama import _rope_cos_sin

from _torch_isolation import restore_torch_from_amp  # noqa: F401

HIDDEN, HEADS, D, FFN, PS, MPPS, LAYERS = 64, 4, 16, 96, 8, 4, 3
LENGTHS = [0, 5, 8, 23]
EPS = 1e-5


def _layer(kvh, seed):
    """A random fused-layout layer, a 3-layer pool, its page table and
    the RoPE rows at each slot's position, all numpy fp32."""
    rng = np.random.RandomState(seed)
    slots = len(LENGTHS)

    def lin(i, o):
        return (rng.randn(i, o) / np.sqrt(i)).astype(np.float32)

    blk = {"ln1_w": (1 + 0.1 * rng.randn(1, HIDDEN)).astype(np.float32),
           "wq": lin(HIDDEN, HEADS * D), "wk": lin(HIDDEN, kvh * D),
           "wv": lin(HIDDEN, kvh * D), "wo": lin(HEADS * D, HIDDEN),
           "ln2_w": (1 + 0.1 * rng.randn(1, HIDDEN)).astype(np.float32),
           "wg": lin(HIDDEN, FFN), "wu": lin(HIDDEN, FFN),
           "wd": lin(FFN, HIDDEN)}
    n_pages = slots * MPPS
    shape = (n_pages + 1, LAYERS, kvh, PS, D)
    pool_k = rng.randn(*shape).astype(np.float32)
    pool_v = rng.randn(*shape).astype(np.float32)
    perm = rng.permutation(n_pages)
    table = np.full((slots, MPPS), n_pages, np.int32)
    cursor = 0
    for s, n in enumerate(LENGTHS):
        need = -(-n // PS)
        table[s, :need] = perm[cursor:cursor + need]
        cursor += need
    x = rng.randn(slots, HIDDEN).astype(np.float32)
    cos_t, sin_t = _rope_cos_sin(MPPS * PS, D, 10000.0)
    pos = np.asarray(LENGTHS)
    cos = cos_t.reshape(-1, D).numpy()[pos]
    sin = sin_t.reshape(-1, D).numpy()[pos]
    return x, blk, pool_k, pool_v, table, np.asarray(LENGTHS, np.int32), \
        cos, sin


@pytest.mark.parametrize("fuse_mlp", [True, False], ids=["mlp", "attn"])
@pytest.mark.parametrize("kvh", [4, 2, 1], ids=["mha", "gqa", "mqa"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_block_matches_jax(kvh, fuse_mlp, dtype):
    x, blk, pk, pv, table, lengths, cos, sin = _layer(kvh, seed=kvh)
    layer = 1
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    ref = jpa.fused_block_decode(
        jnp.asarray(x, jd), {k: jnp.asarray(v, jd) for k, v in blk.items()},
        jnp.asarray(pk[:, layer], jd), jnp.asarray(pv[:, layer], jd),
        jnp.asarray(table), jnp.asarray(lengths), kind="llama", eps=EPS,
        cos=jnp.asarray(cos), sin=jnp.asarray(sin), fuse_mlp=fuse_mlp)
    tk = torch.from_numpy(pk).to(td)
    tv = torch.from_numpy(pv).to(td)
    got = tpa.fused_block_decode(
        torch.from_numpy(x).to(td),
        {k: torch.from_numpy(v).to(td) for k, v in blk.items()},
        tk[:, layer], tv[:, layer], torch.from_numpy(table),
        torch.from_numpy(lengths), kind="llama", eps=EPS,
        cos=torch.from_numpy(cos), sin=torch.from_numpy(sin),
        fuse_mlp=fuse_mlp)
    for name, g, r in zip(("y", "k_tok", "v_tok"), got, ref):
        r = np.asarray(r.astype(jnp.float32))
        assert g.dtype == td and tuple(g.shape) == r.shape, name
        g = g.float().numpy()
        tol = 1e-5 if dtype == "float32" else 2.0 ** -6 * np.abs(r).max()
        np.testing.assert_allclose(g, r, rtol=0, atol=tol, err_msg=name)


def test_fused_block_length_zero_attends_to_the_current_token_alone():
    """A slot of length 0 reads no page: its context is v of the current
    token, so changing every page of the pool leaves its output as is."""
    x, blk, pk, pv, table, lengths, cos, sin = _layer(2, seed=7)
    t = {k: torch.from_numpy(v) for k, v in blk.items()}
    args = (torch.from_numpy(table), torch.from_numpy(lengths))
    kw = dict(kind="llama", eps=EPS, cos=torch.from_numpy(cos),
              sin=torch.from_numpy(sin), fuse_mlp=False)
    a = tpa.fused_block_decode(torch.from_numpy(x), t,
                               torch.from_numpy(pk[:, 0]),
                               torch.from_numpy(pv[:, 0]), *args, **kw)
    b = tpa.fused_block_decode(torch.from_numpy(x), t,
                               torch.from_numpy(pk[:, 2]),
                               torch.from_numpy(pv[:, 2]), *args, **kw)
    assert torch.equal(a[0][0], b[0][0]) and not torch.equal(a[0][1], b[0][1])


@pytest.fixture(scope="module")
def model():
    parallel_state.destroy_model_parallel()
    parallel_state.initialize_model_parallel(1)
    cfg_kw = dict(vocab_size=256, hidden_size=128, num_layers=2,
                  num_attention_heads=4, num_kv_heads=2, ffn_hidden_size=256,
                  max_seq_length=128)
    jcfg = JaxLlamaConfig(**cfg_kw)
    jparams = llama_model_provider(jcfg).init(
        jax.random.PRNGKey(1), jnp.zeros((1, 4), jnp.int32))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    cfg = LlamaConfig(**cfg_kw)
    return jcfg, jparams, cfg, params_from_jax("llama", cfg, tree,
                                               device="cpu")


def test_fused_layer_params_equal_jax(model):
    jcfg, jparams, cfg, tparams = model
    jl = jmodels.fused_layer_params("llama", jcfg, jparams)
    tl = tmodels.fused_layer_params("llama", cfg, tparams)
    assert len(tl) == len(jl) == 2
    for jb, tb in zip(jl, tl):
        assert sorted(tb) == sorted(jb)
        for name in jb:
            assert tb[name].is_contiguous(), name
            np.testing.assert_array_equal(tb[name].numpy(),
                                          np.asarray(jb[name]), err_msg=name)


SPELLINGS = [None, "0", "1", "auto", "true", "false", "on", "off", "ON",
             " Auto ", "", 0, 1, True, False]


@pytest.mark.parametrize("env", [None, "1", "auto", "off"])
def test_decode_fusion_knobs_match_jax(monkeypatch, env):
    if env is None:
        monkeypatch.delenv("APEX_TPU_DECODE_FUSION", raising=False)
    else:
        monkeypatch.setenv("APEX_TPU_DECODE_FUSION", env)
    monkeypatch.delenv("APEX_TPU_FUSION_MIN_PAGES", raising=False)
    for val in SPELLINGS:
        assert tpa.decode_fusion(val) == jpa.decode_fusion(val), val
    for bad in ("maybe", "2"):
        with pytest.raises(ValueError):
            jpa.decode_fusion(bad)
        with pytest.raises(ValueError):
            tpa.decode_fusion(bad)
    assert tpa.fusion_min_pages() == jpa.fusion_min_pages() == 8
    assert tpa.fusion_min_pages(16) == jpa.fusion_min_pages(16) == 16
    monkeypatch.setenv("APEX_TPU_FUSION_MIN_PAGES", "4")
    assert tpa.fusion_min_pages() == jpa.fusion_min_pages() == 4
    for mode in (None, "0", "1", "auto"):
        for max_pages in (None, 3, 4, 64):
            for min_pages in (None, 64):
                kw = dict(paged=True, max_pages=max_pages,
                          min_pages=min_pages)
                assert tpa.resolve_decode_fusion(mode, **kw) == \
                    jpa.resolve_decode_fusion(mode, **kw), (mode, kw)
        if jpa.decode_fusion(mode) == "1":
            for fn in (jpa.resolve_decode_fusion, tpa.resolve_decode_fusion):
                with pytest.raises(ValueError, match="paged engine"):
                    fn(mode, paged=False)
        else:
            assert tpa.resolve_decode_fusion(mode, paged=False) is \
                jpa.resolve_decode_fusion(mode, paged=False) is False
    monkeypatch.setenv("APEX_TPU_FUSION_MIN_PAGES", "x")
    with pytest.raises(ValueError, match="APEX_TPU_FUSION_MIN_PAGES"):
        tpa.fusion_min_pages()


def test_engine_resolves_fusion_once(model, monkeypatch):
    _, _, cfg, tparams = model
    monkeypatch.delenv("APEX_TPU_DECODE_FUSION", raising=False)
    kw = dict(slots=2, max_seq=128, page_size=16, device="cpu")
    assert not InferenceEngine("llama", cfg, tparams, **kw).decode_fused
    # auto: 128 / 16 = 8 pages a slot, fused at the default crossover
    auto = InferenceEngine("llama", cfg, tparams, decode_fusion="auto", **kw)
    assert auto.decode_fused and len(auto._fused_layers) == 2
    assert not InferenceEngine("llama", cfg, tparams, decode_fusion="auto",
                               fusion_min_pages=9, **kw).decode_fused
    monkeypatch.setenv("APEX_TPU_DECODE_FUSION", "1")
    assert InferenceEngine("llama", cfg, tparams, **kw).decode_fused
    assert not InferenceEngine("llama", cfg, tparams, decode_fusion="0",
                               **kw).decode_fused


ENGINE = dict(slots=2, max_seq=128, page_size=16, num_pages=24)


def _prefilled(engine, prompts):
    cache, alloc = engine.init_cache(), engine.new_allocator()
    last = np.zeros((engine.slots,), np.int32)
    for slot, p in enumerate(prompts):
        pages = alloc.acquire(alloc.pages_needed(len(p) + 8))
        cache, tok, _ = engine.prefill(cache, p, slot, pages=pages)
        last[slot] = int(tok)
    return cache, last


def test_fused_engine_step_locked_against_jax_and_unfused(model):
    """Four decode steps of the fused 2-layer engine against the JAX
    fused engine and the port's unfused engine, every engine fed the
    JAX engine's tokens; the CPU run launches no kernel."""
    jcfg, jparams, cfg, tparams = model
    _build.reset_launch_counts()
    reg = reset_global_registry()
    je = JaxEngine("llama", jcfg, jparams, cache_dtype=jnp.float32,
                   decode_fusion="1", **ENGINE)
    tf = InferenceEngine("llama", cfg, tparams, cache_dtype=torch.float32,
                         device="cpu", decode_fusion="1", **ENGINE)
    tu = InferenceEngine("llama", cfg, tparams, cache_dtype=torch.float32,
                         device="cpu", **ENGINE)
    assert je.decode_fused and tf.decode_fused and not tu.decode_fused
    prompts = [list((np.arange(9) * 5) % 256), list((np.arange(30) * 7) % 256)]
    jc, last = _prefilled(je, prompts)
    fc, flast = _prefilled(tf, prompts)
    uc, _ = _prefilled(tu, prompts)
    assert np.array_equal(last, flast)
    for _ in range(4):
        jc, jt, jlog, _ = je.decode(jc, last)
        fc, ft, flog, _ = tf.decode(fc, last)
        uc, _, ulog, _ = tu.decode(uc, last)
        jlog = np.asarray(jlog)
        np.testing.assert_allclose(flog.numpy(), jlog, rtol=0, atol=1e-4)
        np.testing.assert_allclose(flog.numpy(), ulog.numpy(), rtol=0,
                                   atol=1e-4)
        for s in range(2):
            top2 = np.sort(jlog[s])[-2:]
            if top2[1] - top2[0] > 1e-3:        # not a near-tie
                assert int(ft[s]) == int(np.asarray(jt)[s])
        last = np.array(jt, np.int32)            # one stream for all three
    np.testing.assert_array_equal(fc.lengths.numpy(), np.asarray(jc.lengths))
    np.testing.assert_allclose(fc.k.numpy(), np.asarray(jc.k), rtol=0,
                               atol=1e-4)
    assert reg.declared("infer_decode_fused_dispatch_total").total() == 4
    assert reg.declared("infer_decode_dispatch_total").total() == 8
    assert all(v == 0 for v in _build.launch_counts().values())
    assert _build._LIB is None


def test_fused_engine_generate_equals_unfused(model):
    _, _, cfg, tparams = model
    prompts = [list((np.arange(n) * 3 + n) % 256) for n in (5, 17, 40)]
    outs = [InferenceEngine("llama", cfg, tparams, cache_dtype=torch.float32,
                            device="cpu", decode_fusion=mode,
                            **ENGINE).generate(prompts, max_new_tokens=6)
            for mode in ("0", "1")]
    assert outs[0] == outs[1]
