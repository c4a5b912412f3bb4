"""GPT serving on the port against the JAX package (CPU, fp32).

Config: 2 layers, hidden 128, 4 heads of 32, ffn 256, vocab 256,
max_seq 128, no dropout; page 16 for the paged engines.  The same
seeded JAX ``model.init`` tree goes to both packages (numpy in
between).  The JAX engines run their Pallas kernels in interpret mode
(the paged kernel forced with ``paged_attn_max_pages=0``; the dense
engine's ``decode_attention`` takes its plain chain below the 4096
crossover, as the port's does); every cache is fp32.  Tolerance for
logits, k and v: 1e-4 absolute — fp32 on both sides, differing in
reduction order (blockwise online softmax against one pass, XLA
against PyTorch matmuls) over two layers.  Greedy tokens must be
equal.

Then the fused GPT block (``kind="gpt"``) against the JAX Pallas
kernel in interpret mode, fp32 and bf16, with and without the MLP
(fp32 within 1e-5; bf16 within 2^-6 of the output's magnitude, as
``test_torch_decode_fusion.py`` states), a 2-layer fused GPT engine
step-locked against the JAX fused engine, and ``GPTModel``'s logits,
loss and masked forward against the flax model's.  The suffix path
(prefix hits, chunked prefill) runs through the copied scheduler on
both paged engines.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.inference import InferenceEngine as JaxEngine
from apex_tpu.inference import SlotScheduler as JaxScheduler
from apex_tpu.inference import models as jmodels
from apex_tpu.observability import MetricsRegistry as JaxRegistry
from apex_tpu.observability import ServeTelemetry as JaxTelemetry
from apex_tpu.ops import paged_attention as jpa
from apex_tpu.transformer import parallel_state
from apex_tpu.transformer.testing import GPTConfig as JaxGPTConfig
from apex_tpu.transformer.testing import gpt_model_provider as jax_gpt
from apex_tpu_torch.inference import (InferenceEngine, SlotScheduler,
                                      params_from_jax)
from apex_tpu_torch.inference import models as tmodels
from apex_tpu_torch.inference.weights import load_jax_params
from apex_tpu_torch.observability import MetricsRegistry, ServeTelemetry
from apex_tpu_torch.ops import _build
from apex_tpu_torch.ops import paged_attention as tpa
from apex_tpu_torch.transformer.testing import GPTConfig, gpt_model_provider

from _torch_isolation import restore_torch_from_amp  # noqa: F401

CFG = dict(vocab_size=256, hidden_size=128, ffn_hidden_size=256,
           num_layers=2, num_attention_heads=4, max_seq_length=128,
           hidden_dropout=0.0, attention_dropout=0.0)
PAGED = dict(slots=2, max_seq=128, page_size=16, num_pages=24)
DENSE = dict(slots=2, max_seq=128)
ATOL = 1e-4


@pytest.fixture(scope="module")
def model():
    parallel_state.destroy_model_parallel()
    parallel_state.initialize_model_parallel(1)
    jcfg = JaxGPTConfig(**CFG)
    jparams = jax_gpt(jcfg).init(jax.random.PRNGKey(0),
                                 jnp.zeros((1, 4), jnp.int32))
    # nonzero biases and norm affines, so every bias add is exercised
    rng = np.random.RandomState(11)
    jparams = jax.tree_util.tree_map_with_path(
        lambda path, a: (a + 0.1 * rng.randn(*a.shape).astype(np.float32)
                         if path[-1].key in ("bias",) or "layernorm"
                         in str(path) else a), jparams)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    cfg = GPTConfig(**CFG)
    tparams = params_from_jax("gpt", cfg, tree, device="cpu")
    return jcfg, jparams, cfg, tparams, tree


def _engines(model, geometry, **kw):
    jcfg, jparams, cfg, tparams, _ = model
    jkw = dict(paged_attn_max_pages=0) if "page_size" in geometry else {}
    je = JaxEngine("gpt", jcfg, jparams, cache_dtype=jnp.float32,
                   **geometry, **jkw, **kw)
    te = InferenceEngine("gpt", cfg, tparams, cache_dtype=torch.float32,
                         device="cpu", **geometry, **kw)
    return je, te


def _prompts(seed, lens):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, CFG["vocab_size"], size=n).tolist() for n in lens]


def test_params_from_jax_keeps_gpt_paths_values_and_checks_shapes(model):
    _, jparams, cfg, tparams, tree = model
    flat_j = jax.tree_util.tree_flatten_with_path(jparams)[0]
    assert len(flat_j) == 4 + 12 * CFG["num_layers"]
    for path, leaf in flat_j:
        node = tparams
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    with pytest.raises(ValueError, match="shape"):
        params_from_jax("gpt", GPTConfig(**dict(CFG, ffn_hidden_size=64)),
                        tree, device="cpu")
    bad = jax.tree_util.tree_map(lambda a: a, tree)
    del bad["params"]["layer_1"]["mlp"]["dense_4h_to_h"]["bias"]
    with pytest.raises(ValueError, match="lacks"):
        params_from_jax("gpt", cfg, bad, device="cpu")


@pytest.mark.parametrize("n", [1, 64])
def test_gpt_prefill_logits_and_kv_match_jax(model, n):
    jcfg, jparams, cfg, tparams, _ = model
    toks = np.asarray(_prompts(n, [n])[0], np.int32)[None]
    fwd = jax.jit(jmodels.prefill_forward, static_argnums=(0, 1))
    jl, jk, jv = fwd("gpt", jcfg, jparams, jnp.asarray(toks))
    tl, tk, tv = tmodels.prefill_forward("gpt", cfg, tparams,
                                         torch.from_numpy(toks))
    for got, ref in ((tl, jl), (tk, jk), (tv, jv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)
    jl, _, _ = fwd("gpt", jcfg, jparams, jnp.asarray(toks), n)
    tl, _, _ = tmodels.prefill_forward("gpt", cfg, tparams,
                                       torch.from_numpy(toks), n)
    assert tuple(tl.shape) == (1, CFG["vocab_size"])
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)


@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_gpt_greedy_decode_steps_match_jax_engine(model, layout):
    """Two slots prefilled, then 8 batched greedy decode steps on the
    paged pool or the dense slot cache: logits within tolerance at every
    step, tokens equal, lengths equal."""
    je, te = _engines(model, PAGED if layout == "paged" else DENSE)
    assert te.paged == je.paged == (layout == "paged")
    prompts = _prompts(1, [9, 30])
    jc, tc = je.init_cache(), te.init_cache()
    last = np.zeros((2,), np.int32)
    for slot, p in enumerate(prompts):
        kw_j = kw_t = {}
        if layout == "paged":
            need = -(-(len(p) + 8) // 16)
            kw_j = dict(pages=list(range(slot * 4, slot * 4 + need)))
            kw_t = kw_j
        jc, jt, jlog = je.prefill(jc, p, slot, **kw_j)
        tc, tt, tlog = te.prefill(tc, p, slot, **kw_t)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=ATOL)
        assert int(tt) == int(jt)
        last[slot] = int(tt)
    for _ in range(8):
        jc, jt, jlog, jtr = je.decode(jc, last)
        tc, tt, tlog, ttr = te.decode(tc, last)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=ATOL)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        assert not ttr.any() and not np.asarray(jtr).any()
        last = tt.numpy().astype(np.int32)
    np.testing.assert_array_equal(tc.lengths.numpy(), np.asarray(jc.lengths))
    if layout == "dense":
        np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), atol=ATOL)


@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_gpt_generate_matches_jax_engine(model, layout):
    je, te = _engines(model, PAGED if layout == "paged" else DENSE)
    prompts = _prompts(2, [5, 17, 40])     # 3 requests over 2 slots
    assert te.generate(prompts, max_new_tokens=6) == [
        [int(t) for t in o] for o in je.generate(prompts, max_new_tokens=6)]


def test_gpt_prefix_hit_and_chunked_prefill_match_jax(model):
    """The copied SlotScheduler over both paged GPT engines: a second
    wave extends the first wave's prompt (a prefix hit, resumed mid-page
    after a COW) or repeats it, every prefill in 32-token chunks — the
    warm path of ``_gpt_prefill`` (learned positions from the slab's
    absolute offset, attention to the cached prefix window)."""
    je, te = _engines(model, PAGED)
    base = _prompts(6, [45])[0]
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
    assert ttel.prefill_chunks.total() == jtel.prefill_chunks.total() > 0


def test_gpt_dense_slot_at_capacity_is_truncated_not_a_crash(model):
    """A dense slot whose prompt fills max_seq: its first decode step
    reads the last position row and writes the clamped last cache row,
    and the slot comes back flagged ``truncated`` with its length held at
    capacity; the other slot's logits still match the JAX engine's."""
    je, te = _engines(model, DENSE)
    full, short = _prompts(3, [128, 10])
    jc, tc = je.init_cache(), te.init_cache()
    last = np.zeros((2,), np.int32)
    for slot, p in enumerate((full, short)):
        jc, jt, _ = je.prefill(jc, p, slot)
        tc, tt, _ = te.prefill(tc, p, slot)
        last[slot] = int(tt)
    jc, _, jlog, jtr = je.decode(jc, last)
    tc, _, tlog, ttr = te.decode(tc, last)
    assert ttr.tolist() == [True, False] == np.asarray(jtr).tolist()
    assert tc.lengths.tolist() == [128, 11]
    assert torch.isfinite(tlog[0]).all()
    np.testing.assert_allclose(tlog[1].numpy(), np.asarray(jlog)[1],
                               atol=ATOL)


def _gpt_block(seed, fuse_mlp):
    """A random GPT layer in the fused layout (numpy fp32), a 3-layer
    pool of page 8 (4 pages a slot), lengths 0, 5, 8 and 23."""
    rng = np.random.RandomState(seed)
    hidden, h, d, ffn, ps, mpps, lengths = 64, 4, 16, 96, 8, 4, \
        [0, 5, 8, 23]

    def lin(i, o):
        return (rng.randn(i, o) / np.sqrt(i)).astype(np.float32)

    def vec(n, base=0.0):
        return (base + 0.1 * rng.randn(1, n)).astype(np.float32)

    blk = {"ln1_w": vec(hidden, 1.0), "ln1_b": vec(hidden),
           "wq": lin(hidden, h * d), "bq": vec(h * d),
           "wk": lin(hidden, h * d), "bk": vec(h * d),
           "wv": lin(hidden, h * d), "bv": vec(h * d),
           "wo": lin(h * d, hidden), "bo": vec(hidden),
           "ln2_w": vec(hidden, 1.0), "ln2_b": vec(hidden),
           "wu": lin(hidden, ffn), "bu": vec(ffn),
           "wd": lin(ffn, hidden), "bd": vec(hidden)}
    slots = len(lengths)
    n_pages = slots * mpps
    pool_k = rng.randn(n_pages + 1, 3, h, ps, d).astype(np.float32)
    pool_v = rng.randn(n_pages + 1, 3, h, ps, d).astype(np.float32)
    table = np.full((slots, mpps), n_pages, np.int32)
    perm, cursor = rng.permutation(n_pages), 0
    for s, n in enumerate(lengths):
        need = -(-n // ps)
        table[s, :need] = perm[cursor:cursor + need]
        cursor += need
    x = rng.randn(slots, hidden).astype(np.float32)
    return x, blk, pool_k, pool_v, table, np.asarray(lengths, np.int32)


@pytest.mark.parametrize("fuse_mlp", [True, False], ids=["mlp", "attn"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_gpt_block_matches_jax_kernel(fuse_mlp, dtype):
    x, blk, pk, pv, table, lengths = _gpt_block(3, fuse_mlp)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    layer = 1
    ref = jpa.fused_block_decode(
        jnp.asarray(x, jd), {k: jnp.asarray(v, jd) for k, v in blk.items()},
        jnp.asarray(pk[:, layer], jd), jnp.asarray(pv[:, layer], jd),
        jnp.asarray(table), jnp.asarray(lengths), kind="gpt", eps=1e-5,
        fuse_mlp=fuse_mlp)
    tk = torch.from_numpy(pk).to(td)
    tv = torch.from_numpy(pv).to(td)
    _build.reset_launch_counts()
    got = tpa.fused_block_decode(
        torch.from_numpy(x).to(td),
        {k: torch.from_numpy(v).to(td) for k, v in blk.items()},
        tk[:, layer], tv[:, layer], torch.from_numpy(table),
        torch.from_numpy(lengths), kind="gpt", eps=1e-5, fuse_mlp=fuse_mlp)
    assert not any(_build.launch_counts().values())
    for name, g, r in zip(("y", "k_tok", "v_tok"), got, ref):
        r = np.asarray(r.astype(jnp.float32))
        assert g.dtype == td and tuple(g.shape) == r.shape, name
        tol = 1e-5 if dtype == "float32" else 2.0 ** -6 * np.abs(r).max()
        np.testing.assert_allclose(g.float().numpy(), r, rtol=0, atol=tol,
                                   err_msg=name)


def test_gpt_fused_layout_matches_jax(model):
    jcfg, jparams, cfg, tparams, _ = model
    jl = jmodels.fused_layer_params("gpt", jcfg, jparams)
    tl = tmodels.fused_layer_params("gpt", cfg, tparams)
    assert len(tl) == len(jl) == CFG["num_layers"]
    for jb, tb in zip(jl, tl):
        assert sorted(jb) == sorted(tb)
        for k in jb:
            assert tb[k].is_contiguous(), k
            np.testing.assert_array_equal(tb[k].numpy(),
                                          np.asarray(jb[k], np.float32),
                                          err_msg=k)


def test_fused_gpt_engine_matches_jax_fused_engine(model):
    """A 2-layer fused GPT engine (``decode_fusion="1"``) step-locked
    against the JAX fused engine over four decode steps, and against
    the port's own unfused engine; no kernel launches on the CPU."""
    je, te = _engines(model, PAGED, decode_fusion="1")
    _, un = _engines(model, PAGED)
    assert te.decode_fused and je.decode_fused and not un.decode_fused
    prompts = _prompts(5, [12, 33])
    jc, tc, uc = je.init_cache(), te.init_cache(), un.init_cache()
    last = np.zeros((2,), np.int32)
    _build.reset_launch_counts()
    for slot, p in enumerate(prompts):
        pages = list(range(slot * 4, slot * 4 + 4))
        jc, jt, _ = je.prefill(jc, p, slot, pages=pages)
        tc, tt, _ = te.prefill(tc, p, slot, pages=pages)
        uc, _, _ = un.prefill(uc, p, slot, pages=pages)
        assert int(tt) == int(jt)
        last[slot] = int(tt)
    for _ in range(4):
        jc, jt, jlog, _ = je.decode(jc, last)
        tc, tt, tlog, _ = te.decode(tc, last)
        uc, _, ulog, _ = un.decode(uc, last)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=ATOL)
        np.testing.assert_allclose(tlog.numpy(), ulog.numpy(), atol=ATOL)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        last = tt.numpy().astype(np.int32)
    assert not any(_build.launch_counts().values())


def test_gpt_model_logits_loss_and_mask_match_jax(model):
    """``GPTModel`` loaded with the JAX tree: logits ``[s, b, vocab]``,
    the mean cross entropy with labels, and a forward with a padding-like
    boolean mask, each against the flax model's; the meta-device model
    run over the tree with ``functional_call`` gives the same logits."""
    jcfg, jparams, cfg, tparams, tree = model
    tm = gpt_model_provider(cfg, device="cpu")
    load_jax_params(tm, tree)
    jm = jax_gpt(jcfg)
    rng = np.random.RandomState(7)
    toks = rng.randint(0, CFG["vocab_size"], size=(2, 24)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    mask = np.zeros((2, 1, 24, 24), bool)
    mask[1, :, :, 20:] = True                     # batch 1: last 4 padded
    tt = torch.from_numpy(toks)
    with torch.no_grad():
        np.testing.assert_allclose(
            tm(tt).numpy(), np.asarray(jm.apply(jparams, toks)), atol=ATOL)
        np.testing.assert_allclose(
            tm(tt, torch.from_numpy(labels)).item(),
            float(jm.apply(jparams, toks, labels)), atol=ATOL)
        np.testing.assert_allclose(
            tm(tt, attention_mask=torch.from_numpy(mask)).numpy(),
            np.asarray(jm.apply(jparams, toks, attention_mask=mask)),
            atol=ATOL)
        meta = gpt_model_provider(cfg, device="meta")
        state = {n: t for n, t in tm.named_parameters()}
        np.testing.assert_allclose(
            torch.func.functional_call(meta, state, (tt,)).numpy(),
            tm(tt).numpy(), atol=0)


def test_gpt_model_out_of_slice_options_raise(model):
    """Training-mode dropout runs now (a finite loss that follows the
    generator's seed; no generator raises ValueError); remat, the fused
    head and scan_layers (with or without remat, on the same weights
    moved to its layout) run; the MoE FFN builds and trains now (its
    aux losses handed back), and serving it is refused, as in JAX."""
    _, _, cfg, _, _ = model
    drop = gpt_model_provider(GPTConfig(**dict(CFG, hidden_dropout=0.1)),
                              device="cpu")
    toks = torch.arange(8, dtype=torch.int32)[None]
    with torch.no_grad():
        losses = [drop(toks, toks, deterministic=False,
                       generator=torch.Generator().manual_seed(s)).item()
                  for s in (0, 0, 1)]
    assert np.isfinite(losses).all() and losses[0] == losses[1] != losses[2]
    with pytest.raises(ValueError, match="generator"):
        drop(torch.zeros(1, 4, dtype=torch.int32), deterministic=False)
    moe_cfg = GPTConfig(**dict(CFG, num_moe_experts=4))
    moe = gpt_model_provider(moe_cfg, device="cpu")
    assert moe.layer_0.mlp.router.weight.shape == (4, CFG["hidden_size"])
    inter = {}
    with torch.no_grad():
        assert np.isfinite(moe(toks, toks, intermediates=inter).item())
    assert len(inter) == 2 * CFG["num_layers"]
    from apex_tpu_torch.inference.models import check_supported
    with pytest.raises(ValueError, match="MoE FFN decode"):
        check_supported("gpt", moe_cfg)
    from apex_tpu_torch.inference.weights import to_scan_layout
    loop = {n: p.detach() for n, p in drop.named_parameters()}
    tree: dict = {}
    for name, t in loop.items():
        node = tree
        *path, leaf = name.split(".")
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = t
    for kw in (dict(scan_layers=True), dict(scan_layers=True, remat=True)):
        sm = gpt_model_provider(GPTConfig(**dict(CFG, hidden_dropout=0.1,
                                                 **kw)), device="cpu")
        load_jax_params(sm, to_scan_layout(tree, CFG["num_layers"]))
        with torch.no_grad():
            assert sm(toks, toks).item() == drop(toks, toks).item()
    # remat and the fused head run now, on the unfused model's weights
    toks = torch.arange(8, dtype=torch.int32)[None]
    with torch.no_grad():
        want = drop(toks, toks)
        for kw in (dict(remat=True), dict(fused_head_xent=3),
                   dict(remat=True, fused_head_xent=3)):
            tm = gpt_model_provider(GPTConfig(**dict(CFG, hidden_dropout=0.1,
                                                     **kw)), device="cpu")
            tm.load_state_dict(drop.state_dict())
            torch.testing.assert_close(tm(toks, toks), want, rtol=0,
                                       atol=1e-5)
