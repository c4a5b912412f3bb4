"""Port parity for the train-to-serve boundary: ``export_params``,
``train_step.leaf_offsets`` and ``InferenceEngine.from_train_state`` /
``from_state_dict``, against the JAX package on the same numpy inputs
(CPU, fp32).

The model is the training slice's tiny LLaMA (hidden 128, 4 heads over
2 kv heads, 2 layers, vocab 256, sequence 64, batch 2), trained three
``make_train_step`` steps in each package from one JAX init, then
served by each package's paged engine (page 16; the JAX engine's paged
kernel in interpret mode, forced with ``paged_attn_max_pages=0``), fp32
weights and cache on both sides.

Tolerances: ``export_params`` and ``leaf_offsets`` exactly (a slice and
casts of the same values); the engines' decode logits within 1e-4
absolute, the serving slice's tolerance (fp32 on both sides, two layers
of reduction-order differences) — the trained masters agree to ~1e-6,
which moves logits of order 1 by far less; greedy tokens equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import train_step as jtrain
from apex_tpu.inference import InferenceEngine as JaxEngine
from apex_tpu.optimizers import functional as jfunctional
from apex_tpu.transformer.testing import LlamaConfig as JaxLlamaConfig
from apex_tpu_torch import train_step as ttrain
from apex_tpu_torch.inference import InferenceEngine
from apex_tpu_torch.optimizers import functional as tfunctional
from apex_tpu_torch.transformer.testing import LlamaConfig

from _torch_isolation import restore_torch_from_amp  # noqa: F401
# the training slice's tiny LLaMA, its JAX init tree and batch
from test_torch_training import (CFG, LR, _jax_loss, _t,  # noqa: F401
                                 _torch_model, llama)

ENGINE = dict(slots=2, max_seq=64, page_size=16, num_pages=16)
ATOL = 1e-4
NEW_TOKENS = 8


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _mixed_tree(seed):
    rng = np.random.RandomState(seed)
    return {"b": {"w": rng.randn(6, 5).astype(np.float32),
                  "n": rng.randn(5).astype(np.float32)},
            "a": [rng.randn(3).astype(np.float32),
                  rng.randn(2, 2).astype(np.float32)],
            "s": np.float32(rng.randn())}


def _sides(tree, dtypes):
    """The tree on each side: (jax, torch), leaves cast per ``dtypes``
    (a function of the numpy leaf's shape)."""
    jt = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a).astype(dtypes(np.shape(a))), tree)

    def to_t(node):
        if isinstance(node, dict):
            return {k: to_t(v) for k, v in node.items()}
        if isinstance(node, list):
            return [to_t(v) for v in node]
        return torch.from_numpy(_np(node).copy()).to(
            getattr(torch, jnp.dtype(node.dtype).name))

    return jt, to_t(jt)


def _leaves(tree):
    return jax.tree_util.tree_leaves(tree, is_leaf=lambda x: isinstance(
        x, torch.Tensor))


def _half_2d(shape):
    return jnp.bfloat16 if len(shape) == 2 else jnp.float32


@pytest.mark.parametrize("pad", [0, 7])
@pytest.mark.parametrize("dtype", [None, "bfloat16", "float32"])
def test_export_params_matches_jax(pad, dtype):
    jt, tt = _sides(_mixed_tree(0), _half_2d)
    n = sum(int(np.size(a)) for a in _leaves(jt))
    flat = np.random.RandomState(1).randn(n + pad).astype(np.float32)
    want = jfunctional.export_params(
        jnp.asarray(flat), jt, dtype=None if dtype is None else getattr(
            jnp, dtype))
    got = tfunctional.export_params(
        torch.from_numpy(flat), tt, dtype=None if dtype is None else getattr(
            torch, dtype))
    assert jax.tree_util.tree_structure(want) == \
        jax.tree_util.tree_structure(got, is_leaf=lambda x: isinstance(
            x, torch.Tensor))
    for g, w in zip(_leaves(got), _leaves(want)):
        assert str(g.dtype).split(".")[-1] == jnp.dtype(w.dtype).name
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_array_equal(_np(g), _np(w))


def test_export_params_refuses_a_short_buffer_as_jax_does():
    jt, tt = _sides(_mixed_tree(0), _half_2d)
    n = sum(int(np.size(a)) for a in _leaves(jt))
    with pytest.raises(ValueError, match="elements < the template"):
        jfunctional.export_params(jnp.zeros(n - 1), jt)
    with pytest.raises(ValueError, match="elements < the template"):
        tfunctional.export_params(torch.zeros(n - 1), tt)


def test_export_params_takes_the_model_as_template(llama):
    _, tree, _, _ = llama
    model = _torch_model(tree)
    flat = np.random.RandomState(2).randn(
        sum(p.numel() for p in model.parameters()) + 3).astype(np.float32)
    want = jfunctional.export_params(jnp.asarray(flat), tree)
    got = tfunctional.export_params(torch.from_numpy(flat), model)
    for (path, w) in jax.tree_util.tree_flatten_with_path(want)[0]:
        node = got
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(_np(node), _np(w))


def test_leaf_offsets_match_jax(llama):
    _, tree, _, _ = llama
    jt, tt = _sides(_mixed_tree(3), _half_2d)
    assert ttrain.leaf_offsets(tt) == jtrain.leaf_offsets(jt)
    want = jtrain.leaf_offsets(tree)
    assert ttrain.leaf_offsets(_torch_model(tree)) == want
    assert list(want)[0] == "['embed_tokens']['weight']"
    # the flat master's slices are the leaves
    model = _torch_model(tree)
    state = ttrain.init_train_state(tfunctional.fused_adam(), model)
    off, size, shape = ttrain.leaf_offsets(model)[
        "['layer_1']['attention']['kv_proj']['weight']"]
    np.testing.assert_array_equal(
        _np(state.opt.master[off:off + size].reshape(shape)),
        tree["layer_1"]["attention"]["kv_proj"]["weight"])


@pytest.fixture(scope="module")
def trained(llama):
    """Three make_train_step steps (fused_adam, dynamic loss scale) of
    the tiny LLaMA in each package from one JAX init."""
    jmodel, tree, tokens, labels = llama
    jtx = jfunctional.fused_adam(lr=LR)
    jstate = jtrain.init_train_state(jtx, tree, loss_scale="dynamic")
    jstep = jax.jit(jtrain.make_train_step(_jax_loss(jmodel), jtx))
    ttx = tfunctional.fused_adam(lr=LR)
    model = _torch_model(tree)
    tstate = ttrain.init_train_state(ttx, model, loss_scale="dynamic")
    tstep = ttrain.make_train_step(
        lambda m, b: m(b["tokens"], b["labels"]), ttx)
    jb = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    tb = {"tokens": _t(tokens), "labels": _t(labels)}
    for _ in range(3):
        jstate, _ = jstep(jstate, jb)
        tstate, _ = tstep(tstate, tb)
    return jstate, tstate, model


def _engines(trained):
    jstate, tstate, _ = trained
    je = JaxEngine.from_train_state(
        "llama", JaxLlamaConfig(**CFG), jstate, dtype=jnp.float32,
        cache_dtype=jnp.float32, paged_attn_max_pages=0, **ENGINE)
    te = InferenceEngine.from_train_state(
        "llama", LlamaConfig(**CFG), tstate, dtype=torch.float32,
        cache_dtype=torch.float32, device="cpu", **ENGINE)
    return je, te


def _prompts():
    rng = np.random.RandomState(11)
    return [rng.randint(0, CFG["vocab_size"], size=n).tolist()
            for n in (9, 30)]


def test_trained_masters_agree(trained):
    jstate, tstate, _ = trained
    diff = np.abs(_np(tstate.opt.master) - _np(jstate.opt.master))
    # the training slice's rule for Adam masters (test_torch_training)
    assert diff.max() <= 2 * LR * 3
    assert np.mean(diff > 1e-5) <= 1e-3


def test_engines_from_train_state_decode_alike(trained):
    je, te = _engines(trained)
    prompts = _prompts()
    jc, tc = je.init_cache(), te.init_cache()
    ja, ta = je.new_allocator(), te.new_allocator()
    last = np.zeros((2,), np.int32)
    for slot, p in enumerate(prompts):
        jpages = ja.acquire(ja.pages_needed(len(p) + NEW_TOKENS))
        tpages = ta.acquire(ta.pages_needed(len(p) + NEW_TOKENS))
        jc, jtok, jl = je.prefill(jc, jnp.asarray(p, jnp.int32), slot,
                                  pages=jpages)
        tc, ttok, tl = te.prefill(tc, p, slot, pages=tpages)
        np.testing.assert_allclose(_np(tl), _np(jl), atol=ATOL)
        assert int(ttok) == int(jtok)
        last[slot] = int(ttok)
    active = np.ones((2,), bool)
    for _ in range(NEW_TOKENS):
        jc, jtoks, jlog, _ = je.decode(jc, jnp.asarray(last), jnp.asarray(
            active))
        tc, ttoks, tlog, _ = te.decode(tc, last, active)
        np.testing.assert_allclose(_np(tlog), _np(jlog), atol=ATOL)
        assert ttoks.tolist() == np.asarray(jtoks).tolist()
        last = np.asarray(ttoks, np.int32)


def test_from_train_state_defaults_to_bf16_and_takes_a_flat_state(trained):
    _, tstate, _ = trained
    cfg = LlamaConfig(**CFG)
    e = InferenceEngine.from_train_state("llama", cfg, tstate, device="cpu",
                                         **ENGINE)
    assert e.params["layer_0"]["mlp"]["up_proj"]["weight"].dtype == \
        torch.bfloat16
    bare = InferenceEngine.from_train_state("llama", cfg, tstate.opt,
                                            device="cpu", **ENGINE)
    for a, b in zip(_leaves(e.params), _leaves(bare.params)):
        assert torch.equal(a, b)


def test_from_state_dict_is_the_engine_from_train_state(trained):
    _, tstate, model = trained
    cfg = LlamaConfig(**CFG)
    kw = dict(dtype=torch.float32, cache_dtype=torch.float32, device="cpu",
              **ENGINE)
    a = InferenceEngine.from_train_state("llama", cfg, tstate, **kw)
    b = InferenceEngine.from_state_dict(
        "llama", cfg, {"master": tstate.opt.master}, model, **kw)
    la, lb = _leaves(a.params), _leaves(b.params)
    assert len(la) == len(lb) == 3 + 8 * CFG["num_layers"]
    for x, y in zip(la, lb):
        assert torch.equal(x, y)
    prompts = _prompts()
    assert a.generate(prompts, max_new_tokens=NEW_TOKENS) == \
        b.generate(prompts, max_new_tokens=NEW_TOKENS)
