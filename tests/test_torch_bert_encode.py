"""BERT's encode-only path on the port against the JAX package (CPU,
fp32).

Config: 2 layers, hidden 128, 4 heads of 32, ffn 512, vocab 256,
max_seq 64, no dropout.  The same seeded flax ``init`` tree (with the
token-type table, the pooler and the NSP head) goes to both packages.
``InferenceEngine("bert", ...).encode`` returns ``(lm_logits [s, b,
vocab], None)`` as the JAX engine does; ``BertModel`` with a padding
mask (the flash kernels' boolean mask, rows whose keys are all padding
included) and with labels is held against the flax model.  Tolerance:
1e-4 absolute (fp32 on both sides, another reduction order over two
layers, the GELU of the MLM head in the tanh approximation on both).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.inference import InferenceEngine as JaxEngine
from apex_tpu.transformer import parallel_state
from apex_tpu.transformer.testing import BertConfig as JaxBertConfig
from apex_tpu.transformer.testing import bert_model_provider as jax_bert
from apex_tpu_torch.inference import InferenceEngine, params_from_jax
from apex_tpu_torch.inference.weights import bert_param_shapes, load_jax_params
from apex_tpu_torch.ops import _build
from apex_tpu_torch.transformer.testing import BertConfig, bert_model_provider

from _torch_isolation import restore_torch_from_amp  # noqa: F401

CFG = dict(vocab_size=256, hidden_size=128, num_layers=2,
           num_attention_heads=4, max_seq_length=64, hidden_dropout=0.0,
           attention_dropout=0.0)
ATOL = 1e-4


@pytest.fixture(scope="module")
def model():
    parallel_state.destroy_model_parallel()
    parallel_state.initialize_model_parallel(1)
    jcfg = JaxBertConfig(**CFG)
    z = jnp.zeros((1, 8), jnp.int32)
    jparams = jax_bert(jcfg).init(jax.random.PRNGKey(0), z, z)
    rng = np.random.RandomState(4)
    jparams = jax.tree_util.tree_map_with_path(
        lambda path, a: (a + 0.1 * rng.randn(*a.shape).astype(np.float32)
                         if path[-1].key == "bias" else a), jparams)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    cfg = BertConfig(**CFG)
    return jcfg, jparams, cfg, tree


def _tokens(seed, b=2, s=40):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, CFG["vocab_size"], size=(b, s)).astype(np.int32),
            rng.randint(0, 2, size=(b, s)).astype(np.int32))


def test_bert_param_shapes_cover_the_flax_tree(model):
    _, jparams, cfg, tree = model
    flat = {tuple(k.key for k in path): np.asarray(leaf).shape for path, leaf
            in jax.tree_util.tree_flatten_with_path(jparams["params"])[0]}
    assert flat == bert_param_shapes(cfg, binary_head=True)
    tparams = params_from_jax("bert", cfg, tree, device="cpu")
    np.testing.assert_array_equal(
        tparams["params"]["lm_head_dense"]["kernel"].numpy(),
        tree["params"]["lm_head_dense"]["kernel"])
    with pytest.raises(ValueError, match="shape"):
        params_from_jax("bert", BertConfig(**dict(CFG, num_token_types=3)),
                        tree, device="cpu")


@pytest.mark.parametrize("types", [False, True], ids=["zeros", "given"])
def test_engine_encode_matches_jax(model, types):
    jcfg, jparams, cfg, tree = model
    je = JaxEngine("bert", jcfg, jparams)
    te = InferenceEngine("bert", cfg, params_from_jax("bert", cfg, tree,
                                                      device="cpu"),
                         device="cpu")
    toks, tt = _tokens(1)
    _build.reset_launch_counts()
    jl, jb = je.encode(toks, tt if types else None)
    tl, tb = te.encode(toks, tt if types else None)
    assert jb is None and tb is None
    assert tuple(tl.shape) == (40, 2, CFG["vocab_size"])
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    assert not any(_build.launch_counts().values())


def test_bert_model_with_padding_mask_and_labels_matches_jax(model):
    """Batch 0 whole, batch 1 with its last 15 positions padded (their
    rows still attend to the 25 live keys), and a batch whose only live
    key is the first; then the MLM loss weighted by the mask."""
    jcfg, jparams, cfg, tree = model
    tm = bert_model_provider(cfg, device="cpu")
    load_jax_params(tm, tree)
    jm = jax_bert(jcfg)
    toks, tt = _tokens(2, b=3)
    keep = np.ones((3, 40), np.int32)
    keep[1, 25:] = 0
    keep[2, 1:] = 0
    labels = np.roll(toks, -1, axis=1)
    jl, jb = jm.apply(jparams, toks, tt, keep)
    with torch.no_grad():
        tl, tb = tm(torch.from_numpy(toks), torch.from_numpy(tt),
                    torch.from_numpy(keep))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
        np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=ATOL)
        jloss, _ = jm.apply(jparams, toks, tt, keep, labels)
        tloss, _ = tm(torch.from_numpy(toks), torch.from_numpy(tt),
                      torch.from_numpy(keep), torch.from_numpy(labels))
        np.testing.assert_allclose(tloss.item(), float(jloss), atol=ATOL)


@pytest.mark.parametrize("kw", [dict(page_size=16), dict(paged=True),
                                dict(decode_fusion="1"), dict(spec_k=2),
                                dict(tp=2)],
                         ids=["page_size", "paged", "fusion", "spec", "tp"])
def test_bert_engine_refuses_generative_kwargs_as_jax_does(model, kw):
    jcfg, jparams, cfg, tree = model
    with pytest.raises(ValueError):
        JaxEngine("bert", jcfg, jparams, **kw)
    with pytest.raises(ValueError):
        InferenceEngine("bert", cfg, params_from_jax("bert", cfg, tree,
                                                     device="cpu"),
                        device="cpu", **kw)


def test_bert_engine_generative_calls_and_training_dropout_raise(model):
    """``decode_fusion="auto"`` (an off spelling on a cache-less engine)
    builds, as in JAX; the generative calls raise ``ValueError`` naming
    ``encode``; dropout in training mode runs (a generator given: a
    finite loss, another seed another loss), and raises without one."""
    _, _, cfg, tree = model
    te = InferenceEngine("bert", cfg, params_from_jax("bert", cfg, tree,
                                                      device="cpu"),
                         device="cpu", decode_fusion="auto")
    with pytest.raises(ValueError, match="encode"):
        te.init_cache()
    with pytest.raises(ValueError, match="encode"):
        te.decode(None, [0])
    drop = bert_model_provider(BertConfig(**dict(CFG, hidden_dropout=0.1)),
                               device="cpu")
    toks = torch.arange(8, dtype=torch.int32)[None] % CFG["vocab_size"]

    def loss(seed):
        with torch.no_grad():
            return drop(toks, lm_labels=toks, deterministic=False,
                        generator=torch.Generator().manual_seed(seed))[0]

    assert bool(torch.isfinite(loss(0))) and loss(0) != loss(1)
    with pytest.raises(ValueError, match="generator"):
        drop(torch.zeros(1, 4, dtype=torch.int32), deterministic=False)
