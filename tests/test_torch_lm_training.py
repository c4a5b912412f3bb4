"""GPT and BERT in training mode on the port against the JAX models
(CPU, fp32), and trained through ``make_train_step``.

Config: 2 layers, hidden 64, 4 heads of 16, ffn 256, vocab 128, 24
tokens.  The same seeded flax ``init`` tree goes to both packages.  With
``hidden_dropout=0`` and ``attention_dropout=0.1`` the two models drop
the same attention probabilities when they are given the same seeds:
the JAX layers' seeds are recorded by wrapping the JAX module's
``flash_attention`` (pytest's ``monkeypatch``) and handed, in order, to
the port's layers by wrapping the port module's.  Loss and every
parameter's grad are held at 1e-5 absolute (fp32 on both sides, the
JAX kernels in Pallas interpret mode, blockwise sums against one pass,
over two layers; the grads of order 1e-2 to 1).  Hidden dropout cannot
draw flax's PRNG bits from a ``torch.Generator`` (as sampling cannot,
``inference/sampling.py``), so it is held by its statistics: the drop
fraction within 3 sigma of the rate, survivors scaled by 1 / (1 -
rate), the same generator seed giving the same loss and another seed
another loss.  ``make_train_step`` with ``fused_lamb`` on BERT (with
padding) and ``fused_adam`` on GPT, both with dropout, lowers the loss
over four steps, each with a fresh generator carried in the batch.
A training-mode GPT step also runs with both packages'
``_FUSED_BWD_MAX_BYTES`` at 0, so each backward takes its split pair
(the JAX ``_dq_kernel`` and ``_dkv_kernel``, the port's plain halves),
held at the same tolerance.
"""
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import apex_tpu.transformer.testing.standalone_gpt as jgpt_mod
from apex_tpu.transformer import parallel_state
from apex_tpu.transformer.testing import BertConfig as JaxBertConfig
from apex_tpu.transformer.testing import GPTConfig as JaxGPTConfig
from apex_tpu.transformer.testing import bert_model_provider as jax_bert
from apex_tpu.transformer.testing import gpt_model_provider as jax_gpt
import apex_tpu_torch.transformer.testing.standalone_gpt as tgpt_mod
from apex_tpu_torch import models as tmodels
from apex_tpu_torch import train_step as ttrain
from apex_tpu_torch.inference.weights import load_jax_params
from apex_tpu_torch.ops import _build
from apex_tpu_torch.optimizers import functional as tfunctional
from apex_tpu_torch.transformer import testing as ttesting
from apex_tpu_torch.transformer.testing import (BertConfig, GPTConfig,
                                                bert_model_provider,
                                                gpt_model_provider)

from _torch_isolation import restore_torch_from_amp  # noqa: F401

jattn = importlib.import_module("apex_tpu.ops.attention")
tattn = importlib.import_module("apex_tpu_torch.ops.attention")

CFG = dict(vocab_size=128, hidden_size=64, ffn_hidden_size=256,
           num_layers=2, num_attention_heads=4, max_seq_length=64,
           hidden_dropout=0.0, attention_dropout=0.1)
B, S = 2, 24
ATOL = 1e-5


@pytest.fixture(autouse=True)
def _tp1():
    parallel_state.destroy_model_parallel()
    parallel_state.initialize_model_parallel(1)
    yield


def _tree_grads(tree, prefix=()):
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_tree_grads(val, prefix + (key,)))
        else:
            out[".".join(prefix + (key,))] = np.asarray(val)
    return out


def _seed_relay(monkeypatch):
    """Record the JAX layers' attention seeds; hand them to the port's
    layers in the same order."""
    seeds = []
    jfa, tfa = jgpt_mod.flash_attention, tgpt_mod.flash_attention

    def record(q, k, v, **kw):
        if kw.get("dropout_rate"):
            seeds.append(int(kw["dropout_seed"]))
        return jfa(q, k, v, **kw)

    def relay(q, k, v, **kw):
        if kw.get("dropout_rate"):
            kw["dropout_seed"] = seeds.pop(0)
        return tfa(q, k, v, **kw)

    monkeypatch.setattr(jgpt_mod, "flash_attention", record)
    monkeypatch.setattr(tgpt_mod, "flash_attention", relay)
    return seeds


def _batch(seed):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, CFG["vocab_size"], size=(B, S)).astype(np.int32)
    return toks, np.roll(toks, -1, axis=1)


def _assert_grads(tm, jgrads):
    want = _tree_grads(jgrads["params"])
    got = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
           for n, p in tm.named_parameters()}
    assert sorted(got) == sorted(want)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name], rtol=0, atol=ATOL,
                                   err_msg=name)


def test_gpt_training_mode_loss_and_grads_match_jax(monkeypatch):
    seeds = _seed_relay(monkeypatch)
    jcfg = JaxGPTConfig(**CFG)
    jm = jax_gpt(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))
    toks, labels = _batch(1)
    jloss, jgrads = jax.value_and_grad(lambda p: jm.apply(
        p, toks, labels, deterministic=False,
        rngs={"dropout": jax.random.PRNGKey(5)}))(jparams)
    assert len(seeds) == CFG["num_layers"]
    tm = gpt_model_provider(GPTConfig(**CFG), device="cpu")
    load_jax_params(tm, jax.tree_util.tree_map(np.asarray, jparams))
    _build.reset_launch_counts()
    loss = tm(torch.from_numpy(toks), torch.from_numpy(labels),
              deterministic=False, generator=torch.Generator().manual_seed(0))
    loss.backward()
    assert not seeds and not any(_build.launch_counts().values())
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=0, atol=ATOL)
    _assert_grads(tm, jgrads)


def _spy(seen, name, fn):
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        seen.append(name)
        return fn(*args, **kwargs)
    return wrapped


def test_gpt_training_mode_on_the_split_backward_matches_jax(monkeypatch):
    """Both gates at 0: every attention backward of both models takes the
    split pair with dropout (the JAX ``_dq_kernel``/``_dkv_kernel``, the
    port's ``_dq_reference``/``_dkv_reference`` with the seed operand);
    loss and grads as the one-pass route's test holds them."""
    seeds = _seed_relay(monkeypatch)
    monkeypatch.setattr(jattn, "_FUSED_BWD_MAX_BYTES", 0)
    monkeypatch.setattr(tattn, "_FUSED_BWD_MAX_BYTES", 0)
    jseen, tseen = [], []
    for name in ("_dq_kernel", "_dkv_kernel", "_bwd_fused_kernel"):
        monkeypatch.setattr(jattn, name, _spy(jseen, name,
                                              getattr(jattn, name)))
    for name in ("_dq_reference", "_dkv_reference", "_bwd_reference"):
        monkeypatch.setattr(tattn, name, _spy(tseen, name,
                                              getattr(tattn, name)))
    jcfg = JaxGPTConfig(**CFG)
    jm = jax_gpt(jcfg)
    jparams = jm.init(jax.random.PRNGKey(2), jnp.zeros((1, 4), jnp.int32))
    toks, labels = _batch(6)
    jloss, jgrads = jax.value_and_grad(lambda p: jm.apply(
        p, toks, labels, deterministic=False,
        rngs={"dropout": jax.random.PRNGKey(7)}))(jparams)
    assert len(seeds) == CFG["num_layers"]
    assert "_bwd_fused_kernel" not in jseen
    assert {"_dq_kernel", "_dkv_kernel"} <= set(jseen)
    tm = gpt_model_provider(GPTConfig(**CFG), device="cpu")
    load_jax_params(tm, jax.tree_util.tree_map(np.asarray, jparams))
    _build.reset_launch_counts()
    loss = tm(torch.from_numpy(toks), torch.from_numpy(labels),
              deterministic=False, generator=torch.Generator().manual_seed(0))
    loss.backward()
    assert not seeds and not any(_build.launch_counts().values())
    assert tseen == ["_dq_reference", "_dkv_reference"] * CFG["num_layers"]
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=0, atol=ATOL)
    _assert_grads(tm, jgrads)


def _bert_batch(seed):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, CFG["vocab_size"], size=(B, S)).astype(np.int32)
    types = rng.randint(0, 2, size=(B, S)).astype(np.int32)
    pad = np.ones((B, S), np.int32)
    pad[1, 17:] = 0                                  # sequence 1: 17 tokens
    labels = rng.randint(0, CFG["vocab_size"], size=(B, S)).astype(np.int32)
    lm = (rng.rand(B, S) < 0.15).astype(np.float32) * pad
    lm[0, 0] = 1.0
    return toks, types, pad, labels, lm


def test_bert_training_mode_with_padding_matches_jax(monkeypatch):
    seeds = _seed_relay(monkeypatch)
    jcfg = JaxBertConfig(**CFG)
    jm = jax_bert(jcfg)
    z = jnp.zeros((1, 8), jnp.int32)
    jparams = jm.init(jax.random.PRNGKey(1), z, z)
    toks, types, pad, labels, lm = _bert_batch(2)
    jloss, jgrads = jax.value_and_grad(lambda p: jm.apply(
        p, toks, types, attention_mask=pad, lm_labels=labels,
        deterministic=False, loss_mask=lm,
        rngs={"dropout": jax.random.PRNGKey(6)})[0])(jparams)
    assert len(seeds) == CFG["num_layers"]
    tm = bert_model_provider(BertConfig(**CFG), device="cpu")
    load_jax_params(tm, jax.tree_util.tree_map(np.asarray, jparams))
    loss, _ = tm(*(torch.from_numpy(a) for a in (toks, types, pad, labels)),
                 deterministic=False, loss_mask=torch.from_numpy(lm),
                 generator=torch.Generator().manual_seed(0))
    loss.backward()
    assert not seeds
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=0, atol=ATOL)
    _assert_grads(tm, jgrads)


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_hidden_dropout_statistics(rate):
    x = torch.full((512, 256), 3.0)
    g = torch.Generator().manual_seed(11)
    y = tgpt_mod.hidden_dropout(x, rate, False, g)
    dropped = (y == 0).double().mean().item()
    n = x.numel()
    assert abs(dropped - rate) <= 3 * np.sqrt(rate * (1 - rate) / n)
    np.testing.assert_allclose(y[y != 0].numpy(), 3.0 / (1.0 - rate),
                               rtol=1e-6)
    # eval mode and rate 0 are the identity, with no generator needed
    assert tgpt_mod.hidden_dropout(x, rate, True) is x
    assert tgpt_mod.hidden_dropout(x, 0.0, False) is x


def test_training_mode_loss_follows_the_generator_seed():
    cfg = GPTConfig(**dict(CFG, hidden_dropout=0.1))
    torch.manual_seed(0)
    tm = gpt_model_provider(cfg, device="cpu")
    toks, labels = (torch.from_numpy(a) for a in _batch(3))

    def loss(seed):
        with torch.no_grad():
            return tm(toks, labels, deterministic=False,
                      generator=torch.Generator().manual_seed(seed)).item()

    assert loss(4) == loss(4)
    assert loss(4) != loss(5)
    with torch.no_grad():
        assert tm(toks, labels).item() == tm(toks, labels).item()
    with pytest.raises(ValueError, match="generator"):
        tm(toks, labels, deterministic=False)


def _train(model, tx, batch, loss_fn, steps=4):
    state = ttrain.init_train_state(tx, model, loss_scale="dynamic")
    step = ttrain.make_train_step(loss_fn, tx)
    losses = []
    for i in range(steps):
        state, loss = step(state, dict(
            batch, generator=torch.Generator().manual_seed(100 + i)))
        losses.append(loss.item())
    return losses


def test_make_train_step_trains_bert_with_lamb_and_padding():
    torch.manual_seed(1)
    cfg = BertConfig(**dict(CFG, hidden_dropout=0.1))
    tm = bert_model_provider(cfg, device="cpu")
    toks, types, pad, labels, lm = (torch.from_numpy(a)
                                    for a in _bert_batch(4))
    batch = dict(tokens=toks, types=types, pad=pad, labels=labels, lm=lm)

    def loss_fn(m, b):
        return m(b["tokens"], b["types"], b["pad"], b["labels"],
                 deterministic=False, loss_mask=b["lm"],
                 generator=b["generator"])[0]

    losses = _train(tm, tfunctional.fused_lamb(lr=1e-2, weight_decay=0.01,
                                               max_grad_norm=1.0),
                    batch, loss_fn)
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses


def test_make_train_step_trains_gpt_with_adam_and_dropout():
    torch.manual_seed(2)
    cfg = GPTConfig(**dict(CFG, hidden_dropout=0.1))
    tm = gpt_model_provider(cfg, device="cpu")
    toks, labels = (torch.from_numpy(a) for a in _batch(5))

    def loss_fn(m, b):
        return m(b["tokens"], b["labels"], deterministic=False,
                 generator=b["generator"])

    losses = _train(tm, tfunctional.fused_adam(lr=1e-2),
                    dict(tokens=toks, labels=labels), loss_fn)
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses


@pytest.mark.parametrize("name", ["BertConfig", "BertModel",
                                  "bert_model_provider", "GPTConfig",
                                  "GPTModel", "gpt_model_provider",
                                  "LlamaConfig", "LlamaModel",
                                  "llama_model_provider"])
def test_models_reexports_the_testing_objects(name):
    import apex_tpu.models as jmodels
    import apex_tpu_torch
    assert getattr(tmodels, name) is getattr(ttesting, name)
    assert name in tmodels.__all__ and name in jmodels.__all__
    assert apex_tpu_torch.models is tmodels
