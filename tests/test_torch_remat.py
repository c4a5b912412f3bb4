"""``remat``, the chunked fused LM head and ``ce_half_residuals`` in the
port's standalone models (CPU, fp32).

Against the JAX models built the same way, from the same seeded flax
``init`` tree: LLaMA (MHA and GQA) and GPT with the fused head (by
``fused_head_xent`` and by ``APEX_TPU_XENT_CHUNK``) and ``remat=True``,
GPT in training mode with attention dropout under ``remat``, and BERT
with the padding mask, ``remat`` and ``ce_half_residuals``; loss and
every parameter's grad at 1e-5 absolute, the tolerance of
``test_torch_lm_training.py`` (fp32 both sides, the JAX kernels in
Pallas interpret mode).  A tree built with ``remat`` and the fused head
loads into the port unchanged: the parameter names do not move.

Attention seeds: under ``nn.remat`` the JAX layers' seeds are tracers,
so they are recorded from the same JAX model without ``remat`` (the
same rng paths, so the same seeds: its loss is the same).  The port's
layers draw their own seed from the generator, in the forward and again
in the recompute; the relay hands the JAX seeds out keyed by the seed
the port's layer drew, so the recompute gets the forward's seed.

On the port alone: GPT and BERT with hidden and attention dropout, and
LLaMA, under ``remat`` against the same models without it from the same
generator seed; loss, every grad and the generator's final state are
bit-identical.  ``torch.utils.checkpoint`` alone (no generator replay)
fails that check.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import apex_tpu.transformer.testing.standalone_gpt as jgpt_mod
from apex_tpu.transformer import parallel_state
from apex_tpu.transformer.testing import BertConfig as JaxBertConfig
from apex_tpu.transformer.testing import GPTConfig as JaxGPTConfig
from apex_tpu.transformer.testing import LlamaConfig as JaxLlamaConfig
from apex_tpu.transformer.testing import bert_model_provider as jax_bert
from apex_tpu.transformer.testing import gpt_model_provider as jax_gpt
from apex_tpu.transformer.testing import llama_model_provider as jax_llama
import apex_tpu_torch.transformer.testing.standalone_gpt as tgpt_mod
from apex_tpu_torch import train_step as ttrain
from apex_tpu_torch.inference.weights import load_jax_params
from apex_tpu_torch.optimizers import functional as tfunctional
from apex_tpu_torch.transformer.testing import (BertConfig, GPTConfig,
                                                LlamaConfig,
                                                bert_model_provider,
                                                gpt_model_provider,
                                                llama_model_provider)

from _torch_isolation import restore_torch_from_amp  # noqa: F401

GPT_CFG = dict(vocab_size=128, hidden_size=64, ffn_hidden_size=256,
               num_layers=2, num_attention_heads=4, max_seq_length=64,
               hidden_dropout=0.0, attention_dropout=0.1)
LLAMA_CFG = dict(vocab_size=128, hidden_size=64, num_layers=2,
                 num_attention_heads=4, max_seq_length=64)
B, S = 2, 24
CHUNK = 16
ATOL = 1e-5


@pytest.fixture(autouse=True)
def _tp1(monkeypatch):
    monkeypatch.delenv("APEX_TPU_XENT_CHUNK", raising=False)
    monkeypatch.delenv("APEX_TPU_XENT_VOCAB_CHUNK", raising=False)
    parallel_state.destroy_model_parallel()
    parallel_state.initialize_model_parallel(1)
    yield


def _head(monkeypatch, route):
    """``fused_head_xent`` for the config: the chunk itself, or None with
    the chunk in ``APEX_TPU_XENT_CHUNK``."""
    if route == "env":
        monkeypatch.setenv("APEX_TPU_XENT_CHUNK", str(CHUNK))
        return None
    return CHUNK


def _tree_grads(tree, prefix=()):
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_tree_grads(val, prefix + (key,)))
        else:
            out[".".join(prefix + (key,))] = np.asarray(val)
    return out


def _load(tm, jparams):
    """The JAX tree into the port model; the names must be the same."""
    names = sorted(_tree_grads(jparams["params"]))
    assert names == sorted(n for n, _ in tm.named_parameters())
    load_jax_params(tm, jax.tree_util.tree_map(np.asarray, jparams))


def _assert_grads(tm, jgrads, atol=ATOL):
    want = _tree_grads(jgrads["params"])
    got = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
           for n, p in tm.named_parameters()}
    assert sorted(got) == sorted(want)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name], rtol=0, atol=atol,
                                   err_msg=name)


def _batch(seed, vocab=128):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, vocab, size=(B, S)).astype(np.int32)
    return toks, np.roll(toks, -1, axis=1)


def _seed_relay(monkeypatch):
    """Record the concrete JAX attention seeds (a JAX model without
    remat); hand them to the port's layers keyed by the seed each port
    layer drew, so a recompute gets its forward's seed."""
    seeds, given = [], {}
    jfa, tfa = jgpt_mod.flash_attention, tgpt_mod.flash_attention

    def record(q, k, v, **kw):
        seed = kw.get("dropout_seed")
        if kw.get("dropout_rate") and not isinstance(seed, jax.core.Tracer):
            seeds.append(int(seed))
        return jfa(q, k, v, **kw)

    def relay(q, k, v, **kw):
        if kw.get("dropout_rate"):
            drawn = int(kw["dropout_seed"])
            if drawn not in given:
                given[drawn] = seeds.pop(0)
            kw["dropout_seed"] = given[drawn]
        return tfa(q, k, v, **kw)

    monkeypatch.setattr(jgpt_mod, "flash_attention", record)
    monkeypatch.setattr(tgpt_mod, "flash_attention", relay)
    return seeds, given


@pytest.mark.parametrize("kv_heads", [None, 2], ids=["mha", "gqa"])
@pytest.mark.parametrize("route", ["arg", "env"])
def test_llama_fused_head_and_remat_match_jax(monkeypatch, kv_heads, route):
    cfg = dict(LLAMA_CFG, num_kv_heads=kv_heads, remat=True,
               fused_head_xent=_head(monkeypatch, route))
    jm = jax_llama(JaxLlamaConfig(**cfg))
    toks, labels = _batch(1)
    jparams = jm.init(jax.random.PRNGKey(0), toks[:, :4])
    jloss, jgrads = jax.value_and_grad(
        lambda p: jm.apply(p, toks, labels))(jparams)
    tm = llama_model_provider(LlamaConfig(**cfg), device="cpu")
    _load(tm, jparams)
    loss = tm(torch.from_numpy(toks), torch.from_numpy(labels))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=0, atol=ATOL)
    _assert_grads(tm, jgrads)


@pytest.mark.parametrize("route", ["arg", "env"])
def test_gpt_training_mode_under_remat_with_fused_head_matches_jax(
        monkeypatch, route):
    seeds, given = _seed_relay(monkeypatch)
    head = _head(monkeypatch, route)
    toks, labels = _batch(2)
    key = jax.random.PRNGKey(5)
    plain = jax_gpt(JaxGPTConfig(**dict(GPT_CFG, fused_head_xent=head)))
    jparams = plain.init(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))
    ploss = plain.apply(jparams, toks, labels, deterministic=False,
                        rngs={"dropout": key})
    assert len(seeds) == GPT_CFG["num_layers"]
    cfg = dict(GPT_CFG, remat=True, fused_head_xent=head)
    jm = jax_gpt(JaxGPTConfig(**cfg))
    jloss, jgrads = jax.value_and_grad(lambda p: jm.apply(
        p, toks, labels, deterministic=False, rngs={"dropout": key}))(jparams)
    np.testing.assert_allclose(float(jloss), float(ploss), rtol=0, atol=1e-6)
    tm = gpt_model_provider(GPTConfig(**cfg), device="cpu")
    _load(tm, jparams)
    loss = tm(torch.from_numpy(toks), torch.from_numpy(labels),
              deterministic=False, generator=torch.Generator().manual_seed(0))
    loss.backward()
    assert not seeds and len(given) == GPT_CFG["num_layers"]
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=0, atol=ATOL)
    _assert_grads(tm, jgrads)


def _bert_batch(seed):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, 128, size=(B, S)).astype(np.int32)
    types = rng.randint(0, 2, size=(B, S)).astype(np.int32)
    pad = np.ones((B, S), np.int32)
    pad[1, 17:] = 0                                  # sequence 1: 17 tokens
    labels = rng.randint(0, 128, size=(B, S)).astype(np.int32)
    return toks, types, pad, labels


def test_bert_remat_and_half_residuals_match_jax(monkeypatch):
    seeds, given = _seed_relay(monkeypatch)
    toks, types, pad, labels = _bert_batch(3)
    key = jax.random.PRNGKey(6)

    def jrun(jm, p):
        return jm.apply(p, toks, types, attention_mask=pad,
                        lm_labels=labels, deterministic=False,
                        rngs={"dropout": key})[0]

    plain = jax_bert(JaxBertConfig(**GPT_CFG))
    z = jnp.zeros((1, 8), jnp.int32)
    jparams = plain.init(jax.random.PRNGKey(1), z, z)
    jrun(plain, jparams)
    cfg = dict(GPT_CFG, remat=True, ce_half_residuals=True)
    jm = jax_bert(JaxBertConfig(**cfg))
    jloss, jgrads = jax.value_and_grad(lambda p: jrun(jm, p))(jparams)
    tm = bert_model_provider(BertConfig(**cfg), device="cpu")
    _load(tm, jparams)
    loss, _ = tm(*(torch.from_numpy(a) for a in (toks, types, pad, labels)),
                 deterministic=False,
                 generator=torch.Generator().manual_seed(0))
    loss.backward()
    assert not seeds and len(given) == GPT_CFG["num_layers"]
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=0, atol=ATOL)
    _assert_grads(tm, jgrads)


def _port_run(kind, seed=3, **kw):
    """One loss and backward of a port model from ``torch.manual_seed(0)``
    weights; returns the loss, the grads by name and, in training mode,
    the generator's final state."""
    torch.manual_seed(0)
    toks, labels = (torch.from_numpy(a) for a in _batch(4))
    if kind == "llama":
        m = llama_model_provider(LlamaConfig(**dict(LLAMA_CFG, **kw)),
                                 device="cpu")
        loss, gen = m(toks, labels), None
    else:
        gen = torch.Generator().manual_seed(seed)
        cfg = dict(GPT_CFG, hidden_dropout=0.1, **kw)
        if kind == "gpt":
            m = gpt_model_provider(GPTConfig(**cfg), device="cpu")
            loss = m(toks, labels, deterministic=False, generator=gen)
        else:
            m = bert_model_provider(BertConfig(**cfg), device="cpu")
            _, types, pad, _ = (torch.from_numpy(a) for a in _bert_batch(4))
            loss, _ = m(toks, types, pad, labels, deterministic=False,
                        generator=gen)
    loss.backward()
    return (loss.detach(), {n: p.grad for n, p in m.named_parameters()},
            None if gen is None else gen.get_state())


def _equal(a, b) -> bool:
    return a is b is None or (a is not None and b is not None
                              and torch.equal(a, b))


def _same(a, b) -> bool:
    return (torch.equal(a[0], b[0])
            and all(_equal(a[1][n], b[1][n]) for n in a[1])
            and _equal(a[2], b[2]))


@pytest.mark.parametrize("kind", ["gpt", "bert", "llama"])
def test_remat_is_bit_identical_on_the_port(kind):
    """Loss, every grad and the generator's final state: remat against
    no remat from the same generator seed."""
    assert _same(_port_run(kind, remat=True), _port_run(kind))


def test_checkpoint_without_the_generator_replay_fails_the_check(
        monkeypatch):
    """``torch.utils.checkpoint`` alone redraws the masks and the seed in
    the recompute: the grads and the generator's state move."""
    plain = _port_run("gpt")
    monkeypatch.setattr(
        tgpt_mod, "remat",
        lambda fn, *a, generator=None, **k: torch.utils.checkpoint.checkpoint(
            fn, *a, use_reentrant=False, **k))
    naive = _port_run("gpt", remat=True)
    assert torch.equal(naive[0], plain[0])
    assert not torch.equal(naive[2], plain[2])
    assert not all(torch.equal(naive[1][n], plain[1][n]) for n in plain[1])


def test_make_train_step_trains_gpt_with_remat_and_the_fused_head():
    torch.manual_seed(0)
    cfg = GPTConfig(**dict(GPT_CFG, hidden_dropout=0.1, remat=True,
                           fused_head_xent=CHUNK))
    model = gpt_model_provider(cfg, device="cpu")
    tx = tfunctional.fused_adam(lr=1e-2)
    state = ttrain.init_train_state(tx, model, loss_scale="dynamic")
    step = ttrain.make_train_step(
        lambda m, b: m(b["tokens"], b["labels"], deterministic=False,
                       generator=b["generator"]), tx)
    toks, labels = (torch.from_numpy(a) for a in _batch(5))
    losses = []
    for i in range(4):
        state, loss = step(state, dict(
            tokens=toks, labels=labels,
            generator=torch.Generator().manual_seed(100 + i)))
        losses.append(loss.item())
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


def test_scan_layers_with_remat_still_raises():
    """(Named for the refusal this call met before ``scan_layers`` was
    ported.)  scan + remat now builds, and on one seed's weights gives
    the loop layout's loss and the same grads, layer by layer."""
    torch.manual_seed(0)
    loop = gpt_model_provider(GPTConfig(**dict(GPT_CFG, remat=True)),
                              device="cpu")
    torch.manual_seed(0)
    scan = gpt_model_provider(GPTConfig(**dict(GPT_CFG, remat=True,
                                               scan_layers=True)),
                              device="cpu")
    toks, labels = (torch.from_numpy(a) for a in _batch(5))
    a, b = loop(toks, labels), scan(toks, labels)
    assert a.item() == b.item()
    a.backward()
    b.backward()
    stacked = dict(scan.named_parameters())
    for name, p in loop.named_parameters():
        if name.startswith("layer_"):
            i, rest = name.split(".", 1)
            assert torch.equal(stacked["layers.layer." + rest].grad[
                int(i[len("layer_"):])], p.grad), name
