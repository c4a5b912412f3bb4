"""Port parity for the split flash backward: the plain versions of the
dq kernel and the dk/dv kernel against the JAX ``_bwd_impl`` forced onto
its split route, the port's route against the JAX rule at the gate, and
a training step whose sequence crosses a lowered gate on both sides
(CPU, fp32; the JAX kernels in Pallas interpret mode).

The JAX ``_bwd_impl`` takes the one-pass kernel while
``sq * d * 4 <= _FUSED_BWD_MAX_BYTES`` (2 MiB) and the split pair beyond;
the port's ``_bwd`` reads its own ``_FUSED_BWD_MAX_BYTES`` the same way.
(The JAX entry pads sq to a multiple of 128 first; at head dims 32, 64
and 128 the 2 MiB boundary falls on such a multiple, so the two rules
agree at every length.)

Tolerances: dq, dk, dv 2e-5 absolute at unit scale (fp32 on both sides,
blockwise against one-pass sums), as the one-pass backward's parity
test; the training step as ``test_torch_training``: loss 1e-5 relative,
post-step masters within 2 lr of each other and all but 0.1% within
1e-5.
"""
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import train_step as jtrain
from apex_tpu.optimizers import functional as jfunctional
from apex_tpu.transformer import parallel_state
from apex_tpu.transformer.testing import LlamaConfig as JaxLlamaConfig
from apex_tpu.transformer.testing import llama_model_provider as jax_llama
from apex_tpu_torch import train_step as ttrain
from apex_tpu_torch.inference.weights import load_jax_params
from apex_tpu_torch.ops import _build
from apex_tpu_torch.ops import attention as tattn
from apex_tpu_torch.optimizers import functional as tfunctional
from apex_tpu_torch.transformer.testing import (LlamaConfig,
                                                llama_model_provider)

from _torch_isolation import restore_torch_from_amp  # noqa: F401

jattn = importlib.import_module("apex_tpu.ops.attention")

CFG = dict(vocab_size=256, hidden_size=128, num_layers=1,
           num_attention_heads=4, num_kv_heads=2, max_seq_length=64)
SEQ, BATCH, LR = 64, 2, 1e-3


def _t(a):
    return torch.from_numpy(np.array(a))


def _spy(seen, name, fn):
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        seen.append(name)
        return fn(*args, **kwargs)
    return wrapped


@pytest.mark.parametrize("causal,sq,sk,valid", [
    (True, 64, 64, None), (False, 64, 64, None), (True, 40, 72, None),
    (True, 72, 40, None), (False, 48, 96, None), (True, 64, 64, (50, 50)),
    (False, 64, 64, (50, 40))])
def test_split_halves_match_jax_split_backward(monkeypatch, causal, sq, sk,
                                               valid):
    """dq from ``_dq_reference`` and dk, dv from ``_dkv_reference``
    against the JAX ``_dq_kernel`` / ``_dkv_kernel`` (the gate at 0, so
    ``_bwd_impl`` takes the split pair), from the same forward output
    and base-2 lse; ``valid`` is a padded window (causal offset 0)."""
    monkeypatch.setattr(jattn, "_FUSED_BWD_MAX_BYTES", 0)
    rng = np.random.RandomState(sq * 3 + sk)
    q, k, v, do = (rng.randn(3, n, 32).astype(np.float32)
                   for n in (sq, sk, sk, sq))
    scale = 32 ** -0.5
    off = 0 if valid is not None else None
    bq, bk = (16 if n % 16 == 0 else 8 for n in (sq, sk))
    jq, jk, jv, jdo = (jnp.asarray(a) for a in (q, k, v, do))
    o, lse = jattn._fwd(jq, jk, jv, None, causal, scale, bq, bk,
                        causal_off=off, valid=valid)
    seen = []
    monkeypatch.setattr(jattn, "_dq_kernel",
                        _spy(seen, "dq", jattn._dq_kernel))
    monkeypatch.setattr(jattn, "_bwd_fused_kernel",
                        _spy(seen, "fused", jattn._bwd_fused_kernel))
    want = jattn._bwd_impl(jq, jk, jv, None, o, lse, jdo, causal, scale, bq,
                           bk, causal_off=off, valid=valid)
    assert "dq" in seen and "fused" not in seen
    tq, tk, tv, tdo = (_t(a) for a in (q, k, v, do))
    tlse = _t(np.asarray(lse))
    delta = tattn._delta(_t(np.asarray(o)), tdo)
    args = (tq, tk, tv, tlse, delta, tdo, causal, scale, off, valid)
    got = (tattn._dq_reference(*args), *tattn._dkv_reference(*args))
    for g, r in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=2e-5)
    # the one-pass plain version is their composition
    whole = tattn._bwd_reference(tq, tk, tv, _t(np.asarray(o)), tlse, tdo,
                                 causal, scale, off, valid)
    for g, w in zip(got, whole):
        assert torch.equal(g, w)


@pytest.mark.parametrize("d", [32, 64, 128])
def test_route_matches_the_jax_rule_at_the_gate(monkeypatch, d):
    """At the real 2 MiB gate: the JAX backward (traced abstractly, so
    nothing runs) takes the one-pass kernel at sq * d * 4 = 2 MiB and the
    split pair one row later, and so does the port's ``_split_bwd``."""
    seen = []
    for name, attr in (("dq", "_dq_kernel"), ("dkv", "_dkv_kernel"),
                       ("fused", "_bwd_fused_kernel")):
        monkeypatch.setattr(jattn, attr, _spy(seen, name,
                                              getattr(jattn, attr)))
    assert tattn._FUSED_BWD_MAX_BYTES == jattn._FUSED_BWD_MAX_BYTES \
        == 2 * 1024 * 1024
    edge = tattn._FUSED_BWD_MAX_BYTES // (4 * d)
    for s, split in ((edge, False), (edge + 1, True)):
        seen.clear()
        x = jax.ShapeDtypeStruct((1, 1, s, d), jnp.bfloat16)
        loss = (lambda q, k, v: jattn.flash_attention(
            q, k, v, causal=True).astype(jnp.float32).sum())
        jax.eval_shape(jax.grad(loss, argnums=(0, 1, 2)), x, x, x)
        jax_split = sorted(set(seen)) == ["dkv", "dq"]
        assert jax_split == split, (s, seen)
        assert sorted(set(seen)) in (["fused"], ["dkv", "dq"])
        assert tattn._split_bwd(s, d) == split


def test_cpu_split_route_runs_the_plain_halves_and_launches_nothing(
        monkeypatch):
    rng = np.random.RandomState(9)
    q, k, v, do = (_t(rng.randn(2, 48, 32).astype(np.float32))
                   for _ in range(4))
    o, lse = tattn._fwd(q, k, v, True, 0.2)
    seen = []
    for name in ("_dq_reference", "_dkv_reference", "_bwd_reference"):
        monkeypatch.setattr(tattn, name, _spy(seen, name,
                                              getattr(tattn, name)))
    _build.reset_launch_counts()
    one = tattn._bwd(q, k, v, o, lse, do, True, 0.2)
    assert seen[0] == "_bwd_reference"      # (composed of the halves)
    seen.clear()
    monkeypatch.setattr(tattn, "_FUSED_BWD_MAX_BYTES", 48 * 32 * 4 - 1)
    split = tattn._bwd(q, k, v, o, lse, do, True, 0.2)
    assert seen == ["_dq_reference", "_dkv_reference"]
    for a, b in zip(one, split):
        assert torch.equal(a, b)
    assert set(_build.launch_counts().values()) == {0}
    assert _build._LIB is None


def test_cpu_split_md_route_runs_the_plain_halves_and_no_pre_pass(
        monkeypatch):
    """With a mask and dropout, the split route on CPU tensors still runs
    the two plain halves (each once, with the mask and the seed operand),
    never the mask pre-pass, and launches nothing."""
    rng = np.random.RandomState(11)
    q, k, v, do = (_t(rng.randn(4, 40, 64).astype(np.float32))
                   for _ in range(4))
    mask3 = torch.from_numpy(rng.rand(2, 40, 40) > 0.7)
    seed3 = tattn._seed_operand(7)
    md = dict(mask3=mask3, rate=0.1, seed3=seed3)
    o, lse = tattn._fwd(q, k, v, True, 0.125, **md)
    seen = []
    for name in ("_dq_reference", "_dkv_reference", "_bwd_reference",
                 "_mask_tiles", "_dq_kernel", "_dkv_kernel"):
        monkeypatch.setattr(tattn, name, _spy(seen, name,
                                              getattr(tattn, name)))
    monkeypatch.setattr(tattn, "_FUSED_BWD_MAX_BYTES", 0)
    _build.reset_launch_counts()
    split = tattn._bwd(q, k, v, o, lse, do, True, 0.125, **md)
    assert seen == ["_dq_reference", "_dkv_reference"]
    one = tattn._bwd_reference(q, k, v, o, lse, do, True, 0.125, **md)
    for a, b in zip(one, split):
        assert torch.equal(a, b)
    assert set(_build.launch_counts().values()) == {0}
    assert _build._LIB is None


@pytest.fixture(scope="module")
def llama():
    parallel_state.destroy_model_parallel()
    parallel_state.initialize_model_parallel(1)
    jmodel = jax_llama(JaxLlamaConfig(**CFG))
    tree = jmodel.init(jax.random.PRNGKey(0),
                       jnp.zeros((1, 8), jnp.int32))["params"]
    tree = jax.tree_util.tree_map(np.asarray, tree)
    rng = np.random.RandomState(10)
    tokens = rng.randint(0, CFG["vocab_size"], (BATCH, SEQ)).astype(np.int32)
    yield jmodel, tree, tokens, np.roll(tokens, -1, axis=1)
    parallel_state.destroy_model_parallel()


def test_train_step_across_a_lowered_gate_matches_jax(llama, monkeypatch):
    """One make_train_step step (fused Adam, dynamic loss scale) of a
    1-layer LLaMA with both gates lowered below this sequence, so the
    JAX step runs the split Pallas pair and the port its split route:
    loss, scale, count and post-step master agree."""
    jmodel, tree, tokens, labels = llama
    gate = SEQ * 32 * 4 // 2          # head_dim 32: 8 KiB, under both sqs
    monkeypatch.setattr(jattn, "_FUSED_BWD_MAX_BYTES", gate)
    monkeypatch.setattr(tattn, "_FUSED_BWD_MAX_BYTES", gate)
    jseen, tseen = [], []
    monkeypatch.setattr(jattn, "_dq_kernel",
                        _spy(jseen, "dq", jattn._dq_kernel))
    monkeypatch.setattr(jattn, "_bwd_fused_kernel",
                        _spy(jseen, "fused", jattn._bwd_fused_kernel))
    monkeypatch.setattr(tattn, "_dq_reference",
                        _spy(tseen, "dq", tattn._dq_reference))
    monkeypatch.setattr(tattn, "_bwd_reference",
                        _spy(tseen, "fused", tattn._bwd_reference))
    jtx = jfunctional.fused_adam(lr=LR)
    jstate = jtrain.init_train_state(jtx, tree, loss_scale="dynamic")
    jstep = jtrain.make_train_step(
        lambda p, b: jmodel.apply({"params": p}, b["tokens"], b["labels"]),
        jtx)
    model = llama_model_provider(LlamaConfig(**CFG), device="cpu")
    load_jax_params(model, tree)
    ttx = tfunctional.fused_adam(lr=LR)
    tstate = ttrain.init_train_state(ttx, model, loss_scale="dynamic")
    tstep = ttrain.make_train_step(lambda m, b: m(b["tokens"], b["labels"]),
                                   ttx)
    jstate, jloss = jstep(jstate, {"tokens": jnp.asarray(tokens),
                                   "labels": jnp.asarray(labels)})
    tstate, tloss = tstep(tstate, {"tokens": _t(tokens),
                                   "labels": _t(labels)})
    assert "dq" in jseen and "fused" not in jseen
    assert tseen == ["dq"]
    assert abs(float(tloss) - float(jloss)) <= 1e-5 * max(1.0, float(jloss))
    assert float(tstate.scaler.loss_scale) == float(jstate.scaler.loss_scale)
    assert float(tstate.opt.count) == float(jstate.opt.count) == 1.0
    diff = np.abs(tstate.opt.master.numpy() - np.asarray(jstate.opt.master))
    assert diff.max() <= 2 * LR, diff.max()
    assert np.mean(diff > 1e-5) <= 1e-3, np.mean(diff > 1e-5)
