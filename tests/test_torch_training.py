"""Port parity for the training slice: the backward kernels' plain
versions, the flat unscale and Adam, the LLaMA model's loss and flat
grads, and the flat-native train step, each against the JAX package on
the same numpy inputs (CPU, fp32).

The JAX side runs as its own tests run it: Pallas kernels in interpret
mode (the norm backward at hidden % 128 == 0, the fused flash backward,
the flat update kernels).  The model is a tiny LLaMA: hidden 128, 4
heads over 2 kv heads (GQA group 2), 2 layers, vocab 256, sequence 64,
batch 2.

Tolerances (fp32 on both sides; the two differ only in reduction
order): kernel outputs 2e-5 absolute at unit scale (1e-5 relative for
the norm's row sums); the flat unscale exactly; Adam 1e-6 absolute; the
model's loss 1e-5 and its flat grads 1e-4 of the largest grad (two
layers of blockwise-vs-one-pass softmax and XLA-vs-PyTorch matmuls).
Post-step masters: Adam's first step moves each element by about
lr * sign(g), so an element whose grad sits at the two sides' noise
level may move the other way — those are bounded by 2 * lr per step,
and all but 0.1% of the elements must agree within 1e-5.
"""
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
from apex_tpu.utils import tree_ravel as jax_tree_ravel
from apex_tpu_torch import train_step as ttrain
from apex_tpu_torch.inference.weights import load_jax_params
from apex_tpu_torch.ops import _build
from apex_tpu_torch.ops import attention as tattn
from apex_tpu_torch.ops import fused_update as tfu
from apex_tpu_torch.optimizers import functional as tfunctional
from apex_tpu_torch.transformer.testing import (LlamaConfig,
                                                llama_model_provider)
from apex_tpu_torch.utils import tree_leaves_with_path, tree_ravel

from _torch_isolation import restore_torch_from_amp  # noqa: F401

# by module name: both packages re-export functions called layer_norm
jattn = importlib.import_module("apex_tpu.ops.attention")
jfu = importlib.import_module("apex_tpu.ops.fused_update")
jln = importlib.import_module("apex_tpu.ops.layer_norm")
tln = importlib.import_module("apex_tpu_torch.ops.layer_norm")

CFG = dict(vocab_size=256, hidden_size=128, num_layers=2,
           num_attention_heads=4, num_kv_heads=2, max_seq_length=64)
SEQ, BATCH, LR = 64, 2, 1e-3


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor)
                      else x)


# -- kernel #2: the norm backward ------------------------------------------

@pytest.mark.parametrize("rms", [True, False])
def test_norm_bwd_matches_jax(rms):
    rng = np.random.RandomState(1)
    x = (rng.randn(40, 256) * 2 + 0.5).astype(np.float32)
    w = (1 + 0.1 * rng.randn(256)).astype(np.float32)
    dy = rng.randn(40, 256).astype(np.float32)
    jdx, jdw, jdb = jln._bwd_2d(jnp.asarray(x), jnp.asarray(w),
                                jnp.asarray(dy), 1e-5, rms)
    tdx, tdw, tdb = tln._bwd_2d(_t(x), _t(w), _t(dy), 1e-5, rms)
    np.testing.assert_allclose(_np(tdx), np.asarray(jdx), rtol=1e-5,
                               atol=2e-5)
    np.testing.assert_allclose(_np(tdw), np.asarray(jdw), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(jdw)).max())
    if rms:
        assert tdb is None
    else:
        np.testing.assert_allclose(_np(tdb), np.asarray(jdb), rtol=1e-5,
                                   atol=1e-5 * np.abs(np.asarray(jdb)).max())


@pytest.mark.parametrize("rms", [True, False])
def test_norm_autograd_matches_jax_vjp(rms):
    """The autograd Functions against jax.vjp of the custom-VJP ops,
    over a 3-d input (the model's [s, b, h])."""
    rng = np.random.RandomState(2)
    x = rng.randn(8, 3, 128).astype(np.float32)
    w = (1 + 0.1 * rng.randn(128)).astype(np.float32)
    b = (0.1 * rng.randn(128)).astype(np.float32)
    dy = rng.randn(8, 3, 128).astype(np.float32)
    if rms:
        _, vjp = jax.vjp(lambda x_, w_: jln.rms_norm(x_, w_), x, w)
    else:
        _, vjp = jax.vjp(lambda x_, w_, b_: jln.layer_norm(x_, w_, b_),
                         x, w, b)
    want = vjp(jnp.asarray(dy))
    tx, tw, tb = (_t(a).requires_grad_() for a in (x, w, b))
    out = tln.rms_norm(tx, tw) if rms else tln.layer_norm(tx, tw, tb)
    out.backward(_t(dy))
    got = (tx.grad, tw.grad) if rms else (tx.grad, tw.grad, tb.grad)
    for g, r in zip(got, want):
        r = np.asarray(r)
        np.testing.assert_allclose(_np(g), r, rtol=1e-5,
                                   atol=1e-5 * max(1.0, np.abs(r).max()))


# -- kernel #4: the flash backward -----------------------------------------

def _flash_case(bh, sq, sk, d, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(bh, n, d).astype(np.float32)
            for n in (sq, sk, sk, sq)]


@pytest.mark.parametrize("causal,sq,sk,valid", [
    (True, 64, 64, None), (False, 64, 64, None), (True, 40, 72, None),
    (True, 64, 64, (50, 50)), (False, 64, 64, (50, 40))])
def test_flash_bwd_matches_jax(causal, sq, sk, valid):
    """dq, dk, dv of the JAX fused backward (blocks that divide the
    lengths, several tiles) against the port's plain backward, from the
    same forward output and base-2 lse.  ``valid`` is a ragged padding
    window (the causal offset is then 0, as for a padded bucket)."""
    q, k, v, do = _flash_case(3, sq, sk, 32, seed=sq + sk)
    scale = 32 ** -0.5
    off = 0 if valid is not None else None
    bq, bk = (32 if n % 32 == 0 else 8 for n in (sq, sk))
    jq, jk, jv, jdo = (jnp.asarray(a) for a in (q, k, v, do))
    o, lse = jattn._fwd(jq, jk, jv, None, causal, scale, bq, bk,
                        causal_off=off, valid=valid)
    want = jattn._bwd_impl(jq, jk, jv, None, o, lse, jdo, causal, scale, bq,
                           bk, causal_off=off, valid=valid)
    got = tattn._bwd(_t(q), _t(k), _t(v), _t(np.asarray(o)),
                     _t(np.asarray(lse)), _t(do), causal, scale,
                     causal_off=off, valid=valid)
    for g, r in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(r), rtol=1e-5,
                                   atol=2e-5)


def test_flash_attention_gqa_grads_match_jax():
    """The public entry differentiated as the model uses it: k/v of 2 kv
    heads broadcast to 4 q heads before the kernel, so autograd (and
    jax.vjp) sum dk/dv over each group."""
    rng = np.random.RandomState(5)
    q = rng.randn(2, 4, 48, 32).astype(np.float32)
    k = rng.randn(2, 2, 48, 32).astype(np.float32)
    v = rng.randn(2, 2, 48, 32).astype(np.float32)
    do = rng.randn(2, 4, 48, 32).astype(np.float32)

    def bcast(t, lib):
        if lib is jnp:
            return jnp.broadcast_to(t[:, :, None], (2, 2, 2, 48, 32)
                                    ).reshape(2, 4, 48, 32)
        return t[:, :, None].expand(2, 2, 2, 48, 32).reshape(2, 4, 48, 32)

    _, vjp = jax.vjp(lambda q_, k_, v_: jattn.flash_attention(
        q_, bcast(k_, jnp), bcast(v_, jnp), causal=True), q, k, v)
    want = vjp(jnp.asarray(do))
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    tattn.flash_attention(tq, bcast(tk, torch), bcast(tv, torch),
                          causal=True).backward(_t(do))
    for g, r in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(_np(g), np.asarray(r), rtol=1e-5,
                                   atol=2e-5)


# -- kernels #9 and #13: unscale and Adam ----------------------------------

def test_fused_scale_value_and_flag_match_jax():
    rng = np.random.RandomState(6)
    x = (rng.randn(100003) * 1e4).astype(np.float32)
    for poison in (None, np.inf, np.nan):
        xx = x.copy()
        if poison is not None:
            xx[77777] = poison
        jo, jflag = jfu.fused_scale(jnp.asarray(xx), 2.0 ** -16)
        to, tflag = tfu.fused_scale(_t(xx), 2.0 ** -16)
        np.testing.assert_array_equal(_np(to), np.asarray(jo))
        assert float(tflag) == float(jflag) == (poison is not None)
        # in place, as the train step runs it
        buf = _t(xx.copy())
        out, flag = tfu.fused_scale(buf, torch.tensor(2.0 ** -16), out=buf)
        assert out.data_ptr() == buf.data_ptr()
        np.testing.assert_array_equal(_np(buf), np.asarray(jo))


@pytest.mark.parametrize("adam_w", [True, False])
@pytest.mark.parametrize("noop", [0.0, 1.0])
def test_fused_adam_flat_matches_jax(adam_w, noop):
    rng = np.random.RandomState(7)
    n = 70001
    p, g, m = (rng.randn(n).astype(np.float32) for _ in range(3))
    v = np.abs(rng.randn(n)).astype(np.float32)
    kw = dict(lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.01,
              adam_w_mode=adam_w, grad_scale=0.5, noop_flag=noop)
    want = jfu.fused_adam_flat(*(jnp.asarray(a) for a in (p, g, m, v)),
                               step=3.0, **kw)
    tp, tm, tv = _t(p.copy()), _t(m.copy()), _t(v.copy())
    got = tfu.fused_adam_flat(tp, _t(g), tm, tv, step=torch.tensor(3.0),
                              **kw)
    assert got[0] is tp and got[1] is tm and got[2] is tv   # in place
    for a, r in zip(got, want):
        np.testing.assert_allclose(_np(a), np.asarray(r), rtol=0, atol=1e-6)
    if noop:
        for a, before in zip(got, (p, m, v)):
            np.testing.assert_array_equal(_np(a), before)


# -- the model and the train step ------------------------------------------

@pytest.fixture(scope="module")
def llama():
    parallel_state.destroy_model_parallel()
    parallel_state.initialize_model_parallel(1)
    jcfg = JaxLlamaConfig(**CFG)
    jmodel = jax_llama(jcfg)
    tree = jmodel.init(jax.random.PRNGKey(0),
                       jnp.zeros((1, 8), jnp.int32))["params"]
    tree = jax.tree_util.tree_map(np.asarray, tree)
    rng = np.random.RandomState(8)
    tokens = rng.randint(0, CFG["vocab_size"], (BATCH, SEQ)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    yield jmodel, tree, tokens, labels
    parallel_state.destroy_model_parallel()


def _torch_model(tree):
    model = llama_model_provider(LlamaConfig(**CFG), device="cpu")
    load_jax_params(model, tree)
    return model


def _jax_loss(jmodel):
    return lambda p, b: jmodel.apply({"params": p}, b["tokens"],
                                     b["labels"])


def test_named_parameters_are_the_flax_key_paths(llama):
    _, tree, _, _ = llama
    model = _torch_model(tree)
    jpaths = [tuple(k.key for k in path) for path, _ in
              jax.tree_util.tree_flatten_with_path(tree)[0]]
    assert [p for p, _ in tree_leaves_with_path(model)] == jpaths
    jflat, _ = jax_tree_ravel(tree)
    tflat, unravel = tree_ravel(model)
    np.testing.assert_array_equal(_np(tflat), np.asarray(jflat))
    back = unravel(tflat)
    np.testing.assert_array_equal(
        _np(back["layer_1"]["attention"]["kv_proj"]["weight"]),
        tree["layer_1"]["attention"]["kv_proj"]["weight"])


def test_model_loss_and_flat_grads_match_jax(llama):
    jmodel, tree, tokens, labels = llama
    batch = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    jflat, unravel = jax_tree_ravel(tree)
    jloss, jgrad = jax.value_and_grad(
        lambda f: _jax_loss(jmodel)(unravel(f), batch))(jflat)
    model = _torch_model(tree)
    loss = model(_t(tokens), _t(labels))
    loss.backward()
    tgrad = torch.cat([p.grad.reshape(-1)
                       for _, p in tree_leaves_with_path(model)])
    assert abs(loss.item() - float(jloss)) <= 1e-5
    jgrad = np.asarray(jgrad)
    assert np.abs(_np(tgrad) - jgrad).max() <= 1e-4 * np.abs(jgrad).max()


def _master_close(got, want, steps):
    diff = np.abs(got - want)
    assert diff.max() <= 2 * LR * steps, diff.max()
    assert np.mean(diff > 1e-5) <= 1e-3, np.mean(diff > 1e-5)


def test_three_train_steps_match_jax(llama):
    """make_train_step with loss_scale="dynamic" and fused_adam: losses,
    scale, count and post-step masters after each of three steps."""
    jmodel, tree, tokens, labels = llama
    jtx = jfunctional.fused_adam(lr=LR)
    jstate = jtrain.init_train_state(jtx, tree, loss_scale="dynamic")
    jstep = jax.jit(jtrain.make_train_step(_jax_loss(jmodel), jtx))
    ttx = tfunctional.fused_adam(lr=LR)
    model = _torch_model(tree)
    tstate = ttrain.init_train_state(ttx, model, loss_scale="dynamic")
    tstep = ttrain.make_train_step(lambda m, b: m(b["tokens"], b["labels"]),
                                   ttx)
    jb = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    tb = {"tokens": _t(tokens), "labels": _t(labels)}
    np.testing.assert_array_equal(_np(tstate.opt.master),
                                  np.asarray(jstate.opt.master))
    losses = []
    for i in range(3):
        jstate, jloss = jstep(jstate, jb)
        tstate, tloss = tstep(tstate, tb)
        assert abs(float(tloss) - float(jloss)) <= 1e-5 * max(1.0, float(
            jloss))
        assert float(tstate.scaler.loss_scale) == float(
            jstate.scaler.loss_scale)
        assert float(tstate.opt.count) == float(jstate.opt.count) == i + 1
        _master_close(_np(tstate.opt.master), np.asarray(jstate.opt.master),
                      i + 1)
        losses.append(float(tloss))
    assert losses[2] < losses[0]
    # the model's parameters are views of the flat buffer: the next
    # step's forward sees exactly the master, cast
    tstate.flat.load(tstate.opt.master)
    np.testing.assert_array_equal(
        _np(tree_ravel(model)[0]), _np(tstate.opt.master))
    # the checkpoint boundary materializes the flax tree's layout
    out = tstate.params()
    assert out["lm_head"]["weight"].shape == tree["lm_head"]["weight"].shape


def test_overflow_step_skips_and_backs_off_scale(llama):
    """A non-finite grad is caught by the fused unscale flag and skipped
    by the Adam kernel's noop: master, m and v unchanged bit for bit,
    the count advanced, the scale halved — as the JAX step does it."""
    jmodel, tree, tokens, labels = llama

    def jloss(p, b):
        return _jax_loss(jmodel)(p, b) + jnp.sum(
            p["final_norm"]["weight"]) * b["poison"]

    def tloss(m, b):
        return m(b["tokens"], b["labels"]) + m.final_norm.weight.sum() \
            * b["poison"]

    jtx = jfunctional.fused_adam(lr=LR)
    jstate = jtrain.init_train_state(jtx, tree, loss_scale="dynamic")
    jstep = jax.jit(jtrain.make_train_step(jloss, jtx))
    ttx = tfunctional.fused_adam(lr=LR)
    tstate = ttrain.init_train_state(ttx, _torch_model(tree),
                                     loss_scale="dynamic")
    tstep = ttrain.make_train_step(tloss, ttx)
    clean = {"tokens": tokens, "labels": labels, "poison": np.float32(0.0)}
    poisoned = dict(clean, poison=np.float32(1e38))
    for batch in (clean, poisoned):
        jstate, _ = jstep(jstate, {k: jnp.asarray(v)
                                   for k, v in batch.items()})
        if batch is poisoned:
            before = [t.clone() for t in (
                tstate.opt.master, tstate.opt.slots["exp_avg"],
                tstate.opt.slots["exp_avg_sq"])]
            scale_before = float(tstate.scaler.loss_scale)
        tstate, _ = tstep(tstate, {k: _t(np.asarray(v))
                                   for k, v in batch.items()})
    after = (tstate.opt.master, tstate.opt.slots["exp_avg"],
             tstate.opt.slots["exp_avg_sq"])
    for a, b in zip(after, before):
        assert torch.equal(a, b)
    assert float(tstate.opt.count) == float(jstate.opt.count) == 2.0
    assert float(tstate.scaler.loss_scale) == scale_before * 0.5 == float(
        jstate.scaler.loss_scale)
    assert int(tstate.scaler.growth_tracker) == int(
        jstate.scaler.growth_tracker) == 0
    # and the loop recovers on the next clean batch
    tstate, _ = tstep(tstate, {k: _t(np.asarray(v))
                               for k, v in clean.items()})
    assert not torch.equal(tstate.opt.master, before[0])


def test_cpu_training_launches_nothing(llama):
    _, tree, tokens, labels = llama
    _build.reset_launch_counts()
    tx = tfunctional.fused_adam(lr=LR)
    state = ttrain.init_train_state(tx, _torch_model(tree),
                                    loss_scale="dynamic")
    step = ttrain.make_train_step(lambda m, b: m(b["tokens"], b["labels"]),
                                  tx)
    step(state, {"tokens": _t(tokens), "labels": _t(labels)})
    assert set(_build.launch_counts().values()) == {0}
    assert _build._LIB is None


# -- the modules around the kernels ----------------------------------------

def test_norm_modules_and_functions_match_flax():
    from apex_tpu import normalization as jnorm
    from apex_tpu_torch import normalization as tnorm
    rng = np.random.RandomState(9)
    x = rng.randn(4, 6, 128).astype(np.float32)
    for jcls, tcls in ((jnorm.FusedRMSNorm, tnorm.FusedRMSNorm),
                       (jnorm.FusedLayerNorm, tnorm.FusedLayerNorm)):
        jmod = jcls(normalized_shape=128, eps=1e-5)
        variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))
        tmod = tcls(128, eps=1e-5)
        names = sorted(n for n, _ in tmod.named_parameters())
        assert names == sorted(variables["params"])
        with torch.no_grad():
            for n, p in tmod.named_parameters():
                p.copy_(_t(np.asarray(variables["params"][n]) + 0.1))
        jvars = jax.tree_util.tree_map(lambda a: a + 0.1, variables)
        np.testing.assert_allclose(
            _np(tmod(_t(x))), np.asarray(jmod.apply(jvars, jnp.asarray(x))),
            rtol=1e-5, atol=1e-5)
    w = (1 + 0.1 * rng.randn(128)).astype(np.float32)
    np.testing.assert_allclose(
        _np(tnorm.fused_rms_norm(_t(x), 128, _t(w))),
        np.asarray(jnorm.fused_rms_norm(jnp.asarray(x), 128, jnp.asarray(w))),
        rtol=1e-5, atol=1e-5)


def test_tp1_layers_and_cross_entropy_match_jax(llama):
    """Column/Row linears and the embedding on the same weights, and the
    tp = 1 cross entropy with and without label smoothing."""
    from apex_tpu.transformer.tensor_parallel import (
        ColumnParallelLinear as JCol, RowParallelLinear as JRow,
        VocabParallelEmbedding as JEmb, vocab_parallel_cross_entropy as jce)
    from apex_tpu_torch.transformer.tensor_parallel import (
        ColumnParallelLinear, RowParallelLinear, VocabParallelEmbedding,
        vocab_parallel_cross_entropy)
    rng = np.random.RandomState(10)
    x = rng.randn(5, 2, 32).astype(np.float32)
    for jcls, tcls in ((JCol, ColumnParallelLinear),
                       (JRow, RowParallelLinear)):
        jmod = jcls(32, 48, bias=True)
        params = jmod.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
        params = {"weight": params["weight"],
                  "bias": jnp.asarray(rng.randn(48).astype(np.float32))}
        tmod = tcls(32, 48, bias=True, device="cpu")
        with torch.no_grad():
            tmod.weight.copy_(_t(np.asarray(params["weight"])))
            tmod.bias.copy_(_t(np.asarray(params["bias"])))
        jout, _ = jmod.apply({"params": params}, jnp.asarray(x))
        tout, tb = tmod(_t(x))
        assert tb is None
        np.testing.assert_allclose(_np(tout), np.asarray(jout), rtol=1e-5,
                                   atol=1e-5)
    ids = rng.randint(0, 64, (3, 7)).astype(np.int32)
    jemb = JEmb(64, 16)
    params = jemb.init(jax.random.PRNGKey(2), jnp.asarray(ids))
    temb = VocabParallelEmbedding(64, 16, device="cpu")
    with torch.no_grad():
        temb.weight.copy_(_t(np.asarray(params["params"]["weight"])))
    np.testing.assert_array_equal(_np(temb(_t(ids))), np.asarray(
        jemb.apply(params, jnp.asarray(ids))))
    logits = (rng.randn(6, 3, 50) * 3).astype(np.float32)
    target = rng.randint(0, 50, (6, 3)).astype(np.int32)
    for smoothing in (0.0, 0.1):
        np.testing.assert_allclose(
            _np(vocab_parallel_cross_entropy(_t(logits), _t(target),
                                             smoothing)),
            np.asarray(jce(jnp.asarray(logits), jnp.asarray(target),
                           smoothing)), rtol=1e-5, atol=1e-5)


def test_loss_scaler_matches_jax():
    """The imperative wrapper: scale_loss, unscale_ (with an overflow),
    the growth/backoff schedule and the state_dict round trip."""
    from apex_tpu.amp.scaler import LossScaler as JScaler
    from apex_tpu_torch.amp.scaler import LossScaler
    js = JScaler("dynamic", scale_window=2)
    ts = LossScaler("dynamic", scale_window=2, device="cpu")
    rng = np.random.RandomState(11)
    for poison in (False, False, False, True, False):
        g = {"a": rng.randn(5).astype(np.float32) * 1e3,
             "b": {"c": rng.randn(3, 2).astype(np.float32)}}
        if poison:
            g["b"]["c"][1, 1] = np.inf
        assert float(ts.scale_loss(torch.tensor(2.0))) == float(
            js.scale_loss(jnp.float32(2.0)))
        jout = js.unscale_(jax.tree_util.tree_map(jnp.asarray, g))
        tout = ts.unscale_({"a": _t(g["a"]), "b": {"c": _t(g["b"]["c"])}})
        np.testing.assert_array_equal(_np(tout["a"]), np.asarray(jout["a"]))
        assert float(ts.found_inf) == float(js.found_inf) == poison
        js.update_scale()
        ts.update_scale()
        assert ts.loss_scale() == js.loss_scale()
        assert ts.state_dict() == js.state_dict()
    restored = LossScaler("dynamic", device="cpu")
    restored.load_state_dict(ts.state_dict())
    assert restored.state_dict() == ts.state_dict()


def test_train_loop_and_has_aux_match_stepwise(llama):
    """``train_loop`` over a list of batches is the step applied in turn
    (bit for bit on the CPU), and ``has_aux`` carries the aux output."""
    _, tree, tokens, labels = llama
    batches = [{"tokens": _t(tokens), "labels": _t(labels)},
               {"tokens": _t(labels), "labels": _t(tokens)}]

    def loss_aux(m, b):
        loss = m(b["tokens"], b["labels"])
        return loss, {"double": 2 * loss.detach()}

    tx = tfunctional.fused_adam(lr=LR)
    run = ttrain.train_loop(loss_aux, tx, has_aux=True)
    s1, metrics = run(ttrain.init_train_state(tx, _torch_model(tree)),
                      batches)
    step = ttrain.make_train_step(loss_aux, tx, has_aux=True)
    s2 = ttrain.init_train_state(tx, _torch_model(tree))
    for batch, (loss, aux) in zip(batches, metrics):
        s2, (loss2, aux2) = step(s2, batch)
        assert float(loss) == float(loss2)
        assert float(aux["double"]) == 2 * float(loss)
    assert s1.scaler is None and float(s1.opt.count) == 2.0
    assert torch.equal(s1.opt.master, s2.opt.master)
