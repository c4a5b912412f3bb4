"""Port parity for the optimizer family: the L2 norm, LAMB phase 1, SGD
and Adagrad wrappers, the LAMB, SGD, Adagrad and NovoGrad rules through
``make_train_step``, the overflow skip, and the grad clipper, each
against the JAX package on the same numpy inputs (CPU, fp32).

The JAX side runs as its own tests run it: the flat update kernels in
Pallas interpret mode.  The model is the training slice's tiny LLaMA
(hidden 128, 4 heads over 2 kv heads, 2 layers, vocab 256, sequence
64, batch 2).

Tolerances (fp32 on both sides):
* the wrappers: 1e-6 relative plus 1e-6 absolute (the same fp32
  arithmetic; a multiply-add may be contracted on one side, a few ulps
  of LAMB's |u| <= ~20); the L2 norm 1e-6 relative (sums of squares in
  another order);
* three train steps: losses 1e-5 relative; master and every slot within
  1e-5 of the buffer's largest magnitude (the flat grads agree to ~1e-6
  of theirs).  Adagrad's first step moves an element by about lr *
  sign(g) whatever the size of g, so an element whose grad sits at the
  two sides' noise level may move the other way (about 0.2% of this
  model's elements in w mode, where no decay term lifts the tiny grads):
  there all but 1% of the elements must agree, and every element within
  twice the steps taken (2 lr per step);
* the overflow skip: bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import train_step as jtrain
from apex_tpu.contrib.clip_grad import clip_grad_norm_ as jclip
from apex_tpu.ops import fused_update as jfu
from apex_tpu.optimizers import functional as jfunctional
from apex_tpu.optimizers.base import broadcast_leaf_scalars as jbroadcast
from apex_tpu_torch import train_step as ttrain
from apex_tpu_torch.contrib import clip_grad_norm_
from apex_tpu_torch.ops import _build
from apex_tpu_torch.ops import fused_update as tfu
from apex_tpu_torch.optimizers import broadcast_leaf_scalars
from apex_tpu_torch.optimizers import functional as tfunctional

from _torch_isolation import restore_torch_from_amp  # noqa: F401
# the training slice's tiny LLaMA, its JAX init tree and batch
from test_torch_training import _jax_loss, _t, _torch_model, llama  # noqa: F401


def _np(x):
    return np.asarray(x.detach().float().numpy()
                      if isinstance(x, torch.Tensor) else x, np.float32)


def _bf16(a):
    """``a`` rounded to bf16, for both sides: (jax array, torch tensor)."""
    t = _t(a).to(torch.bfloat16)
    return jnp.asarray(a).astype(jnp.bfloat16), t


def _close(got, want):
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               rtol=1e-6, atol=1e-6)


# -- kernel #11: the L2 norm ------------------------------------------------

@pytest.mark.parametrize("n", [0, 1, 7, 70001])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_l2norm_matches_jax(n, dtype):
    x = (np.random.RandomState(n).randn(n) * 3).astype(np.float32)
    if dtype == "bfloat16":
        jx, tx = _bf16(x)
    else:
        jx, tx = jnp.asarray(x), _t(x)
    want = float(jfu.fused_l2norm(jx))
    got = tfu.fused_l2norm(tx)
    assert got.shape == () and got.dtype == torch.float32
    assert abs(float(got) - want) <= 1e-6 * max(1.0, want)
    # into a caller's slot of a vector of norms
    norms = torch.zeros(3)
    assert tfu.fused_l2norm(tx, out=norms[1]) is not None
    assert float(norms[1]) == float(got) and float(norms[0]) == 0.0


def test_fused_l2norm_refuses_misshaped_operands():
    with pytest.raises(ValueError, match="flat"):
        tfu.fused_l2norm(torch.zeros(2, 3))
    with pytest.raises(ValueError, match="0-d"):
        tfu.fused_l2norm(torch.zeros(6), out=torch.zeros(1))


# -- kernel #16: LAMB phase 1 -----------------------------------------------

def _state(n, seed, slots=2):
    rng = np.random.RandomState(seed)
    p, g = rng.randn(n).astype(np.float32), rng.randn(n).astype(np.float32)
    rest = [np.abs(rng.randn(n)).astype(np.float32) * (0.1 if i == 0 else 1)
            for i in range(slots)]
    return p, g, rest


@pytest.mark.parametrize("n", [7, 70001])
@pytest.mark.parametrize("g_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bias_correction,grad_averaging",
                         [(True, True), (False, True), (True, False)])
def test_fused_lamb_phase1_matches_jax(n, g_dtype, bias_correction,
                                       grad_averaging):
    p, g, (m, v) = _state(n, 3)
    jg, tg = _bf16(g) if g_dtype == "bfloat16" else (jnp.asarray(g), _t(g))
    kw = dict(beta1=0.9, beta2=0.999, eps=1e-6, weight_decay=0.01,
              bias_correction=bias_correction, grad_scale=0.5,
              grad_averaging=grad_averaging)
    want = jfu.fused_lamb_phase1_flat(jnp.asarray(p), jg, jnp.asarray(m),
                                      jnp.asarray(v), step=3.0, **kw)
    tm, tv, tu = _t(m.copy()), _t(v.copy()), torch.empty(n)
    got = tfu.fused_lamb_phase1_flat(_t(p), tg, tm, tv, u=tu,
                                     step=torch.tensor(3.0), **kw)
    assert got[0] is tm and got[1] is tv and got[2] is tu   # in place
    for a, r in zip(got, want):
        _close(a, r)


def test_fused_lamb_phase1_noop_keeps_moments_and_zeroes_u():
    """Port-only: the noop flag leaves m and v bit-identical and writes
    u = 0 (the JAX rule selects the old buffers afterwards)."""
    p, g, (m, v) = _state(1001, 4)
    tm, tv = _t(m.copy()), _t(v.copy())
    _, _, u = tfu.fused_lamb_phase1_flat(
        _t(p), _t(g), tm, tv, beta1=0.9, beta2=0.999, eps=1e-6,
        weight_decay=0.01, step=1.0, noop_flag=torch.tensor(1.0))
    np.testing.assert_array_equal(_np(tm), m)
    np.testing.assert_array_equal(_np(tv), v)
    assert torch.equal(u, torch.zeros_like(u))


# -- kernel #15: SGD --------------------------------------------------------

@pytest.mark.parametrize("nesterov,wd_after,first,momentum", [
    (False, False, False, 0.9), (True, False, False, 0.9),
    (False, True, False, 0.9), (True, True, True, 0.9),
    (False, False, True, 0.9), (False, False, False, 0.0)])
@pytest.mark.parametrize("g_dtype", ["float32", "bfloat16"])
def test_fused_sgd_flat_matches_jax(nesterov, wd_after, first, momentum,
                                    g_dtype):
    p, g, (buf,) = _state(70001, 5, slots=1)
    jg, tg = _bf16(g) if g_dtype == "bfloat16" else (jnp.asarray(g), _t(g))
    kw = dict(lr=0.1, momentum=momentum, dampening=0.1, weight_decay=0.01,
              nesterov=nesterov, wd_after_momentum=wd_after,
              grad_scale=0.5)
    want = jfu.fused_sgd_flat(jnp.asarray(p), jg, jnp.asarray(buf),
                              first_run=first, **kw)
    tp, tb = _t(p.copy()), _t(buf.copy())
    got = tfu.fused_sgd_flat(tp, tg, tb, first_run=torch.tensor(float(first)),
                             **kw)
    assert got[0] is tp and got[1] is tb
    for a, r in zip(got, want):
        _close(a, r)


def test_fused_sgd_flat_noop():
    p, g, (buf,) = _state(1001, 6, slots=1)
    kw = dict(lr=0.1, momentum=0.9, dampening=0.0, weight_decay=0.01,
              nesterov=True, noop_flag=1.0)
    want = jfu.fused_sgd_flat(jnp.asarray(p), jnp.asarray(g),
                              jnp.asarray(buf), **kw)
    got = tfu.fused_sgd_flat(_t(p.copy()), _t(g), _t(buf.copy()), **kw)
    for a, r, before in zip(got, want, (p, buf)):
        np.testing.assert_array_equal(_np(a), np.asarray(r))
        np.testing.assert_array_equal(_np(a), before)


# -- kernel #14: Adagrad ----------------------------------------------------

@pytest.mark.parametrize("n", [7, 70001])
@pytest.mark.parametrize("w_mode", [False, True])
@pytest.mark.parametrize("noop", [0.0, 1.0])
@pytest.mark.parametrize("g_dtype", ["float32", "bfloat16"])
def test_fused_adagrad_flat_matches_jax(n, w_mode, noop, g_dtype):
    p, g, (h,) = _state(n, 7, slots=1)
    jg, tg = _bf16(g) if g_dtype == "bfloat16" else (jnp.asarray(g), _t(g))
    kw = dict(lr=1e-2, eps=1e-10, weight_decay=0.01, w_mode=w_mode,
              noop_flag=noop, grad_scale=0.5)
    want = jfu.fused_adagrad_flat(jnp.asarray(p), jg, jnp.asarray(h), **kw)
    tp, th = _t(p.copy()), _t(h.copy())
    got = tfu.fused_adagrad_flat(tp, tg, th, **kw)
    assert got[0] is tp and got[1] is th
    for a, r in zip(got, want):
        _close(a, r)
    if noop:
        np.testing.assert_array_equal(_np(tp), p)
        np.testing.assert_array_equal(_np(th), h)


def test_empty_buffers():
    """n == 0: the norm is 0, as in JAX (whose update kernels take no
    empty grid); the updates return their empty buffers."""
    e = torch.zeros(0)
    assert float(tfu.fused_l2norm(e)) == float(
        jfu.fused_l2norm(jnp.zeros((0,), jnp.float32))) == 0.0
    m, v, u = tfu.fused_lamb_phase1_flat(
        e, e, e.clone(), e.clone(), beta1=0.9, beta2=0.999, eps=1e-6,
        weight_decay=0.01, step=1.0)
    assert u.shape == m.shape == v.shape == (0,)
    p, b = tfu.fused_sgd_flat(e, e, e.clone(), lr=0.1, momentum=0.9,
                              dampening=0.0, weight_decay=0.0)
    assert p is e and b.shape == (0,)
    p, h = tfu.fused_adagrad_flat(e, e, e.clone(), lr=0.1, eps=1e-10,
                                  weight_decay=0.0)
    assert p is e and h.shape == (0,)


def test_broadcast_leaf_scalars_matches_jax():
    s = np.array([1.5, -2.0, 3.25], np.float32)
    sizes = (4, 1, 7)
    np.testing.assert_array_equal(
        _np(broadcast_leaf_scalars(_t(s), sizes)),
        np.asarray(jbroadcast(jnp.asarray(s), sizes)))
    assert broadcast_leaf_scalars(_t(s), ()).shape == (0,)


# -- the rules through make_train_step -------------------------------------

def _tloss(m, b):
    return m(b["tokens"], b["labels"])


#: (factory, kwargs, sign-like): a sign-like rule's first steps move an
#: element by about lr whatever the size of its grad (Adagrad's
#: g / sqrt(g^2)), so an element whose grad sits at the two sides' noise
#: level may move the other way
RULES = {
    "lamb": ("fused_lamb", dict(lr=1e-3, weight_decay=0.01), False),
    "nvlamb": ("fused_lamb", dict(lr=1e-3, weight_decay=0.01,
                                  use_nvlamb=True), False),
    "lamb_noclip": ("fused_lamb", dict(lr=1e-3, max_grad_norm=0.0,
                                       bias_correction=False,
                                       grad_averaging=False), False),
    "sgd": ("fused_sgd", dict(lr=0.1, momentum=0.9, nesterov=True,
                              weight_decay=0.01), False),
    "sgd_wd_after": ("fused_sgd", dict(lr=0.1, momentum=0.9, dampening=0.1,
                                       weight_decay=0.01,
                                       wd_after_momentum=True), False),
    "adagrad": ("fused_adagrad", dict(lr=1e-2, weight_decay=0.01), True),
    "adagrad_w": ("fused_adagrad", dict(lr=1e-2, weight_decay=0.01,
                                        adagrad_w_mode=True), True),
    "novograd": ("fused_novograd", dict(lr=1e-3, weight_decay=0.01),
                 False),
}


def _slot_items(slots):
    return sorted(slots.items())


def _agree(got, want, sign_like: bool, bound: float):
    """Within 1e-5 of the buffer's largest magnitude, element for
    element; for a sign-like rule all but 1% of the elements, and every
    element within ``bound`` (twice the steps taken so far)."""
    got, want = _np(got), np.asarray(want, np.float32)
    diff = np.abs(got - want)
    tol = 1e-5 * max(float(np.abs(want).max()), 1e-30)
    if not sign_like:
        assert diff.max() <= tol, (diff.max(), tol)
        return
    assert np.mean(diff > tol) <= 1e-2, np.mean(diff > tol)
    assert diff.max() <= bound, (diff.max(), bound)


@pytest.mark.parametrize("rule", sorted(RULES))
def test_three_train_steps_match_jax(llama, rule):
    """make_train_step with loss_scale="dynamic": losses, scale, count,
    master and every slot after each of three steps."""
    jmodel, tree, tokens, labels = llama
    factory, kw, sign_like = RULES[rule]
    jtx = getattr(jfunctional, factory)(**kw)
    ttx = getattr(tfunctional, factory)(**kw)
    jstate = jtrain.init_train_state(jtx, tree, loss_scale="dynamic")
    jstep = jax.jit(jtrain.make_train_step(_jax_loss(jmodel), jtx))
    tstate = ttrain.init_train_state(ttx, _torch_model(tree),
                                     loss_scale="dynamic")
    tstep = ttrain.make_train_step(_tloss, ttx)
    jb = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    tb = {"tokens": _t(tokens), "labels": _t(labels)}
    assert sorted(tstate.opt.slots) == sorted(jstate.opt.slots)
    assert tstate.opt.offsets == jstate.opt.offsets
    losses = []
    for i in range(3):
        jstate, jloss = jstep(jstate, jb)
        tstate, tloss = tstep(tstate, tb)
        assert abs(float(tloss) - float(jloss)) <= 1e-5 * max(
            1.0, float(jloss))
        assert float(tstate.scaler.loss_scale) == float(
            jstate.scaler.loss_scale)
        assert float(tstate.opt.count) == float(jstate.opt.count) == i + 1
        bound = 2 * kw["lr"] * (i + 1)
        _agree(tstate.opt.master, jstate.opt.master, sign_like, bound)
        for name in tstate.opt.slots:
            _agree(tstate.opt.slots[name], jstate.opt.slots[name],
                   sign_like, bound)
        losses.append(float(tloss))
    assert losses[2] < losses[0]


@pytest.mark.parametrize("rule", ["lamb", "sgd", "adagrad"])
def test_overflow_step_skips_and_backs_off_scale(llama, rule):
    """A non-finite grad is caught by the fused unscale flag and skipped
    by the rule's kernel noop: master and slots bit-identical, the count
    advanced, the scale halved — as the JAX step does it."""
    jmodel, tree, tokens, labels = llama
    factory, kw, _ = RULES[rule]

    def jloss(p, b):
        return _jax_loss(jmodel)(p, b) + jnp.sum(
            p["final_norm"]["weight"]) * b["poison"]

    def tloss(m, b):
        return _tloss(m, b) + m.final_norm.weight.sum() * b["poison"]

    jtx = getattr(jfunctional, factory)(**kw)
    ttx = getattr(tfunctional, factory)(**kw)
    jstate = jtrain.init_train_state(jtx, tree, loss_scale="dynamic")
    jstep = jax.jit(jtrain.make_train_step(jloss, jtx))
    tstate = ttrain.init_train_state(ttx, _torch_model(tree),
                                     loss_scale="dynamic")
    tstep = ttrain.make_train_step(tloss, ttx)
    clean = {"tokens": tokens, "labels": labels, "poison": np.float32(0.0)}
    poisoned = dict(clean, poison=np.float32(1e38))
    for batch in (clean, poisoned):
        jbefore = jstate.opt
        jstate, _ = jstep(jstate, {k: jnp.asarray(v)
                                   for k, v in batch.items()})
        if batch is poisoned:
            before = [tstate.opt.master.clone()] + [
                t.clone() for _, t in _slot_items(tstate.opt.slots)]
            scale_before = float(tstate.scaler.loss_scale)
        tstate, _ = tstep(tstate, {k: _t(np.asarray(v))
                                   for k, v in batch.items()})
    after = [tstate.opt.master] + [t for _, t in
                                   _slot_items(tstate.opt.slots)]
    jafter = [jstate.opt.master] + [t for _, t in
                                    _slot_items(jstate.opt.slots)]
    jprev = [jbefore.master] + [t for _, t in _slot_items(jbefore.slots)]
    for a, b, ja, jb_ in zip(after, before, jafter, jprev):
        assert torch.equal(a, b)
        np.testing.assert_array_equal(np.asarray(ja), np.asarray(jb_))
    assert float(tstate.opt.count) == float(jstate.opt.count) == 2.0
    assert float(tstate.scaler.loss_scale) == scale_before * 0.5 == float(
        jstate.scaler.loss_scale)


def test_sgd_noop_first_step_does_not_seed_momentum(llama):
    """The first EFFECTIVE step seeds the momentum buffer: an
    overflow-skipped step 1 leaves 'seeded' at 0, so step 2 still seeds
    it with the direction (torch semantics), as in JAX."""
    _, tree, _, _ = llama
    jtx = jfunctional.fused_sgd(lr=0.1, momentum=0.9)
    ttx = tfunctional.fused_sgd(lr=0.1, momentum=0.9)
    jst, tst = jtx.init(tree), ttx.init(_torch_model(tree))
    g = np.random.RandomState(9).randn(tst.global_numel).astype(np.float32)
    for noop in (1.0, 0.0):
        jst = jtx.update(jst, jnp.asarray(g), noop_flag=noop)
        tst = ttx.update(tst, _t(g), noop_flag=torch.tensor(noop))
        assert float(tst.slots["seeded"]) == float(
            jst.slots["seeded"]) == 1.0 - noop
    _close(tst.slots["momentum_buffer"], jst.slots["momentum_buffer"])
    _close(tst.master, jst.master)


# -- the grad clipper -------------------------------------------------------

@pytest.mark.parametrize("norm_type", [2.0, float("inf"), 1.5])
@pytest.mark.parametrize("max_norm", [1.0, 1e4])
def test_clip_grad_norm_matches_jax(norm_type, max_norm):
    rng = np.random.RandomState(10)
    tree = {"a": rng.randn(33).astype(np.float32) * 4,
            "b": {"c": rng.randn(5, 7).astype(np.float32)}}
    jout, jnorm = jclip(jax.tree_util.tree_map(jnp.asarray, tree), max_norm,
                        norm_type)
    tout, tnorm = clip_grad_norm_({"a": _t(tree["a"]),
                                   "b": {"c": _t(tree["b"]["c"])}},
                                  max_norm, norm_type)
    assert abs(float(tnorm) - float(jnorm)) <= 1e-5 * float(jnorm)
    _close(tout["a"], jout["a"])
    _close(tout["b"]["c"], jout["b"]["c"])
    assert tout["b"]["c"].shape == (5, 7)
    # a bare flat buffer (what grad_transform hands it) stays flat
    flat = np.concatenate([tree["a"], tree["b"]["c"].reshape(-1)])
    fout, fnorm = clip_grad_norm_(_t(flat), max_norm, norm_type)
    assert fout.shape == flat.shape and float(fnorm) == float(tnorm)
    _close(fout, np.concatenate([np.asarray(jout["a"]),
                                 np.asarray(jout["b"]["c"]).reshape(-1)]))


@pytest.mark.parametrize("norm_type", [float("inf"), 3.0])
def test_clip_grad_norm_bf16_grads_keep_their_dtype_like_jax(norm_type):
    """bf16 grads: the inf-norm and the p-norm are taken in the grads'
    dtype, as the JAX package's jnp reductions take them (an fp32 norm
    read 23.07 where JAX reads 23.25 on these 1000 grads at p = 3).  The
    norm is bf16 on both sides and within one bf16 rounding step (2^-8
    relative: the sums may round in another order); the clipped grads
    within one bf16 step of the largest."""
    g = (np.random.RandomState(12).randn(1000) * 2).astype(np.float32)
    jout, jnorm = jclip(jnp.asarray(g, dtype=jnp.bfloat16), 1.0, norm_type)
    tout, tnorm = clip_grad_norm_(_t(g).to(torch.bfloat16), 1.0, norm_type)
    assert tnorm.dtype == torch.bfloat16 and jnorm.dtype == jnp.bfloat16
    jn = float(jnorm)
    assert abs(float(tnorm) - jn) <= 2.0 ** -8 * jn
    assert tout.dtype == torch.bfloat16
    want = np.asarray(jout, np.float32)
    assert np.abs(tout.float().numpy() - want).max() <= \
        2.0 ** -8 * np.abs(want).max()


@pytest.mark.parametrize("error_if_nonfinite", [False, True])
def test_clip_grad_norm_nonfinite(error_if_nonfinite):
    g = np.ones(10, np.float32)
    g[3] = np.inf
    _, jnorm = jclip(jnp.asarray(g), 1.0,
                     error_if_nonfinite=error_if_nonfinite)
    _, tnorm = clip_grad_norm_(_t(g), 1.0,
                               error_if_nonfinite=error_if_nonfinite)
    assert np.isnan(float(jnorm)) == np.isnan(float(tnorm)) \
        == error_if_nonfinite
    if not error_if_nonfinite:
        assert float(tnorm) == float(jnorm) == np.inf


def test_clip_grad_norm_as_grad_transform_matches_jax(llama):
    """SGD with the clipper as make_train_step's grad_transform, no loss
    scale: two steps against the JAX step."""
    jmodel, tree, tokens, labels = llama
    jtx = jfunctional.fused_sgd(lr=0.5, momentum=0.9, nesterov=True)
    ttx = tfunctional.fused_sgd(lr=0.5, momentum=0.9, nesterov=True)
    jstate = jtrain.init_train_state(jtx, tree)
    jstep = jax.jit(jtrain.make_train_step(
        _jax_loss(jmodel), jtx, grad_transform=lambda g: jclip(g, 0.1)[0]))
    tstate = ttrain.init_train_state(ttx, _torch_model(tree))
    tstep = ttrain.make_train_step(
        _tloss, ttx, grad_transform=lambda g: clip_grad_norm_(g, 0.1)[0])
    for _ in range(2):
        jstate, jloss = jstep(jstate, {"tokens": jnp.asarray(tokens),
                                       "labels": jnp.asarray(labels)})
        tstate, tloss = tstep(tstate, {"tokens": _t(tokens),
                                       "labels": _t(labels)})
        assert abs(float(tloss) - float(jloss)) <= 1e-5 * float(jloss)
        _close(tstate.opt.master, jstate.opt.master)


@pytest.mark.parametrize("rule", ["lamb", "sgd", "adagrad", "novograd"])
def test_cpu_training_with_each_rule_launches_nothing(llama, rule):
    _, tree, tokens, labels = llama
    factory, kw, _ = RULES[rule]
    _build.reset_launch_counts()
    tx = getattr(tfunctional, factory)(**kw)
    state = ttrain.init_train_state(tx, _torch_model(tree),
                                    loss_scale="dynamic")
    step = ttrain.make_train_step(
        _tloss, tx, grad_transform=lambda g: clip_grad_norm_(g, 1.0)[0])
    state, loss = step(state, {"tokens": _t(tokens), "labels": _t(labels)})
    assert torch.isfinite(loss) and float(state.opt.count) == 1.0
    assert set(_build.launch_counts().values()) == {0}
    assert _build._LIB is None
