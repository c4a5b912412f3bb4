"""Port parity for the optimizer class API over trees of tensors: the six
classes (``FusedAdam``, ``FusedLAMB``, ``FusedSGD``, ``FusedAdagrad``,
``FusedNovoGrad``, ``FusedMixedPrecisionLamb``) against the JAX
package's classes on the same numpy inputs (CPU, fp32 masters).

The JAX side runs as its own tests run it: the flat update kernels in
Pallas interpret mode.  The tree mixes bf16 and fp32 leaves in nested
dicts and a list; the grads are seeded numpy arrays given to both sides,
so both updates see the same inputs bit for bit.

Tolerances: the master and every slot within 1e-5 of the buffer's
largest magnitude after each step (the same fp32 arithmetic in another
order, and LAMB's norms summed in another order); the returned params
within that rule in fp32 leaves and within one bf16 ulp of the
magnitude in bf16 leaves; the step count, state-dict keys and a
skipped (noop) step exactly.
"""
import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import apex_tpu.optimizers as jopt
from apex_tpu.optimizers import fused_lamb as jfused_lamb
import apex_tpu_torch.optimizers as topt
from apex_tpu_torch.ops import _build
from apex_tpu_torch.optimizers import fused_lamb as tfused_lamb

from _torch_isolation import restore_torch_from_amp  # noqa: F401

#: name -> constructor keywords (per-group overrides come on top)
CLASSES = {
    "FusedAdam": dict(lr=1e-2, weight_decay=0.01),
    "FusedLAMB": dict(lr=1e-2, weight_decay=0.01, max_grad_norm=1.0),
    "FusedSGD": dict(lr=0.05, momentum=0.9, nesterov=True,
                     weight_decay=1e-3),
    "FusedAdagrad": dict(lr=1e-2, weight_decay=0.01),
    "FusedNovoGrad": dict(lr=1e-2, weight_decay=0.01),
    "FusedMixedPrecisionLamb": dict(lr=1e-2, step=3, weight_decay=0.01),
}
#: each group's tree: (shape, dtype) leaves in nested dicts and a list
GROUPS = (
    {"attn": {"w": ((24, 16), "bfloat16"), "b": ((24,), "float32")},
     "mlp": [((16, 40), "bfloat16"), ((40,), "float32")]},
    {"norm": ((16,), "float32"), "head": ((7, 16), "bfloat16")},
)


def _tree(spec, seed, scale=1.0):
    """The numpy tree of one group, ``(array, dtype)`` leaves, drawn in
    leaf order (bf16 leaves rounded to bf16 values)."""
    rng = np.random.RandomState(seed)

    def draw(node):
        if isinstance(node, dict):
            return {k: draw(node[k]) for k in sorted(node)}
        if isinstance(node, list):
            return [draw(v) for v in node]
        shape, dtype = node
        a = (rng.randn(*shape) * scale).astype(np.float32)
        if dtype == "bfloat16":
            a = np.asarray(jnp.asarray(a).astype(jnp.bfloat16)
                           .astype(jnp.float32))
        return a, dtype

    return draw(spec)


def _side(tree, jax_side):
    if isinstance(tree, dict):
        return {k: _side(v, jax_side) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_side(v, jax_side) for v in tree]
    a, dtype = tree
    if jax_side:
        return jnp.asarray(a).astype(getattr(jnp, dtype))
    return torch.from_numpy(a.copy()).to(getattr(torch, dtype))


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, what):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()) if want.size else 0.0, 1e-30)
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= 1e-5 * scale, (what, err, scale)


def _close_params(got, want, what):
    for i, (g, w) in enumerate(zip(_leaves(got), _leaves(want))):
        if isinstance(g, torch.Tensor) and g.dtype == torch.bfloat16:
            w = _np(w)
            err = float(np.abs(_np(g) - w).max())
            assert err <= 2.0 ** -8 * max(float(np.abs(w).max()), 1e-30), (
                what, i, err)
        else:
            _close(g, w, (what, i))


def _close_groups(tclass, jclass, what):
    assert len(tclass.param_groups) == len(jclass.param_groups)
    for gi, (tg, jg) in enumerate(zip(tclass.param_groups,
                                      jclass.param_groups)):
        _close(tg.master, jg.master, (what, gi, "master"))
        assert sorted(tg.state) == sorted(jg.state), (what, gi)
        for k in tg.state:
            _close(tg.state[k], jg.state[k], (what, gi, k))


def _pair(name, kw, groups, **over):
    trees = [_tree(g, seed=10 + i) for i, g in enumerate(groups)]

    def make(mod, jax_side):
        params = [{"params": _side(t, jax_side), **dict(over, lr=0.5 * kw[
            "lr"] * (i + 1))} for i, t in enumerate(trees)]
        if len(params) == 1:
            params = params[0]["params"]
        return getattr(mod, name)(params, **kw)

    return make(topt, False), make(jopt, True)


def _grads(groups, step, scale=1e-1):
    trees = [_tree(g, seed=100 * step + i, scale=scale)
             for i, g in enumerate(groups)]
    t = [_side(tr, False) for tr in trees]
    j = [_side(tr, True) for tr in trees]
    return (t, j) if len(groups) > 1 else (t[0], j[0])


@pytest.mark.parametrize("name", sorted(CLASSES))
def test_class_matches_jax_two_groups_lr_change_noop_and_scale(name):
    """Two param groups with overrides; lr changed between steps; a
    grad_scale; a noop step that keeps every buffer bit for bit and
    advances the count (as JAX does)."""
    kw = CLASSES[name]
    t, j = _pair(name, kw, GROUPS, weight_decay=0.02)
    assert type(t) is getattr(topt, name)
    assert not isinstance(t, torch.optim.Optimizer)
    calls = [dict(), dict(grad_scale=0.5), dict(noop_flag=1.0), dict()]
    for step, call in enumerate(calls, start=1):
        if step == 3:
            for g in t.param_groups + j.param_groups:
                g.options["lr"] *= 0.5
            before = [(g.master.clone(), {k: v.clone() for k, v in
                                          g.state.items()})
                      for g in t.param_groups]
        tg, jg = _grads(GROUPS, step)
        tcall = {k: (torch.tensor(v) if k == "noop_flag" else v)
                 for k, v in call.items()}
        tout = t.step(tg, **tcall)
        jout = j.step(jg, **call)
        assert t.step_count == j.step_count
        for gi in range(len(GROUPS)):
            _close_params(tout[gi], jout[gi], (name, step, gi))
        _close_groups(t, j, (name, step))
        if call.get("noop_flag"):
            for g, (m, st) in zip(t.param_groups, before):
                assert torch.equal(g.master, m)
                for k, v in st.items():
                    if v.dim():
                        assert torch.equal(g.state[k], v), k


@pytest.mark.parametrize("name", sorted(CLASSES))
def test_class_state_dict_round_trip_then_steps_agree(name):
    kw = CLASSES[name]
    groups = GROUPS[:1]
    t, j = _pair(name, kw, groups)
    for step in (1, 2):
        tg, jg = _grads(groups, step)
        t.step(tg)
        j.step(jg)
    tsd, jsd = t.state_dict(), j.state_dict()
    assert tsd["step"] == jsd["step"]
    assert [sorted(g["state"]) for g in tsd["groups"]] == [
        sorted(g["state"]) for g in jsd["groups"]]
    assert [sorted(g["options"]) for g in tsd["groups"]] == [
        sorted(g["options"]) for g in jsd["groups"]]
    # the checkpoint is a copy: the next step does not change it
    keep = copy.deepcopy(tsd)
    t2, j2 = _pair(name, kw, groups)
    t2.load_state_dict(tsd)
    j2.load_state_dict(jsd)
    for step in (3, 4):
        tg, jg = _grads(groups, step)
        tout = t2.step(tg)
        jout = j2.step(jg)
        _close_params(tout, jout, (name, step))
        _close_groups(t2, j2, (name, step))
    for a, b in zip(keep["groups"], tsd["groups"]):
        assert torch.equal(a["master"], b["master"])
    # and the loaded optimizer owns its buffers
    assert t2.param_groups[0].master.data_ptr() != \
        tsd["groups"][0]["master"].data_ptr()


def test_sgd_checkpoint_without_seeded_flag_loads_as_jax():
    """Older checkpoints lack SGD's "seeded" flag: a step already taken
    seeded the buffer; a checkpoint at step 0 has not."""
    kw = CLASSES["FusedSGD"]
    groups = GROUPS[:1]
    for steps_before in (0, 1):
        t, j = _pair("FusedSGD", kw, groups)
        for step in range(1, steps_before + 1):
            tg, jg = _grads(groups, step)
            t.step(tg)
            j.step(jg)
        tsd, jsd = t.state_dict(), j.state_dict()
        for sd in (tsd, jsd):
            del sd["groups"][0]["state"]["seeded"]
        t2, j2 = _pair("FusedSGD", kw, groups)
        t2.load_state_dict(tsd)
        j2.load_state_dict(jsd)
        for step in (5, 6):
            tg, jg = _grads(groups, step)
            _close_params(t2.step(tg), j2.step(jg), (steps_before, step))
            _close_groups(t2, j2, (steps_before, step))
        assert float(t2.param_groups[0].state["seeded"]) == float(
            j2.param_groups[0].state["seeded"]) == 1.0


def test_mixed_precision_lamb_resumes_at_its_step():
    kw = dict(CLASSES["FusedMixedPrecisionLamb"], step=7)
    t, j = _pair("FusedMixedPrecisionLamb", kw, GROUPS[:1])
    assert t.step_count == j.step_count == 7
    tg, jg = _grads(GROUPS[:1], 1)
    _close_params(t.step(tg), j.step(jg), "step 8")
    assert t.step_count == j.step_count == 8
    _close_groups(t, j, "step 8")
    # the bias corrections saw step 8, not step 1
    ref, _ = _pair("FusedLAMB", CLASSES["FusedLAMB"], GROUPS[:1])
    ref.step(tg)
    assert not torch.equal(ref.param_groups[0].master,
                           t.param_groups[0].master)


@pytest.mark.parametrize("nvlamb", [False, True])
@pytest.mark.parametrize("noop", [0.0, 1.0])
def test_lamb_step_flat_args_matches_jax(nvlamb, noop):
    rng = np.random.RandomState(5)
    sizes = (96, 17, 640, 3)
    n = sum(sizes)
    offsets = tuple(int(o) for o in np.cumsum((0,) + sizes[:-1]))
    p, g, m = (rng.randn(n).astype(np.float32) for _ in range(3))
    v = np.abs(rng.randn(n)).astype(np.float32)
    args = dict(step=3.0, lr=1e-2, beta1=0.9, beta2=0.999, eps=1e-6,
                weight_decay=0.01, max_grad_norm=1.0, noop_flag=noop,
                grad_scale=0.5)
    static = dict(bias_correction=True, offsets=offsets, sizes=sizes,
                  use_nvlamb=nvlamb, grad_averaging=True)
    want = jfused_lamb._lamb_step(
        *(jnp.asarray(a) for a in (p, m, v, g)),
        *(jnp.float32(args[k]) for k in (
            "step", "lr", "beta1", "beta2", "eps", "weight_decay",
            "max_grad_norm", "noop_flag", "grad_scale")), **static)
    tp, tm, tv = (torch.from_numpy(a.copy()) for a in (p, m, v))
    got = tfused_lamb._lamb_step(
        tp, tm, tv, torch.from_numpy(g),
        *(torch.tensor(args[k]) for k in (
            "step", "lr", "beta1", "beta2", "eps", "weight_decay",
            "max_grad_norm", "noop_flag", "grad_scale")), **static)
    assert got[0] is tp and got[1] is tm and got[2] is tv    # in place
    for a, b in zip(got, want):
        _close(a, b, "lamb step")
    if noop:
        for a, before in zip(got, (p, m, v)):
            np.testing.assert_array_equal(a.numpy(), before)


def test_cpu_class_steps_launch_nothing():
    _build.reset_launch_counts()
    for name, kw in CLASSES.items():
        t, _ = _pair(name, kw, GROUPS)
        t.step(_grads(GROUPS, 1)[0])
    assert set(_build.launch_counts().values()) == {0}


def test_class_rebuilds_its_rule_from_the_current_options():
    """A static knob changed between steps takes effect (JAX rebuilds
    its transform from the options on every step)."""
    kw = CLASSES["FusedAdam"]
    t, j = _pair("FusedAdam", kw, GROUPS[:1])
    tg, jg = _grads(GROUPS[:1], 1)
    t.step(tg)
    j.step(jg)
    for opt in (t, j):
        opt.param_groups[0].options["bias_correction"] = False
    tg, jg = _grads(GROUPS[:1], 2)
    _close_params(t.step(tg), j.step(jg), "no bias correction")
    _close_groups(t, j, "no bias correction")
