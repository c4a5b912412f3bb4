"""Port parity for the torch-mode twins (``FusedAdam(model.parameters())``
and its siblings) against the JAX package's twins
(``apex_tpu.optimizers._torch_mode``, plain PyTorch on the CPU), each
driving a copy of one model through ``loss.backward(); step()``.

The model is the training slice's tiny LLaMA (hidden 128, 4 heads over
2 kv heads, 2 layers, vocab 256, sequence 64, batch 2), fp32 for the
rounds held to the tolerances below; both sides compute the same forward
and backward on the CPU (the port's plain versions).  A copy with bf16
linears and fp32 norm weights checks that half parameters keep fp32
masters (its first step sees the same grads on both sides; later ones
do not, since a master a few ulps apart can round a bf16 weight the
other way).

Tolerances (fp32): masters and every slot within 1e-5 of the buffer's
largest magnitude after each of three steps (the same fp32 update in
another order; after the first step the two models differ by that much,
and so do their grads), with the Adagrad clause of
``test_torch_optimizers.py`` for Adagrad's masters and parameters (its
first step moves an element by about lr * sign(g), so an element whose
grad sits at the two sides' noise level may move the other way: all
but 1% of the elements within 1e-5, every one within 2 lr per step);
``exp_avg_sq`` within 2e-5, because the rules
take (1 - beta2) in fp32 from an fp32 beta2 (1 - 0.999f = 0.00099998713)
where the JAX twins take it in double (0.001): 1.3e-5 of the buffer
from the first step on.  bf16 parameters within one bf16 ulp of the
tensor's magnitude.  Routing, state-dict keys and shapes, step counts
and the skip of a parameter with no grad: exact.
"""
import copy

import numpy as np
import pytest
import torch

import apex_tpu.optimizers as jopt
import apex_tpu_torch.optimizers as topt
from apex_tpu_torch.ops import _build
from apex_tpu_torch.optimizers import _torch_mode
from apex_tpu_torch.transformer.testing import (LlamaConfig,
                                                llama_model_provider)

from _torch_isolation import restore_torch_from_amp  # noqa: F401
from test_torch_training import BATCH, CFG, SEQ

STEPS = 3

#: name -> constructor keywords
TWINS = {
    "FusedAdam": dict(lr=1e-3, weight_decay=0.01),
    "FusedLAMB": dict(lr=1e-3, weight_decay=0.01, max_grad_norm=1.0),
    "FusedSGD": dict(lr=0.05, momentum=0.9, nesterov=True,
                     weight_decay=1e-3),
    "FusedAdagrad": dict(lr=1e-2, weight_decay=0.01),
    "FusedNovoGrad": dict(lr=1e-3, weight_decay=0.01),
    "FusedMixedPrecisionLamb": dict(lr=1e-3, step=3, weight_decay=0.01),
}


def _model(dtype):
    cfg = LlamaConfig(**dict(CFG, params_dtype=dtype))
    model = llama_model_provider(cfg, device="cpu")
    model.reset_parameters(generator=torch.Generator().manual_seed(0))
    rng = np.random.RandomState(8)
    tokens = rng.randint(0, CFG["vocab_size"], (BATCH, SEQ + 1))
    return model, torch.from_numpy(tokens[:, :-1].copy()), \
        torch.from_numpy(tokens[:, 1:].copy())


@pytest.fixture(scope="module")
def base_model():
    return _model(torch.float32)


@pytest.fixture(scope="module")
def half_model():
    return _model(torch.bfloat16)


def _loss(model, tokens, labels):
    return model(tokens, labels)


def _groups(model, split):
    """All parameters, or BERT's decay / no-decay split (norm weights
    without decay)."""
    params = list(model.parameters())
    if not split:
        return params
    names = [n for n, _ in model.named_parameters()]
    return [{"params": [p for n, p in zip(names, params) if "norm" not in n]},
            {"params": [p for n, p in zip(names, params) if "norm" in n],
             "weight_decay": 0.0}]


def _pair(base_model, name, split=False, **over):
    model, tokens, labels = base_model
    kw = dict(TWINS[name], **over)
    mt, mj = copy.deepcopy(model), copy.deepcopy(model)
    ot = getattr(topt, name)(_groups(mt, split), **kw)
    oj = getattr(jopt, name)(_groups(mj, split), **kw)
    assert type(ot).__name__ == type(oj).__name__ == f"{name}Torch"
    assert type(ot) is getattr(_torch_mode, f"{name}Torch")
    return (mt, ot), (mj, oj), (tokens, labels)


def _round(model, opt, batch, set_to_none=None, skip=(), **step_kw):
    opt.zero_grad() if set_to_none is None else opt.zero_grad(set_to_none)
    _loss(model, *batch).backward()
    for p in skip:
        p.grad = None
    opt.step(**step_kw)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, what, tol=1e-5, sign_lr=None):
    """``got`` within ``tol`` of ``want``'s largest magnitude; with
    ``sign_lr`` (Adagrad's lr), all but 1% of the elements so and every
    element within 2 lr per step."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()) if want.size else 0.0, 1e-30)
    diff = np.abs(got - want)
    err = float(diff.max()) if want.size else 0.0
    if sign_lr is None:
        assert err <= tol * scale, (what, err, scale)
    else:
        assert np.mean(diff > tol * scale) <= 1e-2, (what, err, scale)
        assert err <= 2 * sign_lr * STEPS + tol * scale, (what, err)


def _sign_lr(name):
    return TWINS[name]["lr"] if name == "FusedAdagrad" else None


def _same_state(ot, oj, name, what):
    st, sj = ot.state_dict(), oj.state_dict()
    assert sorted(st["state"]) == sorted(sj["state"]), what
    for idx, entry in sj["state"].items():
        mine = st["state"][idx]
        assert sorted(mine) == sorted(entry), (what, idx)
        for k, v in entry.items():
            if k == "step":
                assert mine[k] == v, (what, idx)
            else:
                assert np.shape(_np(mine[k])) == np.shape(_np(v)), (what, k)
                _close(mine[k], v, (what, idx, k),
                       2e-5 if k == "exp_avg_sq" else 1e-5,
                       _sign_lr(name) if k == "master" else None)
    assert [{k: v for k, v in g.items() if k != "params"}
            for g in st["param_groups"]] == [
        {k: v for k, v in g.items() if k != "params"}
        for g in sj["param_groups"]]


def _same_params(mt, mj, name, what):
    for (n, a), b in zip(mt.named_parameters(), mj.parameters()):
        assert a.dtype == b.dtype, n
        if a.dtype == torch.bfloat16 and name != "FusedAdagrad":
            w = _np(b)
            err = float(np.abs(_np(a) - w).max())
            assert err <= 2.0 ** -8 * max(float(np.abs(w).max()), 1e-30), (
                what, n, err)
        else:
            _close(a, b, (what, n), sign_lr=_sign_lr(name))


@pytest.mark.parametrize("name", sorted(TWINS))
def test_twin_matches_jax_twin_over_three_rounds(base_model, name):
    (mt, ot), (mj, oj), batch = _pair(base_model, name)
    for step, kw in enumerate([{}, {"grad_scale": 0.5}, {}], start=1):
        _round(mt, ot, batch, **kw)
        _round(mj, oj, batch, **kw)
        _same_params(mt, mj, name, (name, step))
        _same_state(ot, oj, name, (name, step))


@pytest.mark.parametrize("name", sorted(TWINS))
def test_half_params_keep_fp32_masters_and_state_is_views(half_model, name):
    (mt, ot), (mj, oj), batch = _pair(half_model, name)
    _round(mt, ot, batch)
    _round(mj, oj, batch)
    _same_state(ot, oj, name, "half")
    _same_params(mt, mj, name, "half")
    fg = ot._groups[0]
    master = fg.master.untyped_storage().data_ptr()
    grads = fg.flat.grad_bytes.untyped_storage().data_ptr()
    for p in mt.parameters():
        st = ot.state[p]
        assert p.grad.untyped_storage().data_ptr() == grads
        if p.dtype == torch.float32:
            # an fp32 parameter is its own master
            assert "master" not in st
            assert p.untyped_storage().data_ptr() == master
        else:
            assert st["master"].dtype == torch.float32
            assert st["master"].untyped_storage().data_ptr() == master
            assert st["master"].shape == p.shape
            assert torch.equal(st["master"].to(p.dtype), p)
        for k, v in st.items():
            if torch.is_tensor(v) and k != "master":
                assert v.dtype == torch.float32, k
                assert v.untyped_storage().data_ptr() == \
                    fg.slots[k].untyped_storage().data_ptr(), k


@pytest.mark.parametrize("name", ["FusedAdam", "FusedLAMB", "FusedSGD",
                                  "FusedNovoGrad"])
def test_param_without_grad_is_untouched_and_its_step_stays(base_model,
                                                             name):
    """Two parameters in the middle of the list lose their grad in round
    two: they stay bit for bit, their step does not advance, and the
    rest run as three runs of the rule (before, between and after)."""
    (mt, ot), (mj, oj), batch = _pair(base_model, name)
    _round(mt, ot, batch)
    _round(mj, oj, batch)
    tparams, jparams = list(mt.parameters()), list(mj.parameters())
    skip_i = (3, 7)
    before = [tparams[i].detach().clone() for i in skip_i]
    _round(mt, ot, batch, skip=[tparams[i] for i in skip_i])
    _round(mj, oj, batch, skip=[jparams[i] for i in skip_i])
    for i, b in zip(skip_i, before):
        assert torch.equal(tparams[i], b)
        if "step" in ot.state[tparams[i]]:
            assert ot.state[tparams[i]]["step"] == 1
            assert ot.state[tparams[0]]["step"] == 2
    _same_params(mt, mj, name, name)
    _same_state(ot, oj, name, name)
    # a third round: the skipped parameters run at their own step count
    _round(mt, ot, batch)
    _round(mj, oj, batch)
    _same_params(mt, mj, name, name)
    _same_state(ot, oj, name, name)


@pytest.mark.parametrize("set_to_none", [True, False])
def test_zero_grad_modes_keep_the_bound_views(base_model, set_to_none):
    (mt, ot), (mj, oj), batch = _pair(base_model, "FusedAdam")
    fg = ot._groups[0]
    grads = fg.flat.grad_bytes.untyped_storage().data_ptr()
    for _ in range(3):
        _round(mt, ot, batch, set_to_none=set_to_none)
        _round(mj, oj, batch, set_to_none=set_to_none)
        for p, gv in zip(mt.parameters(), fg.flat.grad_views):
            assert p.grad is gv
    _same_params(mt, mj, "FusedAdam", set_to_none)
    ot.zero_grad(set_to_none=set_to_none)
    for p, gv in zip(mt.parameters(), fg.flat.grad_views):
        if set_to_none:
            assert p.grad is None
        else:
            # the views survive and are zero
            assert p.grad is gv and not p.grad.any()
    if not set_to_none:
        # autograd accumulates into the views: no fresh grad is made
        _loss(mt, *batch).backward()
        for p, gv in zip(mt.parameters(), fg.flat.grad_views):
            assert p.grad is gv
            assert p.grad.untyped_storage().data_ptr() == grads


@pytest.mark.parametrize("max_grad_norm", [1e-2, 1e3])
def test_lamb_clips_by_the_global_norm_across_groups(base_model,
                                                     max_grad_norm):
    (mt, ot), (mj, oj), batch = _pair(base_model, "FusedLAMB", split=True,
                                      max_grad_norm=max_grad_norm)
    assert len(ot.param_groups) == 2
    for _ in range(3):
        _round(mt, ot, batch)
        _round(mj, oj, batch)
        _same_params(mt, mj, "FusedLAMB", max_grad_norm)
        _same_state(ot, oj, "FusedLAMB", max_grad_norm)


@pytest.mark.parametrize("name", sorted(TWINS))
def test_checkpoints_cross_load_between_port_and_jax(base_model, name):
    """state_dict keys and shapes equal the JAX twin's; each side's
    checkpoint loads into the other and further rounds agree; fp32 state
    stays fp32; the loaded state is views of the flat buffers again."""
    (mt, ot), (mj, oj), batch = _pair(base_model, name)
    _round(mt, ot, batch)
    _round(mj, oj, batch)
    tsd = copy.deepcopy(ot.state_dict())
    jsd = copy.deepcopy(oj.state_dict())
    # fresh optimizers on copies of each side's model, loading the
    # other side's checkpoint
    mt2, mj2 = copy.deepcopy(mt), copy.deepcopy(mj)
    ot2 = getattr(topt, name)(mt2.parameters(), **TWINS[name])
    oj2 = getattr(jopt, name)(mj2.parameters(), **TWINS[name])
    ot2.load_state_dict(jsd)
    oj2.load_state_dict(tsd)
    _same_state(ot2, oj2, name, "loaded")
    fg = ot2._groups[0]
    for p in mt2.parameters():
        for k, v in ot2.state[p].items():
            if torch.is_tensor(v):
                assert v.dtype == torch.float32, k
                buf = fg.master if k == "master" else fg.slots[k]
                assert v.untyped_storage().data_ptr() == \
                    buf.untyped_storage().data_ptr(), k
    # a further round from the swapped state (two rounds would put a
    # third step on state that each side's model no longer produced)
    _round(mt2, ot2, batch)
    _round(mj2, oj2, batch)
    _same_params(mt2, mj2, name, "after load")
    _same_state(ot2, oj2, name, "after load")


def test_checkpoint_demoted_to_bf16_is_upcast_on_load(base_model):
    (mt, ot), _, batch = _pair(base_model, "FusedAdam")
    _round(mt, ot, batch)
    sd = copy.deepcopy(ot.state_dict())
    for entry in sd["state"].values():
        for k in ("exp_avg", "exp_avg_sq"):
            entry[k] = entry[k].to(torch.bfloat16)
    ot.load_state_dict(sd)
    for p in mt.parameters():
        assert ot.state[p]["exp_avg"].dtype == torch.float32


# -- routing (the cases of the JAX package's test_torch_mode.py) -----------

def _small(seed=0):
    torch.manual_seed(seed)
    return torch.nn.Sequential(
        torch.nn.Linear(8, 16), torch.nn.ReLU(), torch.nn.Linear(16, 4))


def test_routing_parameters_to_twin_and_trees_to_class():
    m = _small()
    opt = topt.FusedAdam(m.parameters(), lr=1e-3)
    assert isinstance(opt, torch.optim.Optimizer)
    assert type(opt) is _torch_mode.FusedAdamTorch
    tree = topt.FusedAdam({"w": torch.ones(4, 4)}, lr=1e-3)
    assert type(tree) is topt.FusedAdam
    assert not isinstance(tree, torch.optim.Optimizer)
    # a list of plain tensors is a tree too
    assert type(topt.FusedSGD([torch.ones(3)], lr=0.1)) is topt.FusedSGD
    assert type(topt.FusedAdam(params=list(_small().parameters()))) \
        is _torch_mode.FusedAdamTorch


def test_generator_params_accepted():
    m = _small()
    opt = topt.FusedLAMB(m.parameters(), lr=1e-3)   # generator consumed once
    assert sum(len(g["params"]) for g in opt.param_groups) == 4


def test_no_torch_impl_raises_cleanly():
    class _NoTwin(topt.FusedOptimizerBase):
        def __init__(self, params):
            super().__init__(params, {})

    with pytest.raises(TypeError, match="torch-mode"):
        _NoTwin(_small().parameters())


def test_empty_first_group_still_routes_to_torch():
    m = _small()
    opt = topt.FusedAdam([{"params": []},
                          {"params": list(m.parameters())}], lr=1e-3)
    assert isinstance(opt, torch.optim.Optimizer)
    x = torch.randn(5, 8)
    m(x).sum().backward()
    opt.step()
    assert opt.state[next(m.parameters())]["step"] == 1


def test_parameter_in_two_groups_raises_as_torch_does():
    m = _small()
    p = list(m.parameters())
    with pytest.raises(ValueError, match="more than one parameter group"):
        topt.FusedAdam([{"params": p}, {"params": p[:1]}], lr=1e-3)


def test_cpu_twin_steps_launch_nothing(base_model):
    _build.reset_launch_counts()
    for name in TWINS:
        (mt, ot), _, batch = _pair(base_model, name)
        _round(mt, ot, batch)
    assert set(_build.launch_counts().values()) == {0}
