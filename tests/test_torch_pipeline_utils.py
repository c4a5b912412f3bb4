"""The pipeline slice's host-side pieces on the port against the JAX
package (CPU, one process): the microbatch calculators, the pretraining
batch samplers, ``pipeline_parallel.utils``' globals and slicing,
``build_model``, ``forward_step`` and ``backward_step``, the executor
dispatch, the no-pipelining executor, ``GradScaler`` without a topology,
and ``testing.commons``.

The port's counterparts of ``tests/L0/run_transformer/
test_microbatches.py``, ``test_batch_sampler.py`` and
``test_pipeline_common.py``'s schedule tests.  The calculators and
samplers are copies: each case runs on both packages with the same
arguments and must give the same numbers and index lists.  Tolerances:
fp32 results within 1e-5 relative of JAX's largest magnitude.
"""
import numpy as np
import pytest
import torch

from apex_tpu_torch.transformer import microbatches as tmb
from apex_tpu_torch.transformer import parallel_state as ps
from apex_tpu_torch.transformer import pipeline_parallel as tpp
from apex_tpu_torch.transformer.amp import GradScaler
from apex_tpu_torch.transformer.pipeline_parallel import utils as tutils
from apex_tpu_torch.transformer.testing import (
    IdentityLayer, MegatronPretrainingRandomSampler,
    MegatronPretrainingSampler, initialize_distributed, set_random_seed)

from _torch_isolation import restore_torch_from_amp  # noqa: F401

TOL = 1e-5
TOTAL, MBS, DP = 64, 4, 2


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) / scale <= tol


def _both(name):
    import apex_tpu.transformer.microbatches as jmb
    return getattr(tmb, name), getattr(jmb, name)


# -- the microbatch calculators ---------------------------------------------

@pytest.mark.parametrize("args", [(32, 2, 2), (16, 2, 1), (8, 8, 1)])
def test_constant_calculator_matches_jax(args):
    port, jax_cls = _both("ConstantNumMicroBatches")
    a, b = port(*args), jax_cls(*args)
    assert (a.get(), a.get_current_global_batch_size()) == \
        (b.get(), b.get_current_global_batch_size())
    a.update(1000, True)
    assert a.get() == b.get()
    with pytest.raises(AssertionError):
        port(30, 4, 2)


def test_rampup_calculator_matches_jax():
    port, jax_cls = _both("RampupBatchsizeNumMicroBatches")
    kw = dict(start_batch_size=4, batch_size_increment=4, ramup_samples=100,
              global_batch_size=16, micro_batch_size=2, data_parallel_size=1)
    a, b = port(**kw), jax_cls(**kw)
    for consumed in (0, 10, 33, 34, 50, 67, 99, 100, 101, 1000):
        a.update(consumed, True)
        b.update(consumed, True)
        assert (a.get(), a.get_current_global_batch_size()) == \
            (b.get(), b.get_current_global_batch_size()), consumed
    assert a.get() == 8 and a.get_current_global_batch_size() == 16
    with pytest.raises(AssertionError):
        port(16, 4, 100, 16, 2, 1)          # no increment to ramp


def test_calculator_factory_dispatch_matches_jax():
    port, jax_fn = _both("build_num_microbatches_calculator")
    for ramp in (None, [4, 4, 100]):
        a, b = port(0, ramp, 16, 2, 1), jax_fn(0, ramp, 16, 2, 1)
        assert type(a).__name__ == type(b).__name__
        assert a.get() == b.get()
    assert isinstance(port(0, None, 16, 2, 1), tmb.ConstantNumMicroBatches)
    assert isinstance(port(1, [4, 4, 100], 16, 2, 1),
                      tmb.RampupBatchsizeNumMicroBatches)


def test_calculator_globals_and_microbatch_slicing():
    """``setup_microbatch_calculator`` and its getters (JAX's globals),
    ``listify_model``, ``get_kth_microbatch`` over dicts, lists and
    tuples."""
    from apex_tpu.transformer.pipeline_parallel import utils as jutils
    tutils._GLOBAL_NUM_MICROBATCHES_CALCULATOR = None
    assert tpp.get_current_global_batch_size() is None
    tpp.setup_microbatch_calculator(0, [4, 4, 100], 16, 2, 1)
    try:
        jutils._reconfigure_microbatch_calculator(0, [4, 4, 100], 16, 2, 1)
        with pytest.raises(AssertionError):
            tpp.setup_microbatch_calculator(0, None, 16, 2, 1)
        for consumed in (0, 50, 101):
            tpp.update_num_microbatches(consumed)
            jutils.update_num_microbatches(consumed)
            assert tpp.get_num_microbatches() == \
                jutils.get_num_microbatches()
            assert tpp.get_current_global_batch_size() == \
                jutils.get_current_global_batch_size()
        tutils._reconfigure_microbatch_calculator(0, None, 32, 2, 2)
        assert tpp.get_num_microbatches() == 8
    finally:
        tutils._GLOBAL_NUM_MICROBATCHES_CALCULATOR = None
        jutils._GLOBAL_NUM_MICROBATCHES_CALCULATOR = None
    assert tpp.listify_model("m") == ["m"]
    assert tpp.listify_model(("a", "b")) == ["a", "b"]
    batch = {"x": torch.arange(12).reshape(6, 2),
             "pair": (torch.arange(6), [torch.ones(6, 3)])}
    k = tpp.get_kth_microbatch(batch, 1, 2)
    assert k["x"].tolist() == [[4, 5], [6, 7]]
    assert isinstance(k["pair"], tuple) and isinstance(k["pair"][1], list)
    assert k["pair"][0].tolist() == [2, 3]
    assert k["pair"][1][0].shape == (2, 3)


# -- the batch samplers -------------------------------------------------------

def _samplers():
    from apex_tpu.transformer.testing import (
        MegatronPretrainingRandomSampler as JRandom,
        MegatronPretrainingSampler as JSeq)
    return ((MegatronPretrainingSampler, JSeq),
            (MegatronPretrainingRandomSampler, JRandom))


@pytest.mark.parametrize("kw", [
    dict(total_samples=TOTAL, consumed_samples=0),
    dict(total_samples=TOTAL, consumed_samples=16),
    dict(total_samples=10, consumed_samples=0),
    dict(total_samples=10, consumed_samples=0, drop_last=False),
])
def test_sequential_sampler_matches_jax(kw):
    port, jax_cls = _samplers()[0]
    for rank in range(DP):
        a = list(port(micro_batch_size=MBS, data_parallel_rank=rank,
                      data_parallel_size=DP, **kw))
        b = list(jax_cls(micro_batch_size=MBS, data_parallel_rank=rank,
                         data_parallel_size=DP, **kw))
        assert a == b
        assert len(port(micro_batch_size=MBS, data_parallel_rank=rank,
                        data_parallel_size=DP, **kw)) == len(jax_cls(
            micro_batch_size=MBS, data_parallel_rank=rank,
            data_parallel_size=DP, **kw))
    per_rank = [list(port(TOTAL, 0, MBS, r, DP)) for r in range(DP)]
    for gb, (b0, b1) in enumerate(zip(*per_rank)):
        assert sorted(b0 + b1) == list(range(gb * MBS * DP,
                                             (gb + 1) * MBS * DP))


@pytest.mark.parametrize("seed,consumed", [(0, 0), (3, 0), (3, TOTAL),
                                           (7, 24)])
def test_random_sampler_matches_jax(seed, consumed):
    port, jax_cls = _samplers()[1]
    flat = []
    for rank in range(DP):
        a = list(port(TOTAL, consumed, MBS, rank, DP, seed=seed))
        b = list(jax_cls(TOTAL, consumed, MBS, rank, DP, seed=seed))
        assert a == b
        assert all(len(mb) == MBS for mb in a)
        flat += [i for mb in a for i in mb]
    assert len(flat) == len(set(flat))


def _outcome(cls, args):
    try:
        return list(cls(*args))
    except RuntimeError as e:
        return f"RuntimeError: {e}"


def test_samplers_raise_as_jax():
    """Each invalid argument set raises JAX's ``RuntimeError`` with its
    message (or, where JAX accepts it, gives JAX's batches)."""
    for port, jax_cls in _samplers():
        for args in ((0, 0, MBS, 0, DP), (8, 8, MBS, 0, DP),
                     (8, 0, MBS, 3, DP), (8, 0, 0, 0, DP),
                     (8, 0, MBS, 0, 0)):
            assert _outcome(port, args) == _outcome(jax_cls, args), args
    with pytest.raises(RuntimeError):
        MegatronPretrainingSampler(8, 8, MBS, 0, DP)
    with pytest.raises(RuntimeError, match="full global batch"):
        MegatronPretrainingRandomSampler(6, 0, MBS, 0, DP)


# -- build_model, forward_step, backward_step --------------------------------

def test_build_model_single_chunk_and_virtual_chunks():
    from apex_tpu.transformer.pipeline_parallel import build_model as jbuild
    for v in (None, 1, 2, 4):
        calls, jcalls = [], []

        def provider(pre_process=False, post_process=False, calls=calls):
            calls.append((pre_process, post_process))
            return len(calls) - 1

        def jprovider(pre_process=False, post_process=False, calls=jcalls):
            calls.append((pre_process, post_process))
            return len(calls) - 1

        models = tpp.build_model(
            provider, virtual_pipeline_model_parallel_size=v)
        assert models == jbuild(jprovider,
                                virtual_pipeline_model_parallel_size=v)
        assert calls == jcalls
    assert calls[0] == (True, False) and calls[-1] == (False, True)


def _stage_np():
    rng = np.random.RandomState(0)
    return (rng.randn(8, 8).astype(np.float32),
            rng.randn(4, 8).astype(np.float32),
            rng.randn(4, 8).astype(np.float32))


def test_forward_and_backward_step_match_jax():
    import jax
    import jax.numpy as jnp
    from apex_tpu.transformer.pipeline_parallel import (
        backward_step as jbwd, forward_step as jfwd)
    w, x, dy = _stage_np()

    def stage(p, xx, mb):
        return torch.tanh(xx @ p["w"])

    def jstage(p, xx, mb):
        return jnp.tanh(xx @ p["w"])

    p = {"w": torch.from_numpy(w)}
    jp = {"w": jnp.asarray(w)}
    y = tpp.forward_step(stage, p, torch.from_numpy(x), None)
    _close(y.numpy(), np.asarray(jfwd(jstage, jp, jnp.asarray(x), None)))
    dx, dp = tpp.backward_step(stage, p, torch.from_numpy(x), None,
                               torch.from_numpy(dy))
    jdx, jdp = jbwd(jstage, jp, jnp.asarray(x), None, jnp.asarray(dy))
    _close(dx.numpy(), np.asarray(jdx))
    _close(dp["w"].numpy(), np.asarray(jdp["w"]))
    assert p["w"].grad is None                  # functional: no .grad
    want_dx, want_dp = jax.grad(
        lambda xx, pp: jnp.sum(jstage(pp, xx, None) * dy),
        argnums=(0, 1))(jnp.asarray(x), jp)
    _close(dx.numpy(), np.asarray(want_dx))
    _close(dp["w"].numpy(), np.asarray(want_dp["w"]))


def test_forward_step_collects_loss():
    losses = []
    loss = tpp.forward_step(lambda p, x, mb: x @ p["w"],
                            {"w": torch.eye(4)}, torch.ones(2, 4), None,
                            loss_fn=lambda y, mb: y.sum(),
                            losses_reduced=losses)
    assert len(losses) == 1 and losses[0] is loss and float(loss) == 8.0


# -- dispatch, no pipelining, the scaler, commons -------------------------------

def test_get_forward_backward_func_dispatch():
    """As JAX's: pp > 1 with v > 1 interleaves, pp > 1 runs 1F1B,
    otherwise no pipelining; without a topology pp is 1."""
    from apex_tpu.transformer.pipeline_parallel import (
        get_forward_backward_func as jget)
    ps.destroy_model_parallel()
    names = lambda f: f.__name__   # noqa: E731
    for kw in (dict(pipeline_model_parallel_size=1),
               dict(pipeline_model_parallel_size=4),
               dict(pipeline_model_parallel_size=4,
                    virtual_pipeline_model_parallel_size=2),
               dict(pipeline_model_parallel_size=1,
                    virtual_pipeline_model_parallel_size=2),
               dict()):
        assert names(tpp.get_forward_backward_func(**kw)) == \
            names(jget(**kw)), kw
    assert tpp.get_forward_backward_func() is \
        tpp.forward_backward_no_pipelining
    assert tpp.get_forward_backward_func(
        pipeline_model_parallel_size=4) is \
        tpp.forward_backward_pipelining_without_interleaving
    assert tpp.get_forward_backward_func(
        virtual_pipeline_model_parallel_size=2,
        pipeline_model_parallel_size=4) is \
        tpp.forward_backward_pipelining_with_interleaving


@pytest.mark.parametrize("loss_kind", ["2-arg", "3-arg", "3-arg-default"])
def test_no_pipelining_matches_jax(loss_kind):
    """The no-pipelining executor (no process group), with a 2-arg loss,
    a 3-arg loss that trains a head, and a 3rd parameter with a default
    (the 2-arg contract: the closure's head gets no grad), forward and
    forward_only."""
    import jax
    import jax.numpy as jnp
    from apex_tpu.transformer.pipeline_parallel import (
        forward_backward_no_pipelining as jrun)
    rng = np.random.RandomState(1)
    params = {"w": rng.randn(3, 8, 8).astype(np.float32) / 3,
              "head": rng.randn(8, 8).astype(np.float32) / 3}
    batch = {"x": rng.randn(5, 2, 8).astype(np.float32),
             "t": rng.randn(5, 2, 8).astype(np.float32)}

    def stage(p, x, mb):
        for s in range(3):
            x = torch.tanh(x @ p["w"][s])
        return x

    def jstage(p, x, mb):
        for s in range(3):
            x = jnp.tanh(x @ p["w"][s])
        return x

    if loss_kind == "2-arg":
        loss = lambda y, mb: ((y - mb["t"]) ** 2).mean()  # noqa: E731
        jloss = lambda y, mb: ((y - mb["t"]) ** 2).mean()  # noqa: E731
    elif loss_kind == "3-arg":
        loss = lambda y, mb, p: ((y @ p["head"] - mb["t"]) ** 2).mean()  # noqa
        jloss = lambda y, mb, p: ((y @ p["head"] - mb["t"]) ** 2).mean()  # noqa
    else:
        head = {"head": torch.from_numpy(params["head"])}
        jhead = {"head": jnp.asarray(params["head"])}
        loss = lambda y, mb, p=head: ((y @ p["head"] - mb["t"]) ** 2).mean()  # noqa
        jloss = lambda y, mb, p=jhead: ((y @ p["head"] - mb["t"]) ** 2).mean()  # noqa
    tparams = {k: torch.from_numpy(v) for k, v in params.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    jparams = jax.tree.map(jnp.asarray, params)
    jbatch = jax.tree.map(jnp.asarray, batch)
    for fo in (False, True):
        got = tpp.forward_backward_no_pipelining(
            stage, loss, tparams, tbatch, num_microbatches=5,
            input_fn=lambda mb: mb["x"], forward_only=fo)
        want = jrun(jstage, jloss, jparams, jbatch, num_microbatches=5,
                    input_fn=lambda mb: mb["x"], forward_only=fo)
        _close(got[0].numpy(), np.asarray(want[0]))
        if fo:
            assert got[1] is None and want[1] is None
        else:
            for k in params:
                _close(got[1][k].numpy(), np.asarray(want[1][k]))
            head_grad = float(got[1]["head"].abs().max())
            assert (head_grad > 0) == (loss_kind == "3-arg")
    assert tparams["w"].grad is None


def test_grad_scaler_without_topology_keeps_the_local_flag():
    """No topology: the local flag (JAX: the unbound axes are skipped);
    the unscale and the schedule are JAX's."""
    import jax.numpy as jnp
    from apex_tpu.transformer.amp import GradScaler as JScaler
    ps.destroy_model_parallel()
    scaler, jscaler = GradScaler(init_scale=8.0, device="cpu"), \
        JScaler(init_scale=8.0)
    state, jstate = scaler.init(), jscaler.init()
    assert float(state.loss_scale) == float(jstate.loss_scale) == 8.0
    assert float(scaler.scale(torch.tensor(2.0), state)) == 16.0
    g = {"a": np.arange(4, dtype=np.float32), "b": np.ones(2, np.float32)}
    for poison in (False, True):
        gg = {k: v.copy() for k, v in g.items()}
        if poison:
            gg["a"][1] = np.inf
        got, st = scaler.unscale_({k: torch.from_numpy(v.copy())
                                   for k, v in gg.items()}, state)
        want, jst = jscaler.unscale_({k: jnp.asarray(v)
                                      for k, v in gg.items()}, jstate)
        assert float(st.found_inf) == float(jst.found_inf) == float(poison)
        if not poison:
            for k in g:
                assert got[k].tolist() == np.asarray(want[k]).tolist()
        new, jnew = scaler.update(st), jscaler.update(jst)
        assert float(new.loss_scale) == float(jnew.loss_scale)
    off = GradScaler(enabled=False, device="cpu")
    grads = {"a": torch.ones(2)}
    assert off.unscale_(grads, state)[0] is grads
    assert off.scale(torch.tensor(3.0), state) == 3.0


def test_commons_seed_identity_layer_and_distributed_check():
    gen = set_random_seed(11, device="cpu")
    a = torch.rand(3, generator=gen)
    gen = set_random_seed(11, device="cpu")
    assert torch.equal(a, torch.rand(3, generator=gen))
    np.random.seed(0)
    set_random_seed(11, device="cpu")
    first = np.random.rand()
    set_random_seed(11, device="cpu")
    assert np.random.rand() == first
    from apex_tpu_torch.transformer.tensor_parallel import random as trand
    assert "model-parallel-rng" in trand.get_rng_tracker().states_
    layer = IdentityLayer((3, 4), init_scale=0.5, device="cpu")
    assert layer().shape == (3, 4) and layer().requires_grad
    assert [n for n, _ in layer.named_parameters()] == ["weight"]
    import torch.distributed as dist
    if not dist.is_initialized():
        with pytest.raises(RuntimeError, match="init_process_group"):
            initialize_distributed()
