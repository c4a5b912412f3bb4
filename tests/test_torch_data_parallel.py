"""Data parallelism on the port against the JAX package (CPU):
``parallel_state``'s topology, ``DistributedDataParallel``,
``flat_allreduce``, ``SyncBatchNorm``, ``convert_syncbn_model``,
``LARC``, the ``multiproc`` tombstone and ``_ucc_util``.

The port's counterparts of ``tests/L0/run_parallel/test_ddp.py`` and
``tests/L0/run_parallel/test_sync_batchnorm.py``.  The JAX side runs in
this process on the 8 host devices that ``tests/conftest.py`` pins
(``shard_map`` over a ``data`` mesh of the first dp of them); the port's
ranks run one process a rank, spawned over gloo with ``device="cpu"`` on
a ``FileStore`` under the test's temporary directory by
:class:`apex_tpu_torch.transformer.testing.distributed_test_base.DistributedTestBase`.
One spawn a width (2 and 4 ranks) runs every rank-side case of that
width (the ``port_runs`` fixture); the spawned ranks import this module,
torch and the port only: every JAX import sits inside a JAX-side helper.

Tolerances (fp32 on both sides; the two differ in reduction order):
reduced grads 1e-6 relative; the DDP train step's master against the
port's dense step on the whole batch within 2 * lr * steps everywhere
and 1e-5 on all but 0.1% of the elements, the ranks' masters bit for
bit; SyncBatchNorm's outputs, statistics and grads 1e-5; LARC 1e-6
against JAX and 1e-5 against the numpy oracle (JAX's own).
"""
import functools

import numpy as np
import pytest
import torch

from apex_tpu_torch.optimizers import FusedSGD
from apex_tpu_torch.parallel import (LARC, DistributedDataParallel,
                                     SyncBatchNorm, convert_syncbn_model,
                                     flat_allreduce)
from apex_tpu_torch.transformer import parallel_state as tps
from apex_tpu_torch.transformer.testing import distributed_test_base as dtb

from _torch_isolation import restore_torch_from_amp  # noqa: F401

#: the DDP knob matrix of JAX's ``test_reduce_gradients_averages``
DDP_CASES = [(d, m) for d in (False, True) for m in (10_000_000, 64)]
#: the topologies held at 4 ranks: (tp, pp); dp is what is left
TOPOLOGIES = [(1, 1), (2, 1), (1, 2)]
#: SyncBatchNorm inputs: 2 images a rank, NHWC (channel_last) or NCHW
BN_NHWC, BN_NCHW = (4, 4, 8), (8, 4, 4)
LR, STEPS = 1e-3, 2
LLAMA = dict(vocab_size=128, hidden_size=64, num_layers=2,
             num_attention_heads=4, num_kv_heads=2, max_seq_length=32)


def _ddp_inputs(dp):
    rng = np.random.RandomState(dp)
    return dict(
        w=np.arange(dp * 6, dtype=np.float32).reshape(dp, 6),
        b=np.ones((dp, 2), np.float32),
        big=rng.randn(dp, 1000).astype(np.float32),
        W=rng.randn(6, 3).astype(np.float32),
        X=rng.randn(4 * dp, 6).astype(np.float32),
        Y=rng.randn(4 * dp, 3).astype(np.float32),
        bn=rng.randn(2 * dp, *BN_NHWC).astype(np.float32),
        bn_nchw=rng.randn(2 * dp, *BN_NCHW).astype(np.float32),
        bn_cot=rng.randn(2 * dp, *BN_NHWC).astype(np.float32),
        # JAX's test_large_mean_small_variance input, split over the ranks
        welford=1e4 + np.random.RandomState(0).randn(64, 8).astype(
            np.float32) * 1e-3,
        tokens=rng.randint(0, LLAMA["vocab_size"],
                           (STEPS, 2 * dp, 17)).astype(np.int64))


# -- the JAX side (JAX imported here only) -----------------------------------

def _shard_map(fn, dp, in_specs, out_specs):
    import jax
    from jax.sharding import Mesh
    mesh = Mesh(np.array(jax.devices()[:dp]), ("data",))
    return jax.jit(functools.partial(jax.shard_map, check_vma=False)(
        fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs))


def _jax_ddp(dp, inputs, **kw):
    """JAX's reduce_gradients of the ``{w, b}`` rows, each rank one row."""
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from apex_tpu.parallel import DistributedDataParallel as JDDP
    ddp = JDDP(axis_name="data", **kw)
    grads = {"w": jnp.asarray(inputs["w"]), "b": jnp.asarray(inputs["b"])}
    out = _shard_map(ddp.reduce_gradients, dp, (P("data"),), P("data"))(
        grads)
    return {k: np.asarray(v) for k, v in out.items()}


def _jax_topology(tp, pp, n=4):
    """JAX's mesh over ``n`` devices: the device id grid (pp, dp, ep, cp,
    tp), which is the port's rank grid."""
    import jax
    from apex_tpu.transformer import parallel_state as jps
    jps.destroy_model_parallel()
    mesh = jps.initialize_model_parallel(tp, pp, devices=jax.devices()[:n])
    ids = np.vectorize(lambda d: d.id)(mesh.devices)
    shape = dict(mesh.shape)
    jps.destroy_model_parallel()
    jps.initialize_model_parallel(1)
    return ids, shape


def _jax_bn(x, cot, axis_name=None, channel_last=True, dp=None):
    """JAX's SyncBatchNorm: y, running stats and (for the whole batch on
    one device) the grads of sum(y * cot) w.r.t. x, weight and bias."""
    import jax
    import jax.numpy as jnp
    from apex_tpu.parallel import SyncBatchNorm as JBN
    c = x.shape[-1] if channel_last else x.shape[1]
    bn = JBN(num_features=c, axis_name=None, channel_last=channel_last)
    variables = bn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    y, new = bn.apply(variables, jnp.asarray(x), mutable=["batch_stats"])

    if cot is None:
        return dict(y=np.asarray(y))

    def loss(xx, params):
        out, _ = bn.apply({"params": params,
                           "batch_stats": variables["batch_stats"]}, xx,
                          mutable=["batch_stats"])
        return jnp.sum(out * cot)

    dx, dparams = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x),
                                                 variables["params"])
    stats = new["batch_stats"]
    return dict(y=np.asarray(y), mean=np.asarray(stats["running_mean"]),
                var=np.asarray(stats["running_var"]), dx=np.asarray(dx),
                dw=np.asarray(dparams["weight"]),
                db=np.asarray(dparams["bias"]))


# -- the port side (the spawned ranks) ---------------------------------------

def _rows(a, rank, dp):
    n = a.shape[0] // dp
    return torch.from_numpy(np.ascontiguousarray(a[rank * n:(rank + 1) * n]))


def _ddp_cases(rank, dp, inputs):
    out = {}
    grads = {"w": _rows(inputs["w"], rank, dp),
             "b": _rows(inputs["b"], rank, dp)}
    for delay, size in DDP_CASES:
        ddp = DistributedDataParallel(message_size=size,
                                      delay_allreduce=delay)
        out["avg", delay, size] = ddp.reduce_gradients(grads)
    big = {"w": _rows(inputs["big"], rank, dp)}
    out["one"] = DistributedDataParallel(delay_allreduce=True) \
        .reduce_gradients(big)["w"]
    out["bucketed"] = DistributedDataParallel(message_size=512) \
        .reduce_gradients(big)["w"]
    out["predivide"] = DistributedDataParallel(
        gradient_predivide_factor=4.0).reduce_gradients(
        {"w": torch.ones(1, 4)})["w"]
    out["fp32"] = DistributedDataParallel(allreduce_always_fp32=True) \
        .reduce_gradients({"w": torch.full((1, 4), 0.1,
                                           dtype=torch.bfloat16)})["w"]
    out["no_average"] = DistributedDataParallel(
        gradient_average=False, gradient_predivide_factor=2.0) \
        .reduce_gradients({"w": torch.ones(1, 4)})["w"]
    out["flat"] = flat_allreduce({"a": torch.ones(1, 3),
                                  "b": torch.full((1, 2), 2.0)})
    flat = torch.arange(5, dtype=torch.float32) + rank
    out["flat_tensor"] = (DistributedDataParallel().reduce_gradients(flat),
                          flat)
    # the reference's ddp_race_condition_test: per-rank batches + DDP ==
    # the full batch's grads
    w = torch.from_numpy(inputs["W"]).requires_grad_()
    x, y = _rows(inputs["X"], rank, dp), _rows(inputs["Y"], rank, dp)
    torch.mean((x @ w - y) ** 2).backward()
    out["race"] = DistributedDataParallel().reduce_gradients(w.grad)
    return out


def _ddp_train(rank, dp, inputs):
    """The flat-native step with ``grad_transform=ddp.reduce_gradients``
    on this rank's rows of a tiny LLaMA's batches: the master."""
    from apex_tpu_torch import train_step
    from apex_tpu_torch.optimizers import functional
    model = _llama()
    tx = functional.fused_adam(lr=LR)
    state = train_step.init_train_state(tx, model, loss_scale="dynamic")
    step = train_step.make_train_step(
        lambda m, b: m(b[:, :-1], b[:, 1:]), tx,
        grad_transform=DistributedDataParallel().reduce_gradients)
    losses = []
    for i in range(STEPS):
        state, loss = step(state, _rows(inputs["tokens"][i], rank, dp))
        losses.append(float(loss))
    return dict(master=state.opt.master.clone(), losses=losses)


def _llama():
    from apex_tpu_torch.transformer.testing import (LlamaConfig,
                                                    llama_model_provider)
    torch.manual_seed(0)
    return llama_model_provider(LlamaConfig(**LLAMA), device="cpu")


def _bn_case(rank, dp, x, cot, channel_last, **kw):
    bn = SyncBatchNorm(x.shape[-1] if channel_last else x.shape[1],
                       channel_last=channel_last, device="cpu", **kw)
    with torch.no_grad():
        bn.weight.mul_(1.5)
        bn.bias.add_(0.25)
    xr = _rows(x, rank, dp).requires_grad_()
    y = bn(xr)
    if cot is not None:
        (y * _rows(cot, rank, dp)).sum().backward()
    return dict(y=y.detach(), mean=bn.running_mean.clone(),
                var=bn.running_var.clone(),
                dx=None if xr.grad is None else xr.grad,
                dw=bn.weight.grad, db=bn.bias.grad,
                eval=bn(xr.detach(), use_running_average=True),
                eval_mode=bn.eval()(xr.detach()))


def _bn_cases(rank, dp, inputs):
    out = {"nhwc": _bn_case(rank, dp, inputs["bn"], inputs["bn_cot"], True),
           "nchw": _bn_case(rank, dp, inputs["bn_nchw"], None, False),
           "welford": _bn_case(rank, dp, inputs["welford"], None, True)}
    if dp == 4:
        out["subsets"] = _bn_case(rank, dp, inputs["bn"], None, True,
                                  axis_index_groups=[[0, 1], [2, 3]])
    # convert_syncbn_model: the torch batch norms become SyncBatchNorm
    # over the data group, keeping their tensors
    m = torch.nn.Sequential(torch.nn.Linear(6, 6), torch.nn.SyncBatchNorm(6))
    with torch.no_grad():
        m[1].weight.mul_(2.0).add_(0.5)
        m[1].running_mean.add_(1.0)
    conv = convert_syncbn_model(m)
    conv.train()
    torch.manual_seed(1)
    y2 = conv(torch.randn(4, 6))
    conv(torch.randn(4, 6, 3).transpose(1, 2).reshape(12, 6))
    bn2d = torch.nn.Sequential(torch.nn.BatchNorm2d(8))
    c2 = convert_syncbn_model(bn2d)
    x2 = _rows(inputs["bn_nchw"], rank, dp)
    out["convert"] = dict(
        kind=type(conv[1]).__name__, same_weight=conv[1].weight is m[1].weight,
        same_mean=conv[1].running_mean is m[1].running_mean, y2=y2.shape,
        bn2d=c2(x2).detach(), bn2d_kind=type(c2[0]).__name__)
    return out


def _topologies(rank):
    """Each topology of :data:`TOPOLOGIES` at 4 ranks: this rank's
    coordinates, world sizes, group members and stage predicates."""
    import torch.distributed as dist
    out = {}
    for tp, pp in TOPOLOGIES:
        tps.destroy_model_parallel()
        mesh = tps.initialize_model_parallel(tp, pp)
        members = {name: dist.get_process_group_ranks(getter())
                   for name, getter in (
                       ("tensor", tps.get_tensor_model_parallel_group),
                       ("pipe", tps.get_pipeline_model_parallel_group),
                       ("data", tps.get_data_parallel_group),
                       ("amax", tps.get_amax_reduction_group))}
        tps.set_virtual_pipeline_model_parallel_rank(1)
        virtual_first = tps.is_pipeline_first_stage()
        tps.set_virtual_pipeline_model_parallel_rank(None)
        out[tp, pp] = dict(
            grid=mesh.grid.tolist(), shape=mesh.shape, members=members,
            ranks=(tps.get_tensor_model_parallel_rank(),
                   tps.get_pipeline_model_parallel_rank(),
                   tps.get_data_parallel_rank()),
            sizes=(tps.get_tensor_model_parallel_world_size(),
                   tps.get_pipeline_model_parallel_world_size(),
                   tps.get_data_parallel_world_size()),
            src=tps.get_tensor_model_parallel_src_rank(),
            first=tps.is_pipeline_first_stage(),
            last=tps.is_pipeline_last_stage(),
            prev_next=(tps.get_pipeline_model_parallel_prev_rank(),
                       tps.get_pipeline_model_parallel_next_rank()),
            dense=tps.get_dense_param_grad_axes(),
            expert=tps.get_expert_param_grad_axes(),
            virtual_first=virtual_first)
    tps.destroy_model_parallel()
    tps.initialize_model_parallel()
    return out


def _rank_main(rank, dp, inputs):
    out = {"ddp": _ddp_cases(rank, dp, inputs),
           "ddp_train": _ddp_train(rank, dp, inputs),
           "bn": _bn_cases(rank, dp, inputs)}
    if dp == 4:
        out["topology"] = _topologies(rank)
    return out


@pytest.fixture(scope="module")
def port_runs():
    """``port_runs(dp)``: every rank-side case of width ``dp``, once per
    module, as ``[rank] -> {case: result}``, run by
    ``DistributedTestBase.run_sharded``."""
    runs = {}

    def get(dp):
        if dp not in runs:
            base = dtb.DistributedTestBase()
            base.WORLD_SIZE = dp
            runs[dp] = base.run_sharded(_rank_main, dp, _ddp_inputs(dp))
        return runs[dp]
    return get


def _np(t):
    return t.detach().float().numpy()


# -- DistributedDataParallel -------------------------------------------------

@pytest.mark.parametrize("delay,size", DDP_CASES)
@pytest.mark.parametrize("dp", [2, 4])
def test_reduce_gradients_averages(dp, delay, size, port_runs):
    want = _jax_ddp(dp, _ddp_inputs(dp), message_size=size,
                    delay_allreduce=delay)
    for r, run in enumerate(port_runs(dp)):
        got = run["ddp"]["avg", delay, size]
        for k in ("w", "b"):
            np.testing.assert_allclose(_np(got[k]), want[k][r:r + 1],
                                       rtol=1e-6)
        np.testing.assert_allclose(
            _np(got["w"]), _ddp_inputs(dp)["w"].mean(0, keepdims=True),
            rtol=1e-6)


@pytest.mark.parametrize("dp", [2, 4])
def test_bucketing_matches_single_allreduce(dp, port_runs):
    mean = _ddp_inputs(dp)["big"].mean(0, keepdims=True)
    for run in port_runs(dp):
        np.testing.assert_allclose(_np(run["ddp"]["bucketed"]),
                                   _np(run["ddp"]["one"]), rtol=1e-6)
        np.testing.assert_allclose(_np(run["ddp"]["one"]), mean, rtol=1e-5,
                                   atol=1e-7)


@pytest.mark.parametrize("dp", [2, 4])
def test_predivide_fp32_and_no_average(dp, port_runs):
    """Pre-divide by 4, sum, post-multiply by 4/dp: the average; bf16
    grads reduced in fp32 come back bf16 (JAX's value); without averaging
    the pre-divided sum stays."""
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from apex_tpu.parallel import DistributedDataParallel as JDDP
    jbf = _shard_map(JDDP(axis_name="data", allreduce_always_fp32=True)
                     .reduce_gradients, dp, (P("data"),), P("data"))(
        {"w": jnp.full((dp, 4), 0.1, jnp.bfloat16)})["w"]
    for run in port_runs(dp):
        ddp = run["ddp"]
        np.testing.assert_allclose(_np(ddp["predivide"]), 1.0, rtol=1e-6)
        assert ddp["fp32"].dtype == torch.bfloat16
        np.testing.assert_array_equal(_np(ddp["fp32"]),
                                      np.asarray(jbf, np.float32)[:1])
        np.testing.assert_allclose(_np(ddp["no_average"]), dp / 2.0)


@pytest.mark.parametrize("dp", [2, 4])
def test_flat_allreduce_and_flat_buffer(dp, port_runs):
    """``flat_allreduce`` sums (JAX's 8 and 16 at dp 8); the flat-native
    step's flat grads are one leaf, averaged in place."""
    for run in port_runs(dp):
        flat = run["ddp"]["flat"]
        np.testing.assert_allclose(_np(flat["a"]), float(dp))
        np.testing.assert_allclose(_np(flat["b"]), 2.0 * dp)
        reduced, buf = run["ddp"]["flat_tensor"]
        assert torch.equal(reduced, buf)
        np.testing.assert_allclose(_np(reduced),
                                   np.arange(5) + (dp - 1) / 2.0, rtol=1e-6)


@pytest.mark.parametrize("dp", [2, 4])
def test_ddp_grad_correctness_vs_single_process(dp, port_runs):
    import jax
    import jax.numpy as jnp
    inp = _ddp_inputs(dp)
    want = jax.grad(lambda w: jnp.mean((inp["X"] @ w - inp["Y"]) ** 2))(
        jnp.asarray(inp["W"]))
    for run in port_runs(dp):
        np.testing.assert_allclose(_np(run["ddp"]["race"]),
                                   np.asarray(want), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("dp", [2, 4])
def test_ddp_train_step_matches_dense_step(dp, port_runs):
    """``make_train_step(grad_transform=ddp.reduce_gradients)`` on each
    rank's rows: the ranks' masters bit for bit, and the port's dense
    step on the whole batch within the Adam tolerance."""
    from apex_tpu_torch import train_step
    from apex_tpu_torch.optimizers import functional
    tokens = _ddp_inputs(dp)["tokens"]
    tx = functional.fused_adam(lr=LR)
    state = train_step.init_train_state(tx, _llama(), loss_scale="dynamic")
    step = train_step.make_train_step(lambda m, b: m(b[:, :-1], b[:, 1:]),
                                      tx)
    for i in range(STEPS):
        state, loss = step(state, torch.from_numpy(tokens[i]))
    runs = [r["ddp_train"] for r in port_runs(dp)]
    for run in runs:
        assert torch.equal(run["master"], runs[0]["master"])
    diff = np.abs(_np(runs[0]["master"]) - _np(state.opt.master))
    assert diff.max() <= 2 * LR * STEPS
    assert np.mean(diff > 1e-5) <= 1e-3
    mean_loss = np.mean([r["losses"][0] for r in runs])
    assert runs[0]["losses"][0] != runs[-1]["losses"][0]
    assert abs(mean_loss - float(_first_dense_loss(tokens))) < 1e-5


def _first_dense_loss(tokens):
    model = _llama()
    with torch.no_grad():
        b = torch.from_numpy(tokens[0])
        return model(b[:, :-1], b[:, 1:])


def test_leaf_buckets_match_jax_and_split_at_dtypes():
    import jax.numpy as jnp
    from apex_tpu.parallel import DistributedDataParallel as JDDP
    shapes = [(100,), (300,), (50,), (7,), (400,), (3, 5)]
    dtypes = [torch.float32, torch.float32, torch.bfloat16, torch.bfloat16,
              torch.float32, torch.float32]
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
    for size in (64, 1000, 2000, 10_000_000):
        got = DistributedDataParallel(message_size=size)._leaf_buckets(
            [torch.zeros(s, dtype=d) for s, d in zip(shapes, dtypes)])
        want = JDDP(message_size=size)._leaf_buckets(
            [jnp.zeros(s, jdt[d]) for s, d in zip(shapes, dtypes)])
        assert got == want
        assert all(len({dtypes[i] for i in b}) == 1 for b in got)


def test_collectives_without_topology_raise():
    """No rank quietly runs alone: a mesh-axis name without
    ``initialize_model_parallel`` raises, naming it; the topology without
    ``init_process_group`` raises, naming that."""
    with pytest.raises(RuntimeError, match="initialize_model_parallel"):
        DistributedDataParallel().reduce_gradients(torch.ones(3))
    with pytest.raises(RuntimeError, match="initialize_model_parallel"):
        tps.resolve_group("data")
    with pytest.raises(RuntimeError, match="init_process_group"):
        tps.initialize_model_parallel(1)
    with pytest.raises(RuntimeError, match="initialize_model_parallel"):
        SyncBatchNorm(4, device="cpu")(torch.randn(3, 4))
    with pytest.raises(TypeError, match="without a module"):
        DistributedDataParallel()(torch.ones(1))
    assert not tps.model_parallel_is_initialized()


# -- SyncBatchNorm -----------------------------------------------------------

@pytest.mark.parametrize("dp", [2, 4])
def test_sync_batchnorm_matches_global_batch(dp, port_runs):
    """NHWC, 2 images a rank: each rank's output, running statistics and
    dx against JAX's SyncBatchNorm over the whole batch on one device;
    the ranks' weight and bias grads summed against JAX's (a DDP
    all-reduce would sum them)."""
    inp = _ddp_inputs(dp)
    want = _jax_bn(inp["bn"], inp["bn_cot"])
    # the port's module scales weight by 1.5 and shifts bias by 0.25
    # before the forward: fold that into JAX's affine-free output
    ranks = [r["bn"]["nhwc"] for r in port_runs(dp)]
    for r, run in enumerate(ranks):
        y = want["y"][2 * r:2 * r + 2] * 1.5 + 0.25
        np.testing.assert_allclose(_np(run["y"]), y, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(_np(run["mean"]), want["mean"],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(_np(run["var"]), want["var"], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(_np(run["dx"]),
                                   1.5 * want["dx"][2 * r:2 * r + 2],
                                   rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(sum(_np(r["dw"]) for r in ranks),
                               want["dw"], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(sum(_np(r["db"]) for r in ranks),
                               want["db"], rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("dp", [2, 4])
def test_sync_batchnorm_channel_first_eval_and_welford(dp, port_runs):
    """NCHW against torch's batch norm over the whole batch; eval mode
    (and ``use_running_average``) normalises by the running statistics;
    a large mean over a tiny variance stays finite with a mean near 0
    (the Welford merge; JAX's test and limit on its input)."""
    import torch.nn.functional as F
    inp = _ddp_inputs(dp)
    x = torch.from_numpy(inp["bn_nchw"])
    rm, rv = torch.zeros(8), torch.ones(8)
    full = F.batch_norm(x, rm, rv, 1.5 * torch.ones(8),
                        0.25 * torch.ones(8), training=True, momentum=0.1,
                        eps=1e-5)
    for r, run in enumerate(port_runs(dp)):
        nchw = run["bn"]["nchw"]
        np.testing.assert_allclose(_np(nchw["y"]), _np(full[2 * r:2 * r + 2]),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(_np(nchw["mean"]), _np(rm), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(_np(nchw["var"]), _np(rv), rtol=1e-5,
                                   atol=1e-6)
        xr = x[2 * r:2 * r + 2]
        ev = F.batch_norm(xr, rm, rv, 1.5 * torch.ones(8),
                          0.25 * torch.ones(8), training=False, eps=1e-5)
        for key in ("eval", "eval_mode"):
            np.testing.assert_allclose(_np(nchw[key]), _np(ev), rtol=1e-5,
                                       atol=1e-5)
        y = _np(run["bn"]["welford"]["y"])
        assert np.isfinite(y).all()
    ys = np.concatenate([_np(r["bn"]["welford"]["y"])
                         for r in port_runs(dp)])
    assert abs(float(((ys - 0.25) / 1.5).mean())) < 1e-2
    assert abs(float(_jax_bn(inp["welford"], None)["y"].mean())) < 1e-2


def test_sync_batchnorm_axis_index_groups(port_runs):
    """At 4 ranks, ``axis_index_groups=[[0, 1], [2, 3]]``: each pair
    normalises over its own 4 images."""
    inp = _ddp_inputs(4)
    for r, run in enumerate(port_runs(4)):
        pair = r // 2
        want = _jax_bn(inp["bn"][4 * pair:4 * pair + 4], inp["bn_cot"][:4])
        y = want["y"][2 * (r % 2):2 * (r % 2) + 2] * 1.5 + 0.25
        np.testing.assert_allclose(_np(run["bn"]["subsets"]["y"]), y,
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dp", [2, 4])
def test_convert_syncbn_model(dp, port_runs):
    """Torch batch norms become SyncBatchNorm keeping their tensors;
    2-D and 3-D inputs run; a converted BatchNorm2d normalises over the
    group's whole batch (NCHW)."""
    import torch.nn.functional as F
    x = torch.from_numpy(_ddp_inputs(dp)["bn_nchw"])
    full = F.batch_norm(x, None, None, torch.ones(8), torch.zeros(8),
                        training=True, eps=1e-5)
    for r, run in enumerate(port_runs(dp)):
        conv = run["bn"]["convert"]
        assert conv["kind"] == conv["bn2d_kind"] == "SyncBatchNorm"
        assert conv["same_weight"] and conv["same_mean"]
        assert tuple(conv["y2"]) == (4, 6)
        np.testing.assert_allclose(_np(conv["bn2d"]),
                                   _np(full[2 * r:2 * r + 2]), rtol=1e-5,
                                   atol=1e-5)
    with pytest.raises(TypeError):
        convert_syncbn_model(object())


# -- parallel_state ----------------------------------------------------------

@pytest.mark.parametrize("tp,pp", TOPOLOGIES)
def test_parallel_state_rank_order_and_groups_match_jax(tp, pp, port_runs):
    """At 4 ranks: the port's rank grid is JAX's mesh of device ids
    (global rank = pp·(dp·ep·cp·tp) + dp·(ep·cp·tp) + ... + tp_rank), and
    each rank's tensor, pipe, data and amax groups hold the ranks JAX's
    axes hold; sizes, coordinates, the tensor source rank and the
    pipeline predicates follow."""
    ids, shape = _jax_topology(tp, pp)
    dp = 4 // (tp * pp)
    for r, run in enumerate(port_runs(4)):
        top = run["topology"][tp, pp]
        assert np.array_equal(np.array(top["grid"]), ids)
        assert top["shape"] == shape
        coord = dict(zip(("pipe", "data", "expert", "context", "tensor"),
                         (int(c) for c in np.argwhere(ids == r)[0])))
        assert top["ranks"] == (coord["tensor"], coord["pipe"],
                                coord["data"])
        assert top["sizes"] == (tp, pp, dp)
        along = {"tensor": ids[coord["pipe"], coord["data"], 0, 0, :],
                 "pipe": ids[:, coord["data"], 0, 0, coord["tensor"]],
                 "data": ids[coord["pipe"], :, 0, 0, coord["tensor"]],
                 "amax": ids[coord["pipe"]].reshape(-1)}
        for name, want in along.items():
            assert top["members"][name] == sorted(want.tolist()), name
        assert top["src"] == (r // tp) * tp
        assert top["first"] == (coord["pipe"] == 0)
        assert top["last"] == (coord["pipe"] == pp - 1)
        assert top["prev_next"] == ((coord["pipe"] - 1) % pp,
                                    (coord["pipe"] + 1) % pp)
        assert top["dense"] == top["expert"] == "data"
        assert top["virtual_first"] is False


def test_distributed_test_base_and_backends():
    """The NCCL and UCC bases name their backends; ``run_sharded`` takes
    no specs; ``HAS_UCC`` is what torch.distributed answers and one
    process with no address initialises nothing."""
    import torch.distributed as dist
    from apex_tpu_torch.transformer import _ucc_util
    assert dtb.NcclDistributedTestBase.BACKEND == "nccl"
    assert dtb.UccDistributedTestBase.BACKEND == "ucc"
    base = dtb.DistributedTestBase()
    assert base.world_size == dtb.DistributedTestBase.WORLD_SIZE
    with pytest.raises(ValueError, match="no specs"):
        base.run_sharded(_rank_main, in_specs=())
    assert _ucc_util.HAS_UCC == dist.is_ucc_available()
    _ucc_util.initialize_distributed_backend()
    _ucc_util.initialize_distributed_backend(num_processes=1)
    assert not dist.is_initialized()


def test_multiproc_is_a_tombstone_in_both_packages():
    import importlib
    with pytest.raises(ImportError, match="torchrun"):
        importlib.import_module("apex_tpu_torch.parallel.multiproc")
    with pytest.raises(ImportError):
        importlib.import_module("apex_tpu.parallel.multiproc")


# -- LARC (in process) -------------------------------------------------------

def _larc_pair(p0, g0, lr=0.1, wd=0.0, **kw):
    """One LARC(FusedSGD) step in both packages on the same numpy."""
    import jax.numpy as jnp
    from apex_tpu.optimizers import FusedSGD as JSGD
    from apex_tpu.parallel import LARC as JLARC
    from apex_tpu_torch.ops import _build
    _build.reset_launch_counts()
    got = LARC(FusedSGD({"w": torch.from_numpy(p0)}, lr=lr,
                        weight_decay=wd), **kw).step(
        {"w": torch.from_numpy(g0)})
    assert set(_build.launch_counts().values()) <= {0}
    want = JLARC(JSGD({"w": jnp.asarray(p0)}, lr=lr, weight_decay=wd),
                 **kw).step({"w": jnp.asarray(g0)})
    return _np(got["w"]), np.asarray(want["w"])


def test_larc_clips_effective_lr():
    p0 = (np.random.RandomState(0).randn(32, 16) * 100).astype(np.float32)
    g0 = np.random.RandomState(1).randn(32, 16).astype(np.float32)
    got, want = _larc_pair(p0, g0, trust_coefficient=0.001)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    plain = FusedSGD({"w": torch.from_numpy(p0)}, lr=0.1).step(
        {"w": torch.from_numpy(g0)})
    np.testing.assert_allclose(got, _np(plain["w"]), rtol=1e-6)


def test_larc_scales_down():
    p0 = (np.random.RandomState(0).randn(32, 16) * 0.001).astype(np.float32)
    g0 = np.random.RandomState(1).randn(32, 16).astype(np.float32)
    got, want = _larc_pair(p0, g0, trust_coefficient=0.001)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)
    plain = FusedSGD({"w": torch.from_numpy(p0)}, lr=0.1).step(
        {"w": torch.from_numpy(g0)})
    assert np.abs(got - p0).mean() < 0.1 * np.abs(_np(plain["w"]) - p0).mean()


def test_larc_state_dict_passthrough():
    opt = LARC(FusedSGD({"w": torch.ones(8, 8)}, lr=0.1))
    sd = opt.state_dict()
    opt.load_state_dict(sd)
    assert opt.param_groups is opt.inner.param_groups


@pytest.mark.parametrize("clip", [True, False])
def test_larc_vs_apex_oracle_and_jax(clip):
    """One step against JAX's LARC and the numpy transcription of apex
    LARC + SGD (wd folded, group wd zeroed for the inner step)."""
    rng = np.random.RandomState(0)
    lr, trust, wd = 0.1, 0.02, 0.01
    p0 = rng.randn(16, 8).astype(np.float32)
    g0 = rng.randn(16, 8).astype(np.float32)
    got, want = _larc_pair(p0, g0, lr=lr, wd=wd, trust_coefficient=trust,
                           clip=clip)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    pn, gn = np.linalg.norm(p0), np.linalg.norm(g0)
    adaptive = trust * pn / (gn + wd * pn + 1e-8)
    if clip:
        adaptive = min(adaptive / lr, 1.0)
    np.testing.assert_allclose(got, p0 - lr * (g0 + wd * p0) * adaptive,
                               atol=1e-5)


def test_larc_over_a_torch_optimizer_matches_the_tree_class():
    """LARC over ``FusedSGD(model.parameters())`` (the torch-mode twin)
    rescales each ``.grad`` in place and steps like LARC over the tree
    class; the twin's weight decay is restored after the step."""
    rng = np.random.RandomState(3)
    p0 = rng.randn(16, 8).astype(np.float32)
    g0 = rng.randn(16, 8).astype(np.float32)
    param = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    twin = FusedSGD([param], lr=0.1, weight_decay=0.01)
    assert isinstance(twin, torch.optim.Optimizer)
    param.grad = torch.from_numpy(g0.copy())
    larc = LARC(twin, trust_coefficient=0.02)
    larc.step()
    tree = LARC(FusedSGD({"w": torch.from_numpy(p0)}, lr=0.1,
                         weight_decay=0.01), trust_coefficient=0.02).step(
        {"w": torch.from_numpy(g0)})
    np.testing.assert_allclose(_np(param), _np(tree["w"]), rtol=1e-6,
                               atol=1e-7)
    assert twin.param_groups[0]["weight_decay"] == 0.01
    with pytest.raises(TypeError, match="grad"):
        larc.step({"w": torch.zeros(1)})
