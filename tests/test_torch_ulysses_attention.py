"""Ulysses attention on the port against the JAX package (CPU).

The port's counterpart of
``tests/L0/run_attention/test_ulysses_attention.py``:
``apex_tpu_torch.ops.ulysses_attention`` at cp = 2 and 4, causal and
full, forward and the q, k and v grads of ``sum(o^2)`` summed over the
ranks, against the JAX function under ``jax.shard_map`` on the host
devices ``tests/conftest.py`` pins (Pallas in interpret mode) and
against the dense run on the gathered sequence; with dropout (the seed
folded with the rank, as JAX folds it: the same keep bits) against
JAX's.  The port's ranks run one process a rank over gloo with CPU
tensors (one spawn of 4 ranks: cp = 4, then cp = 2 x dp = 2), the two
reshards each one ``all_to_all`` through
``apex_tpu_torch.parallel._comm``; the spawned ranks import this module,
torch and the port only.

Also the rules JAX keeps: ``h % cp != 0`` raises its ``ValueError``; a
name the topology has no group for raises; the canonical context axis
with no topology (or one rank) is :func:`flash_attention`.  And the
all-to-all itself against JAX's tiled ``lax.all_to_all`` element for
element.

Tolerances: within 2e-5 of the largest magnitude of the JAX side (fp32
on both sides; the same plain attention per head, reshards exact), and
of the port's dense run.
"""
import functools

import numpy as np
import pytest
import torch

from apex_tpu_torch.ops import attention as tattn
from apex_tpu_torch.ops.ulysses_attention import (_reshard,
                                                  ulysses_attention)
from apex_tpu_torch.transformer import parallel_state as ps
from apex_tpu_torch.transformer.testing.distributed_test_base import \
    spawn_ranks

from _torch_isolation import restore_torch_from_amp  # noqa: F401

TOL = 2e-5
B, H, S, D = 1, 4, 256, 32      # H % cp == 0
CPS = (2, 4)
CASES = [(True, 0.0), (False, 0.0), (True, 0.1)]
SEED = 91
#: the reshard's cases: (shape, split axis, concat axis)
RESHARDS = (((3, 1, 4, 8, 2), 2, 3), ((1, 2, 32, 2), 2, 1))


def _inputs():
    rng = np.random.RandomState(8)
    out = {k: rng.randn(B, H, S, D).astype(np.float32) for k in "qkv"}
    out["x"] = {shape: rng.randn(4, *shape).astype(np.float32)
                for shape, _, _ in RESHARDS}
    return out


def _shard(a, cp, r):
    s = a.shape[2] // cp
    return torch.from_numpy(np.ascontiguousarray(a[:, :, r * s:(r + 1) * s]))


# -- the port's ranks --------------------------------------------------------

def _run(inp, cp, causal, rate):
    r = ps.get_context_parallel_rank()
    q, k, v = (_shard(inp[n], cp, r).requires_grad_() for n in "qkv")
    o = ulysses_attention(q, k, v, causal=causal, dropout_rate=rate,
                          dropout_seed=SEED if rate else None)
    (o ** 2).sum().backward()
    return dict(out=o.detach(), grads=[t.grad for t in (q, k, v)])


def _errors(inp, cp):
    msgs = {}
    q = torch.zeros(1, cp + 1, 64, 32)
    for label, call in (
            ("heads", lambda: ulysses_attention(q, q, q)),
            ("custom name", lambda: ulysses_attention(
                q, q, q, axis_name="contxt")),
            ("no seed", lambda: ulysses_attention(
                q, q, q, dropout_rate=0.1))):
        try:
            call()
            msgs[label] = None
        except (ValueError, RuntimeError) as e:
            msgs[label] = f"{type(e).__name__}: {e}"
    return msgs


def _reshards(inp, cp):
    r = ps.get_context_parallel_rank()
    group = ps.get_context_parallel_group()
    out = {}
    for shape, split, concat in RESHARDS:
        x = torch.from_numpy(inp["x"][shape][r])
        out[shape] = _reshard(x, group, split, concat)
    return out


def _cases(inp, cp):
    out = {(c, r): _run(inp, cp, c, r) for c, r in CASES}
    out["errors"] = _errors(inp, cp)
    out["reshards"] = _reshards(inp, cp) if cp == 4 else None
    return out


def _rank_main(rank, inp):
    out = {4: _cases(inp, 4)}
    ps.destroy_model_parallel()
    ps.initialize_model_parallel(context_parallel_size_=2)
    out[2] = _cases(inp, 2)
    return out


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    inp = _inputs()
    return inp, spawn_ranks(4, _rank_main, inp, context_parallel_size=4,
                            tmp_dir=str(tmp_path_factory.mktemp("uly")))


def _gathered(ranks, cp, key, field, i=None):
    parts = [r[cp][key][field] if i is None else r[cp][key][field][i]
             for r in ranks[:cp]]
    return torch.cat(parts, dim=2)


# -- the JAX side (JAX imported here only) -----------------------------------

def _jax_mesh(cp):
    import jax
    from apex_tpu.transformer import parallel_state as jps
    jps.destroy_model_parallel()
    jps.initialize_model_parallel(context_parallel_size_=cp,
                                  devices=jax.devices()[:cp])
    return jps


@functools.lru_cache(maxsize=None)
def _jax_ulysses(cp, causal, rate):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from apex_tpu.ops.ulysses_attention import ulysses_attention as july
    inp = _inputs()
    q, k, v = (jnp.asarray(inp[n]) for n in "qkv")
    jps = _jax_mesh(cp)
    spec = P(None, None, "context", None)
    kw = dict(causal=causal, dropout_rate=rate,
              dropout_seed=SEED if rate else None)
    try:
        run = jax.jit(functools.partial(jax.shard_map, check_vma=False)(
            lambda q, k, v: july(q, k, v, **kw), mesh=jps.get_mesh(),
            in_specs=(spec,) * 3, out_specs=spec))

        def body(q, k, v):
            return jax.lax.psum(jnp.sum(july(q, k, v, **kw) ** 2),
                                "context")

        loss = jax.jit(functools.partial(jax.shard_map, check_vma=False)(
            body, mesh=jps.get_mesh(), in_specs=(spec,) * 3,
            out_specs=P()))
        grads = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
        return np.asarray(run(q, k, v)), tuple(np.asarray(g) for g in grads)
    finally:
        jps.destroy_model_parallel()


def _jax_reshard(shape, split, concat):
    """JAX's tiled all_to_all over the 4 context ranks, rank by rank."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    x = jnp.asarray(_inputs()["x"][shape])
    jps = _jax_mesh(4)
    try:
        return np.asarray(jax.jit(functools.partial(
            jax.shard_map, check_vma=False)(
            lambda t: jax.lax.all_to_all(t[0], "context", split, concat,
                                         tiled=True)[None],
            mesh=jps.get_mesh(), in_specs=(P("context"),),
            out_specs=P("context")))(x))
    finally:
        jps.destroy_model_parallel()


def _close(got, want, tol=TOL):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, err


def _dense(causal):
    inp = _inputs()
    q, k, v = (torch.from_numpy(inp[n]).requires_grad_() for n in "qkv")
    o = tattn.flash_attention(q, k, v, causal=causal)
    (o ** 2).sum().backward()
    return o.detach(), [t.grad for t in (q, k, v)]


# -- the tests ---------------------------------------------------------------

@pytest.mark.parametrize("cp", CPS)
@pytest.mark.parametrize("causal,rate", CASES)
def test_ulysses_forward_matches_jax(port_runs, cp, causal, rate):
    _, ranks = port_runs
    got = _gathered(ranks, cp, (causal, rate), "out")
    _close(got, _jax_ulysses(cp, causal, rate)[0])
    if not rate:
        _close(got, _dense(causal)[0].numpy())


@pytest.mark.parametrize("cp", CPS)
@pytest.mark.parametrize("causal,rate", CASES)
def test_ulysses_grads_match_jax(port_runs, cp, causal, rate):
    _, ranks = port_runs
    want = _jax_ulysses(cp, causal, rate)[1]
    dense = None if rate else _dense(causal)[1]
    for i in range(3):
        got = _gathered(ranks, cp, (causal, rate), "grads", i)
        _close(got, want[i])
        if dense is not None:
            _close(got, dense[i].numpy())


@pytest.mark.parametrize("shape,split,concat", RESHARDS)
def test_ulysses_reshard_is_jax_all_to_all(port_runs, shape, split, concat):
    _, ranks = port_runs
    want = _jax_reshard(shape, split, concat)
    for r, rank in enumerate(ranks):
        assert np.array_equal(rank[4]["reshards"][shape].numpy(), want[r])


@pytest.mark.parametrize("cp", CPS)
def test_ulysses_raises_as_jax(port_runs, cp):
    """cp + 1 heads do not divide: JAX's ValueError; a name the topology
    has no group for raises; a rate without a seed raises."""
    _, ranks = port_runs
    msgs = ranks[0][cp]["errors"]
    assert msgs["heads"].startswith("ValueError") \
        and "divisible" in msgs["heads"]
    assert msgs["custom name"] and "contxt" in msgs["custom name"]
    assert msgs["no seed"].startswith("ValueError") \
        and "dropout_seed" in msgs["no seed"]


def test_ulysses_unbound_axis_rule():
    """The canonical context axis with no topology is one rank
    (flash_attention); any other name raises, naming
    initialize_model_parallel; axis_name=None is one rank."""
    ps.destroy_model_parallel()
    inp = _inputs()
    q, k, v = (torch.from_numpy(inp[n][:, :, :64].copy()) for n in "qkv")
    want = tattn.flash_attention(q, k, v, causal=True)
    assert torch.equal(ulysses_attention(q, k, v, causal=True), want)
    assert torch.equal(ulysses_attention(q, k, v, causal=True,
                                         axis_name=None), want)
    with pytest.raises(RuntimeError, match="initialize_model_parallel"):
        ulysses_attention(q, k, v, axis_name="contxt")
