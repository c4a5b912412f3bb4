"""Ring attention on the port against the JAX package (CPU).

The port's counterpart of ``tests/L0/run_attention/test_ring_attention.py``:
``apex_tpu_torch.ops.ring_attention`` at cp = 2 and 4, causal and full,
with attention dropout 0 and 0.1, forward and the q, k and v grads of
``sum(o^2)`` summed over the ranks, against the JAX ring under
``jax.shard_map`` on the host devices that ``tests/conftest.py`` pins
(Pallas in interpret mode) and against the dense run on the gathered
sequence with the same seed (the ring is exact: dropout drops at global
coordinates).  The port's ranks run one process a rank over gloo with
CPU tensors (one spawn of 4 ranks for the module: cp = 4, then the
topology rebuilt at cp = 2 x dp = 2); on the CPU each shard pair takes
the flash kernels' plain versions with fp32 outputs.  The spawned ranks
import this module, torch and the port only: every JAX import sits in a
JAX-side helper.

Also: bf16 operands, whose partials stay fp32 (a ring that rounds each
pair's partials and grads to bf16 fails the same gate); the invisible
causal pairs skipped while their ranks join every hop; JAX's
``ValueError``\\ s; the ``RuntimeError`` of a context axis with no
topology; ``axis_name=None`` as :func:`flash_attention`.

Tolerances: fp32 outputs and grads within 2e-5 of the largest magnitude
of the JAX side (fp32 on both sides in other orders; the JAX test holds
its ring to the dense oracle at 2e-5 forward), and of the port's dense
run; bf16 outputs equal to JAX's on all but 1% of the elements and
within one bf16 ulp of the largest magnitude on the rest, bf16 grads
within 2^-7 of their largest magnitude.
"""
import functools
import importlib

import numpy as np
import pytest
import torch

from apex_tpu_torch.ops import attention as tattn
from apex_tpu_torch.ops.ring_attention import (ring_attention,
                                               ring_attention_reference)
from apex_tpu_torch.parallel import _comm
from apex_tpu_torch.transformer import parallel_state as ps
from apex_tpu_torch.transformer.testing.distributed_test_base import \
    spawn_ranks

from _torch_isolation import restore_torch_from_amp  # noqa: F401

# by module name: the package re-exports the function of the same name
tring_mod = importlib.import_module("apex_tpu_torch.ops.ring_attention")

TOL = 2e-5
TOL_BF16_SHARE = 0.01
TOL_BF16_GRAD = 2.0 ** -7
B, H, S, D = 1, 2, 512, 64      # S / cp = 256 or 128 a rank
CPS = (2, 4)
CASES = [(True, 0.0), (False, 0.0), (True, 0.1), (False, 0.1)]
SEED = 77


def _inputs():
    rng = np.random.RandomState(5)
    return {k: rng.randn(B, H, S, D).astype(np.float32)
            for k in ("q", "k", "v")}


def _shard(a, cp, r, dtype=torch.float32):
    s = a.shape[2] // cp
    return torch.from_numpy(
        np.ascontiguousarray(a[:, :, r * s:(r + 1) * s])).to(dtype)


# -- the port's ranks --------------------------------------------------------

def _ring_run(inp, cp, causal, rate, dtype=torch.float32):
    r = ps.get_context_parallel_rank()
    q, k, v = (_shard(inp[n], cp, r, dtype).requires_grad_()
               for n in "qkv")
    o = ring_attention(q, k, v, causal=causal, dropout_rate=rate,
                       dropout_seed=SEED if rate else None)
    (o.float() ** 2).sum().backward()
    return dict(out=o.detach(), grads=[t.grad for t in (q, k, v)])


def _rounded_run(inp, cp):
    """The bf16 causal ring with each pair's partials and grads rounded
    to bf16 (what fp32 outputs prevent)."""
    fwd, bwd = tring_mod._fwd, tring_mod._bwd

    def fwd16(*a, **kw):
        out, lse = fwd(*a, **kw)
        return out.to(torch.bfloat16).float(), lse

    def bwd16(*a, **kw):
        return tuple(t.to(torch.bfloat16).float() for t in bwd(*a, **kw))

    tring_mod._fwd, tring_mod._bwd = fwd16, bwd16
    try:
        return _ring_run(inp, cp, True, 0.0, torch.bfloat16)
    finally:
        tring_mod._fwd, tring_mod._bwd = fwd, bwd


def _count_run(inp, cp):
    """The causal ring's kernel calls and hops on this rank."""
    calls = {"fwd": 0, "bwd": 0, "hop": 0}
    fwd, bwd, hop = tring_mod._fwd, tring_mod._bwd, _comm.ring_hop

    def wrap(name, fn):
        def counted(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return counted

    tring_mod._fwd, tring_mod._bwd = wrap("fwd", fwd), wrap("bwd", bwd)
    _comm.ring_hop = wrap("hop", hop)
    try:
        _ring_run(inp, cp, True, 0.0)
    finally:
        tring_mod._fwd, tring_mod._bwd, _comm.ring_hop = fwd, bwd, hop
    return calls


def _error_run():
    """JAX's ValueErrors, raised on every rank alike (no collective
    runs before them)."""
    q = torch.zeros(1, 2, 128, 64)
    msgs = {}
    for label, kw in (("rate 1", dict(dropout_rate=1.0, dropout_seed=1)),
                      ("no seed", dict(dropout_rate=0.1)),
                      ("shard length", dict(block_q=128))):
        qq = torch.zeros(1, 2, 200, 64) if label == "shard length" else q
        try:
            ring_attention(qq, qq, qq, **kw)
            msgs[label] = None
        except ValueError as e:
            msgs[label] = str(e)
    return msgs


def _cases(inp, cp):
    out = {(causal, rate): _ring_run(inp, cp, causal, rate)
           for causal, rate in CASES}
    out["bf16"] = _ring_run(inp, cp, True, 0.0, torch.bfloat16)
    out["bf16 rounded"] = _rounded_run(inp, cp)
    out["calls"] = _count_run(inp, cp)
    out["errors"] = _error_run()
    return out


def _rank_main(rank, inp):
    out = {4: _cases(inp, 4)}
    ps.destroy_model_parallel()
    ps.initialize_model_parallel(context_parallel_size_=2)
    out[2] = _cases(inp, 2)
    out["cp2 rank"] = ps.get_context_parallel_rank()
    return out


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    inp = _inputs()
    ranks = spawn_ranks(4, _rank_main, inp, context_parallel_size=4,
                        tmp_dir=str(tmp_path_factory.mktemp("ring")))
    return inp, ranks


def _gathered(ranks, cp, key, field, i=None):
    """The context ranks' shards of one run put together (cp = 2: the
    first data rank's two context ranks, global ranks 0 and 1)."""
    parts = [r[cp][key][field] if i is None else r[cp][key][field][i]
             for r in ranks[:cp]]
    return torch.cat(parts, dim=2)


# -- the JAX side (JAX imported here only) -----------------------------------

@functools.lru_cache(maxsize=None)
def _jax_ring(cp, causal, rate, bf16=False):
    """The JAX ring under shard_map on the first cp host devices: (out,
    (dq, dk, dv)) of sum(o^2) psummed over the context axis."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from apex_tpu.ops.ring_attention import ring_attention as jring
    from apex_tpu.transformer import parallel_state as jps
    inp = _inputs()
    dt = jnp.bfloat16 if bf16 else jnp.float32
    q, k, v = (jnp.asarray(inp[n]).astype(dt) for n in "qkv")
    jps.destroy_model_parallel()
    jps.initialize_model_parallel(context_parallel_size_=cp,
                                  devices=jax.devices()[:cp])
    spec = P(None, None, "context", None)
    kw = dict(causal=causal, dropout_rate=rate,
              dropout_seed=SEED if rate else None)
    try:
        run = jax.jit(functools.partial(jax.shard_map, check_vma=False)(
            lambda q, k, v: jring(q, k, v, **kw), mesh=jps.get_mesh(),
            in_specs=(spec,) * 3, out_specs=spec))

        def body(q, k, v):
            o = jring(q, k, v, **kw)
            return jax.lax.psum(jnp.sum(o.astype(jnp.float32) ** 2),
                                "context")

        loss = jax.jit(functools.partial(jax.shard_map, check_vma=False)(
            body, mesh=jps.get_mesh(), in_specs=(spec,) * 3,
            out_specs=P()))
        grads = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
        return (np.asarray(run(q, k, v).astype(jnp.float32)),
                tuple(np.asarray(g.astype(jnp.float32)) for g in grads))
    finally:
        jps.destroy_model_parallel()


def _close(got, want, tol=TOL):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, err


def _dense(causal, rate, dtype=torch.float32):
    """The port's dense run on the gathered sequence: out and the grads
    of sum(o^2)."""
    inp = _inputs()
    q, k, v = (torch.from_numpy(inp[n]).to(dtype).requires_grad_()
               for n in "qkv")
    o = ring_attention_reference(q, k, v, causal=causal, dropout_rate=rate,
                                 dropout_seed=SEED if rate else None)
    (o.float() ** 2).sum().backward()
    return o.detach(), [t.grad for t in (q, k, v)]


# -- the tests ---------------------------------------------------------------

@pytest.mark.parametrize("cp", CPS)
@pytest.mark.parametrize("causal,rate", CASES)
def test_ring_forward_matches_jax_and_the_dense_run(port_runs, cp, causal,
                                                    rate):
    _, ranks = port_runs
    got = _gathered(ranks, cp, (causal, rate), "out")
    want, _ = _jax_ring(cp, causal, rate)
    _close(got, want)
    _close(got, _dense(causal, rate)[0].numpy())


@pytest.mark.parametrize("cp", CPS)
@pytest.mark.parametrize("causal,rate", CASES)
def test_ring_grads_match_jax_and_the_dense_run(port_runs, cp, causal, rate):
    _, ranks = port_runs
    _, want = _jax_ring(cp, causal, rate)
    _, dense = _dense(causal, rate)
    for i in range(3):
        got = _gathered(ranks, cp, (causal, rate), "grads", i)
        _close(got, want[i])
        _close(got, dense[i].numpy())


def _bf16_gate(out, grads, want_out, want_grads):
    """bf16 outputs against JAX's: equal on all but TOL_BF16_SHARE of the
    elements, the rest within one bf16 ulp of the largest magnitude;
    the grads within TOL_BF16_GRAD of their largest magnitude."""
    o = out.float().numpy()
    diff = np.abs(o - want_out)
    ulp = np.abs(want_out).max() * 2.0 ** -7
    ok = bool((diff != 0).mean() <= TOL_BF16_SHARE and diff.max() <= ulp)
    for g, w in zip(grads, want_grads):
        g = g.float().numpy()
        ok = ok and bool(np.abs(g - w).max() <= TOL_BF16_GRAD
                         * np.abs(w).max())
    return ok


@pytest.mark.parametrize("cp", CPS)
def test_ring_bf16_partials_stay_fp32(port_runs, cp):
    """bf16 operands: the ring against JAX's bf16 ring (whose partials
    are fp32) passes the bf16 gate; the same ring with each pair's
    partials and grads rounded to bf16 fails it."""
    _, ranks = port_runs
    want_out, want_grads = _jax_ring(cp, True, 0.0, bf16=True)
    for key, ok in (("bf16", True), ("bf16 rounded", False)):
        out = _gathered(ranks, cp, key, "out")
        grads = [_gathered(ranks, cp, key, "grads", i) for i in range(3)]
        assert out.dtype == torch.bfloat16
        assert _bf16_gate(out, grads, want_out, want_grads) is ok, key


@pytest.mark.parametrize("cp", CPS)
def test_ring_skips_invisible_pairs_but_joins_every_hop(port_runs, cp):
    """Causal: rank r computes its r + 1 visible pairs forward and
    backward and skips the rest, yet every rank makes the same hops: cp
    - 1 forward (K/V), cp - 1 + cp backward (K/V, then the dk/dv
    accumulators home)."""
    _, ranks = port_runs
    assert [r["cp2 rank"] for r in ranks] == [0, 1, 0, 1]
    for rank, r in enumerate(ranks[:cp]):
        assert r[cp]["calls"] == {"fwd": rank + 1, "bwd": rank + 1,
                                  "hop": 3 * cp - 2}, r[cp]["calls"]


@pytest.mark.parametrize("cp", CPS)
def test_ring_value_errors_match_jax(port_runs, cp):
    _, ranks = port_runs
    msgs = ranks[0][cp]["errors"]
    assert "dropout_rate must be in [0, 1)" in msgs["rate 1"]
    assert "requires dropout_seed" in msgs["no seed"]
    assert "must tile into lane-multiple blocks" in msgs["shard length"]


def test_ring_without_topology_raises_and_none_axis_is_flash():
    ps.destroy_model_parallel()
    q, k, v = (torch.from_numpy(_inputs()[n][:, :, :128].copy())
               for n in "qkv")
    with pytest.raises(RuntimeError, match="initialize_model_parallel"):
        ring_attention(q, k, v)
    got = ring_attention(q, k, v, causal=True, axis_name=None)
    want = tattn.flash_attention(q, k, v, causal=True)
    assert torch.equal(got, want)
