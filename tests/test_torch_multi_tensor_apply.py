"""Port parity: ``apex_tpu_torch.multi_tensor_apply`` and its two
kernels' plain versions (``fused_axpby``, ``fused_l2norm_scale``)
against ``apex_tpu.multi_tensor_apply`` and ``apex_tpu.ops.fused_update``
on the same numpy-seeded inputs (CPU; the JAX kernels in Pallas
interpret mode, as the JAX package's own tests run them), and
``tree_ravel`` over lists against ``jax.flatten_util.ravel_pytree``.

The lists mix fp32 and bf16 leaves (bf16 made by rounding the same fp32
numbers on both sides), so the raveled buffer is fp32 and each output
leaf is cast back to its own dtype.

Tolerances: fp32 outputs within 1e-6 of their magnitude (XLA may
contract ``a*x + b*y`` into a fused multiply-add where the port rounds
each product); bf16 leaves within one bf16 ulp (2^-7 relative: an fp32
difference of one ulp can move a rounding tie); norms and per-tensor
norms within 1e-6 relative (fp32 sums in another order); flags exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from apex_tpu import multi_tensor_apply as jmta
from apex_tpu.ops import fused_update as jfu
from apex_tpu_torch import multi_tensor_apply as tmta
from apex_tpu_torch.ops import _build
from apex_tpu_torch.ops import fused_update as tfu
from apex_tpu_torch.utils import tree_ravel

from _torch_isolation import restore_torch_from_amp  # noqa: F401

_REL = 1e-6
_BF16_REL = 2.0 ** -7

# (shape, dtype) of each leaf: fp32 and bf16, an empty leaf among them
_LEAVES = [((37, 5), "f32"), ((100,), "bf16"), ((0,), "f32"),
           ((3, 4, 5), "bf16"), ((1001,), "f32")]


def _lists(seed, scale=1.0, leaves=_LEAVES):
    """The same list for both packages: ``(jax list, torch list)``."""
    rng = np.random.RandomState(seed)
    jl, tl = [], []
    for shape, dt in leaves:
        a = (rng.randn(*shape) * scale).astype(np.float32)
        if dt == "bf16":
            jl.append(jnp.asarray(a, jnp.bfloat16))
            tl.append(torch.from_numpy(a).to(torch.bfloat16))
        else:
            jl.append(jnp.asarray(a))
            tl.append(torch.from_numpy(a))
    return jl, tl


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, rel=_REL):
    g, w = _np(got), _np(want)
    assert g.shape == w.shape
    np.testing.assert_allclose(g, w, rtol=rel,
                               atol=rel * max(1.0, np.abs(w).max(initial=0)))


def _same_leaves(got, want):
    """Each port leaf against the JAX leaf: shape, dtype, values."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        bf = w.dtype == jnp.bfloat16
        assert g.dtype == (torch.bfloat16 if bf else torch.float32)
        _close(g, w, _BF16_REL if bf else _REL)


def test_tree_ravel_over_a_list_matches_ravel_pytree():
    jl, tl = _lists(1)
    jflat, junravel = ravel_pytree(jl)
    tflat, tunravel = tree_ravel(tl)
    assert tflat.dtype == torch.float32 and jflat.dtype == jnp.float32
    np.testing.assert_array_equal(_np(tflat), _np(jflat))
    back = tunravel(tflat)
    assert isinstance(back, list)
    for g, w in zip(back, junravel(jflat)):
        assert tuple(g.shape) == w.shape
        np.testing.assert_array_equal(_np(g), _np(w))
    assert [t.dtype for t in back] == [t.dtype for t in tl]
    # tuples keep their type, nested lists and dicts their order
    tree = (tl[0], {"b": [tl[1], tl[3]], "a": tl[4]})
    jtree = (jl[0], {"b": [jl[1], jl[3]], "a": jl[4]})
    np.testing.assert_array_equal(_np(tree_ravel(tree)[0]),
                                  _np(ravel_pytree(jtree)[0]))
    again = tree_ravel(tree)[1](tree_ravel(tree)[0])
    assert isinstance(again, tuple) and isinstance(again[1]["b"], list)
    # an empty list: an empty fp32 buffer, unravelled to an empty list
    flat, unravel = tree_ravel([])
    assert flat.dtype == torch.float32 and flat.numel() == 0
    assert unravel(flat) == [] and ravel_pytree([])[0].shape == (0,)


@pytest.mark.parametrize("dtypes", [("f32", "f32"), ("bf16", "bf16"),
                                    ("f32", "bf16")])
@pytest.mark.parametrize("poison", [None, np.inf, np.nan])
def test_fused_axpby_matches_jax(dtypes, poison):
    rng = np.random.RandomState(2)
    n = 70001
    x, y = (rng.randn(n).astype(np.float32) * 10 for _ in range(2))
    if poison is not None:
        y[12345] = poison
    conv = {"f32": (jnp.float32, torch.float32),
            "bf16": (jnp.bfloat16, torch.bfloat16)}
    (jx_t, tx_t), (jy_t, ty_t) = conv[dtypes[0]], conv[dtypes[1]]
    jout, jflag = jfu.fused_axpby(0.75, jnp.asarray(x, jx_t), -1.5,
                                  jnp.asarray(y, jy_t))
    tout, tflag = tfu.fused_axpby(0.75, torch.from_numpy(x).to(tx_t), -1.5,
                                  torch.from_numpy(y).to(ty_t))
    assert tout.dtype == tx_t and tflag.dtype == torch.float32
    assert float(tflag) == float(jflag) == (poison is not None)
    finite = np.isfinite(_np(jout))
    np.testing.assert_array_equal(np.isfinite(_np(tout)), finite)
    _close(_np(tout)[finite], _np(jout)[finite],
           _BF16_REL if dtypes[0] == "bf16" else _REL)


@pytest.mark.parametrize("dtype,out_dtype", [("f32", None), ("bf16", None),
                                             ("f32", "bf16")])
@pytest.mark.parametrize("poison", [None, np.inf])
def test_fused_l2norm_scale_matches_jax(dtype, out_dtype, poison):
    rng = np.random.RandomState(3)
    n = 70001
    x = (rng.randn(n) * 1e3).astype(np.float32)
    if poison is not None:
        x[777] = poison
    conv = {"f32": (jnp.float32, torch.float32),
            "bf16": (jnp.bfloat16, torch.bfloat16), None: (None, None)}
    jd, td = conv[dtype]
    jo, to = conv[out_dtype]
    jout, jnorm, jflag = jfu.fused_l2norm_scale(jnp.asarray(x, jd), 2.0 ** -10,
                                                jo)
    tout, tnorm, tflag = tfu.fused_l2norm_scale(torch.from_numpy(x).to(td),
                                                2.0 ** -10, to)
    assert tout.dtype == (to or td)
    assert float(tflag) == float(jflag) == (poison is not None)
    if poison is None:
        _close(tout, jout, _BF16_REL if (to or td) == torch.bfloat16
               else _REL)
        # the norm of the fp32 products, before the cast to out_dtype
        _close(tnorm, jnorm)


def test_fused_kernels_empty_buffers_return_zeros_without_a_launch():
    _build.reset_launch_counts()
    out, flag = tfu.fused_axpby(2.0, torch.zeros(0), 3.0, torch.zeros(0))
    assert out.shape == (0,) and float(flag) == 0.0
    out, norm, flag = tfu.fused_l2norm_scale(torch.zeros(0, dtype=torch.bfloat16),
                                             2.0, torch.float32)
    assert out.dtype == torch.float32 and float(norm) == float(flag) == 0.0
    jout, jnorm, jflag = jfu.fused_l2norm_scale(jnp.zeros((0,)), 2.0)
    assert float(jnorm) == float(jflag) == 0.0
    assert set(_build.launch_counts().values()) == {0}


def _ops(seed, scale=1.0):
    """The four ops' arguments for both packages."""
    jx, tx = _lists(seed, scale)
    jy, ty = _lists(seed + 1, scale)
    return [("scale", (jmta.multi_tensor_scale, [jx], (0.5,)),
             (tmta.multi_tensor_scale, [tx], (0.5,))),
            ("axpby", (jmta.multi_tensor_axpby, [jx, jy], (2.0, -0.5)),
             (tmta.multi_tensor_axpby, [tx, ty], (2.0, -0.5))),
            ("l2norm", (jmta.multi_tensor_l2norm, [jx], (True,)),
             (tmta.multi_tensor_l2norm, [tx], (True,))),
            ("l2norm_scale", (jmta.multi_tensor_l2norm_scale, [jx],
                              (0.25, True)),
             (tmta.multi_tensor_l2norm_scale, [tx], (0.25, True)))]


@pytest.mark.parametrize("noop", [0.0, 1.0])
@pytest.mark.parametrize("op", ["scale", "axpby", "l2norm", "l2norm_scale"])
def test_multi_tensor_ops_match_jax(op, noop):
    """Each op through ``multi_tensor_applier`` on both sides: outputs
    leaf by leaf in each leaf's dtype, norms, per-tensor norms (those of
    l2norm_scale from its rounded outputs) and the flag, with
    ``noop_flag`` passed through as max(noop, flag)."""
    (_, (jop, jlists, args), (top, tlists, _)), = [
        c for c in _ops(4) if c[0] == op]
    want = jmta.multi_tensor_applier(jop, noop, jlists, *args)
    got = tmta.multi_tensor_applier(top, noop, tlists, *args)
    assert len(got) == len(want)
    if op in ("scale", "axpby"):
        _same_leaves(got[0], want[0])
        assert float(got[1]) == float(want[1]) == noop
    elif op == "l2norm":
        _close(got[0], want[0])
        _close(got[1], want[1])
    else:
        outs, gnorm, norms, found = got
        _same_leaves(outs, want[0])
        _close(gnorm, want[1])
        _close(norms, want[2])
        # per-tensor norms of the ROUNDED outputs, as the JAX shim
        np.testing.assert_array_equal(
            _np(norms), _np(tmta._per_tensor_norms(outs)))
        assert float(found) == float(want[3]) == noop


@pytest.mark.parametrize("op", ["scale", "axpby", "l2norm_scale"])
def test_an_inf_in_one_leaf_raises_the_flag(op):
    (_, (jop, jlists, args), (top, tlists, _)), = [
        c for c in _ops(5) if c[0] == op]
    jlists[0][3] = jlists[0][3].at[1, 2, 3].set(jnp.inf)
    tlists[0][3] = tlists[0][3].clone()
    tlists[0][3][1, 2, 3] = float("inf")
    want = jmta.multi_tensor_applier(jop, 0.0, jlists, *args)
    got = tmta.multi_tensor_applier(top, 0.0, tlists, *args)
    assert float(got[-1]) == float(want[-1]) == 1.0


def test_empty_lists_and_the_applier_signature():
    applier = tmta.MultiTensorApply(2048 * 32)
    assert applier.available and applier.chunk_size == 65536
    outs, found = applier(tmta.multi_tensor_scale, 0.0, [[]], 2.0)
    jouts, jfound = jmta.multi_tensor_applier(jmta.multi_tensor_scale, 0.0,
                                              [[]], 2.0)
    assert outs == [] == jouts and float(found) == float(jfound) == 0.0
    gnorm, none = applier(tmta.multi_tensor_l2norm, 1.0, [[]])
    assert float(gnorm) == 0.0 and none is None
    assert tmta.__all__ == jmta.__all__


def test_shim_on_cpu_launches_nothing():
    _build.reset_launch_counts()
    for _, _, (op, lists, args) in _ops(6):
        tmta.multi_tensor_applier(op, 0.0, lists, *args)
    assert set(_build.launch_counts().values()) == {0}
    assert _build._LIB is None


def test_package_exports_the_shim_and_the_kernels():
    import apex_tpu_torch
    from apex_tpu_torch import ops
    assert apex_tpu_torch.multi_tensor_apply is tmta
    assert ops.fused_axpby is tfu.fused_axpby
    assert ops.fused_l2norm_scale is tfu.fused_l2norm_scale
