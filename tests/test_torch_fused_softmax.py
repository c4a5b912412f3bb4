"""The port's ``transformer.functional.fused_softmax`` and
``transformer.enums`` against the JAX package on the same seeded numpy
inputs (CPU).

Every function runs each step in the working dtype on both sides, so
the tolerance is 1e-6 absolute in fp32 (summation order) and one ulp of
the working type otherwise (``eps``: the ulp at 1, the probabilities
lying in [0, 1]; exp and the row sum may round across a boundary).
Inputs cross as fp32 numpy arrays, cast to the working type on each
side (both round to nearest even).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.transformer import enums as jenums
from apex_tpu.transformer.functional import fused_softmax as jfs
from apex_tpu_torch.transformer import enums as tenums
from apex_tpu_torch.transformer import functional as tfunc
from apex_tpu_torch.transformer.functional import fused_softmax as tfs

from _torch_isolation import restore_torch_from_amp  # noqa: F401

_DTYPES = {"fp32": (torch.float32, jnp.float32, 1e-6),
           "bf16": (torch.bfloat16, jnp.bfloat16, 2.0 ** -7),
           "fp16": (torch.float16, jnp.float16, 2.0 ** -10)}


def _scores(shape, seed, scale=3.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _mask(shape, seed, full_row=True):
    """True = masked; row 0 of every head fully masked."""
    m = np.random.RandomState(seed + 100).rand(*shape) < 0.3
    if full_row:
        m[..., 0, :] = True
    return m


def _both(x, dt):
    tdt, jdt, _ = _DTYPES[dt]
    return torch.from_numpy(x).to(tdt), jnp.asarray(x).astype(jdt)


def _close(got, want, dt):
    tol = _DTYPES[dt][2]
    assert got.dtype == _DTYPES[dt][0]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=0, atol=tol)


def test_enums_match_jax():
    for name in ("ModelType", "LayerType", "AttnType", "AttnMaskType"):
        t, j = getattr(tenums, name), getattr(jenums, name)
        assert [(m.name, m.value) for m in t] == \
            [(m.name, m.value) for m in j]


def test_functional_exports_match_jax():
    for name in jfs.__all__:
        assert name in tfunc.__all__ and getattr(tfunc, name) is \
            getattr(tfs, name)
    assert tfs.GenericScaledMaskedSoftmax is tfs.ScaledMaskedSoftmax


@pytest.mark.parametrize("dt", list(_DTYPES))
@pytest.mark.parametrize("scale", [None, 0.125])
@pytest.mark.parametrize("sq,sk", [(12, 12), (8, 20)])
def test_scaled_upper_triang_matches_jax(dt, scale, sq, sk):
    tx, jx = _both(_scores((3, sq, sk), sq * sk), dt)
    got = tfs.ScaledUpperTriangMaskedSoftmax(tx, scale)
    want = jfs.ScaledUpperTriangMaskedSoftmax(jx, scale)
    _close(got, want, dt)
    # keeps tril(k = sk - sq): the first row sees sk - sq + 1 keys
    assert np.all(got[:, 0, sk - sq + 1:].float().numpy() == 0)


@pytest.mark.parametrize("dt", list(_DTYPES))
@pytest.mark.parametrize("scale", [None, 0.5])
@pytest.mark.parametrize("masked", [True, False])
def test_scaled_masked_softmax_matches_jax(dt, scale, masked):
    shape = (2, 3, 10, 16)
    tx, jx = _both(_scores(shape, 4), dt)
    m = _mask((2, 1, 10, 16), 4) if masked else None
    got = tfs.ScaledMaskedSoftmax(
        tx, None if m is None else torch.from_numpy(m), scale)
    want = jfs.ScaledMaskedSoftmax(
        jx, None if m is None else jnp.asarray(m), scale)
    _close(got, want, dt)
    got_g = tfs.GenericScaledMaskedSoftmax(
        tx, None if m is None else torch.from_numpy(m), scale)
    assert torch.equal(got_g, got)
    if masked:
        # a fully masked row is uniform, not 0
        row = got[:, :, 0].float().numpy()
        np.testing.assert_allclose(row, 1.0 / 16, rtol=0,
                                   atol=_DTYPES[dt][2])


@pytest.mark.parametrize("dt", list(_DTYPES))
@pytest.mark.parametrize("scale", [None, 2.0])
def test_scaled_softmax_matches_jax(dt, scale):
    tx, jx = _both(_scores((4, 6, 24), 5), dt)
    _close(tfs.ScaledSoftmax(tx, scale), jfs.ScaledSoftmax(jx, scale), dt)


def _mask_func(x, mask):
    return x.masked_fill(mask, -10000.0)


def _jmask_func(x, mask):
    return jnp.where(mask, -10000.0, x)


def _module_pair(dt, mask_type, fusion, in_fp32, scale, with_func):
    fp16, bf16 = dt == "fp16", dt == "bf16"
    tt = getattr(tenums.AttnMaskType, mask_type)
    jt = getattr(jenums.AttnMaskType, mask_type)
    return (tfs.FusedScaleMaskSoftmax(fp16, bf16, tt, fusion,
                                      _mask_func if with_func else None,
                                      in_fp32, scale),
            jfs.FusedScaleMaskSoftmax(fp16, bf16, jt, fusion,
                                      _jmask_func if with_func else None,
                                      in_fp32, scale))


@pytest.mark.parametrize("dt", list(_DTYPES))
@pytest.mark.parametrize("mask_type,with_mask", [
    ("causal", False), ("causal", True), ("padding", True),
    ("padding", False)])
@pytest.mark.parametrize("fusion", [True, False])
@pytest.mark.parametrize("in_fp32,scale", [(True, None), (True, 0.25),
                                           (False, None)])
def test_fused_scale_mask_softmax_matches_jax(dt, mask_type, with_mask,
                                              fusion, in_fp32, scale):
    """Both routes of ``__call__`` (``fusion`` picks one), the causal
    and padding masks and no mask, ``softmax_in_fp32`` on and off, with
    and without a scale; fully masked rows included."""
    shape = (2, 3, 8, 12)
    tx, jx = _both(_scores(shape, 6), dt)
    m = _mask((2, 1, 8, 12), 6) if with_mask else None
    tmod, jmod = _module_pair(dt, mask_type, fusion, in_fp32, scale, False)
    assert tmod.is_kernel_available(None, *shape) == \
        jmod.is_kernel_available(None, *shape) == fusion
    got = tmod(tx, None if m is None else torch.from_numpy(m))
    want = jmod(jx, None if m is None else jnp.asarray(m))
    _close(got, want, dt)
    # and each route called directly
    for route in ("forward_fused_softmax", "forward_torch_softmax"):
        _close(getattr(tmod, route)(tx, None if m is None
                                    else torch.from_numpy(m)),
               getattr(jmod, route)(jx, None if m is None
                                    else jnp.asarray(m)), dt)


@pytest.mark.parametrize("dt", list(_DTYPES))
def test_mask_func_route_matches_jax(dt):
    """``mask_func`` replaces the finfo.min masking on the eager route:
    a fully masked row under -10000 is uniform too."""
    shape = (2, 2, 6, 10)
    tx, jx = _both(_scores(shape, 7), dt)
    m = _mask((2, 1, 6, 10), 7)
    tmod, jmod = _module_pair(dt, "padding", False, True, None, True)
    _close(tmod(tx, torch.from_numpy(m)), jmod(jx, jnp.asarray(m)), dt)


def test_the_two_runtime_errors_match_jax():
    pad_t, pad_j = tenums.AttnMaskType.padding, jenums.AttnMaskType.padding
    for cls, mt in ((tfs.FusedScaleMaskSoftmax, pad_t),
                    (jfs.FusedScaleMaskSoftmax, pad_j)):
        with pytest.raises(RuntimeError, match="both fp16 and bf16"):
            cls(True, True, mt, True, None, True, None)
        with pytest.raises(RuntimeError, match="fp32 when scaled"):
            cls(True, False, mt, True, None, False, 0.5)
    mod = tfs.FusedScaleMaskSoftmax(False, False, pad_t, True, None, True,
                                    None)
    with pytest.raises(AssertionError):
        mod(torch.zeros(2, 3, 4), None)


def test_softmax_in_fp32_casts_back_and_upcasts():
    """With ``softmax_in_fp32`` a 16-bit input is upcast (the fp32
    result, cast back, equals the fp32 softmax rounded once) and the
    output keeps the input dtype; without it the softmax runs in bf16."""
    x = _scores((1, 2, 4, 9), 8)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    up, _ = _module_pair("bf16", "padding", True, True, None, False)
    down, _ = _module_pair("bf16", "padding", True, False, None, False)
    got = up(tx, None)
    assert got.dtype == torch.bfloat16
    ref = torch.softmax(tx.float(), -1)
    assert (got.float() - ref).abs().max() <= 2.0 ** -9   # one rounding
    assert down(tx, None).dtype == torch.bfloat16
