"""Port parity: ``apex_tpu_torch.ops.layer_norm`` against the JAX
package's ``apex_tpu.ops`` norms on the same numpy inputs.

The JAX side runs as its own tests run it on the CPU: the Pallas kernel
in interpret mode where ``hidden % 128 == 0``, its jnp reference
otherwise.  The port's CPU path is the plain PyTorch version of the
CUDA kernel.  Tolerances: fp32 — 1e-5 (both compute fp32 statistics,
in a different reduction order); bf16 — one bf16 ulp of the output's
magnitude (2^-7 relative: both round the same fp32 value, which may sit
on either side of a rounding boundary).
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import layer_norm as jax_layer_norm
from apex_tpu.ops import rms_norm as jax_rms_norm
from apex_tpu_torch.ops import layer_norm, rms_norm

from _torch_isolation import restore_torch_from_amp  # noqa: F401

# by module name: both packages re-export functions called layer_norm
jln = importlib.import_module("apex_tpu.ops.layer_norm")
tln = importlib.import_module("apex_tpu_torch.ops.layer_norm")

_DTYPES = {"float32": (jnp.float32, torch.float32),
           "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(shape, dtype, seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) * 2 + 0.5).astype(np.float32)
    w = (1 + 0.1 * rng.randn(shape[-1])).astype(np.float32)
    b = (0.1 * rng.randn(shape[-1])).astype(np.float32)
    jd, td = _DTYPES[dtype]
    return ((jnp.asarray(x, jd), jnp.asarray(w, jd), jnp.asarray(b, jd)),
            (torch.from_numpy(x).to(td), torch.from_numpy(w).to(td),
             torch.from_numpy(b).to(td)))


def _close(jax_out, torch_out, dtype):
    ref = np.asarray(jax_out.astype(jnp.float32))
    got = torch_out.float().numpy()
    assert got.shape == ref.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    else:
        atol = 2.0 ** -7 * max(1.0, float(np.abs(ref).max()))
        np.testing.assert_allclose(got, ref, rtol=0, atol=atol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(6, 128), (3, 5, 256), (7, 200)])
def test_rms_norm_matches_jax(shape, dtype):
    (jx, jw, _), (tx, tw, _) = _inputs(shape, dtype, seed=1)
    _close(jax_rms_norm(jx, jw, eps=1e-5), rms_norm(tx, tw, eps=1e-5),
           dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(6, 128), (3, 5, 256), (7, 200)])
def test_layer_norm_matches_jax(shape, dtype):
    (jx, jw, jb), (tx, tw, tb) = _inputs(shape, dtype, seed=2)
    _close(jax_layer_norm(jx, jw, jb, eps=1e-5),
           layer_norm(tx, tw, tb, eps=1e-5), dtype)


def test_norms_without_affine_match_jax():
    (jx, _, _), (tx, _, _) = _inputs((4, 96), "float32", seed=3)
    _close(jax_rms_norm(jx), rms_norm(tx), "float32")
    _close(jax_layer_norm(jx), layer_norm(tx), "float32")


def test_fp32_weight_on_bf16_input_matches_jax():
    """The serving path may hold fp32 norm weights beside bf16
    activations: the output stays in the input dtype."""
    (jx, _, _), (tx, _, _) = _inputs((5, 128), "bfloat16", seed=4)
    w = (1 + 0.1 * np.random.RandomState(5).randn(128)).astype(np.float32)
    got = rms_norm(tx, torch.from_numpy(w))
    assert got.dtype == torch.bfloat16
    _close(jax_rms_norm(jx, jnp.asarray(w)), got, "bfloat16")


# -- the backward at the card kernel's edge shapes -----------------------
#
# One row and a few, at hidden on both sides of each line where the card
# kernel changes its instance (2048: the widest unaligned row it holds in
# registers; 4096: the widest bf16 row; wider rows in passes), for each
# dtype pair, through the JAX Pallas backward in interpret mode and the
# port's plain version.  Tolerances as in the training slice's backward
# test: fp32 dx 1e-5 relative, bf16 dx one bf16 ulp of its magnitude
# (both round the same fp32 value), dw and db 1e-5 of their magnitude
# (fp32 sums over rows in another order).

_PAIRS = {"fp32/fp32": ("float32", "float32"),
          "bf16/fp32": ("bfloat16", "float32"),
          "bf16/bf16": ("bfloat16", "bfloat16")}


@pytest.mark.parametrize("pair", list(_PAIRS))
@pytest.mark.parametrize("rows", [1, 7])
@pytest.mark.parametrize("hidden", [64, 1001, 2048, 2056, 4096, 4104, 8192,
                                    8200])
@pytest.mark.parametrize("rms", [True, False])
def test_norm_bwd_edge_shapes_match_jax(pair, rows, hidden, rms):
    xd, wd = _PAIRS[pair]
    rng = np.random.RandomState(hidden + rows)
    x = (rng.randn(rows, hidden) * 2 + 0.5).astype(np.float32)
    w = (1 + 0.1 * rng.randn(hidden)).astype(np.float32)
    dy = rng.randn(rows, hidden).astype(np.float32)
    jx, jw, jdy = (jnp.asarray(a, _DTYPES[d][0])
                   for a, d in ((x, xd), (w, wd), (dy, xd)))
    tx, tw, tdy = (torch.from_numpy(a).to(_DTYPES[d][1])
                   for a, d in ((x, xd), (w, wd), (dy, xd)))
    jdx, jdw, jdb = jln._bwd_2d(jx, jw, jdy, 1e-5, rms)
    tdx, tdw, tdb = tln._bwd_2d(tx, tw, tdy, 1e-5, rms)
    assert tdx.dtype == tx.dtype and tdw.dtype == torch.float32
    ref = np.asarray(jdx.astype(jnp.float32))
    if xd == "float32":
        np.testing.assert_allclose(tdx.numpy(), ref, rtol=1e-5, atol=2e-5)
    else:
        np.testing.assert_allclose(tdx.float().numpy(), ref, rtol=0,
                                   atol=2.0 ** -7 * np.abs(ref).max())
    for got, ref in ((tdw, jdw), (tdb, jdb)) if not rms else ((tdw, jdw),):
        ref = np.asarray(ref).reshape(-1)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5,
                                   atol=1e-5 * np.abs(ref).max())
    assert (tdb is None) == rms
