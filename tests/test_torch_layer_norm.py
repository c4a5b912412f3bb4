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
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import layer_norm as jax_layer_norm
from apex_tpu.ops import rms_norm as jax_rms_norm
from apex_tpu_torch.ops import layer_norm, rms_norm

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
