"""The port's softmax cross entropy (``ops/xentropy.py``, the
``contrib.xentropy`` shim) and the tp = 1 ``half_residuals`` cross
entropy, against the JAX package on the same seeded numpy inputs (CPU).

Tolerances: fp32 loss and logits grad 1e-6 absolute (logits of order 2,
the two sides differ in reduction order only).  The scatter backward
equals the one-hot formula bit for bit, as the JAX package's own test
holds its backward.  ``half_residuals``: the loss 1e-6; the grads are
the bf16 softmax upcast, so one bf16 ulp at softmax scale (2^-8, the
two sides' exp may round across a bf16 boundary).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.contrib.xentropy import SoftmaxCrossEntropyLoss as JShim
from apex_tpu.ops import xentropy as jx
from apex_tpu.transformer import parallel_state
from apex_tpu.transformer.tensor_parallel.cross_entropy import (
    vocab_parallel_cross_entropy as jvpce)
from apex_tpu_torch.contrib import SoftmaxCrossEntropyLoss
from apex_tpu_torch.ops import (softmax_cross_entropy_loss,
                                xentropy_reference)
from apex_tpu_torch.transformer.tensor_parallel import (
    vocab_parallel_cross_entropy)

from _torch_isolation import restore_torch_from_amp  # noqa: F401

TOL = 1e-6


def _inputs(n, v, seed, pad_every=0, scale=2.0):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(n, v) * scale).astype(np.float32)
    labels = rng.randint(0, v, size=n).astype(np.int32)
    if pad_every:
        labels[::pad_every] = -100
    dloss = rng.randn(n).astype(np.float32)
    return logits, labels, dloss


def _torch_vjp(fn, logits, labels, dloss):
    x = torch.from_numpy(logits).requires_grad_()
    loss = fn(x, torch.from_numpy(labels))
    loss.backward(torch.from_numpy(dloss))
    return loss.detach().numpy(), x.grad.numpy()


def _jax_vjp(fn, logits, labels, dloss):
    loss, vjp = jax.vjp(lambda x: fn(x, jnp.asarray(labels)),
                        jnp.asarray(logits))
    return np.asarray(loss), np.asarray(vjp(jnp.asarray(dloss))[0])


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_loss_and_grad_match_jax(smoothing):
    logits, labels, dloss = _inputs(48, 512, 1, pad_every=6)
    got = _torch_vjp(lambda x, y: softmax_cross_entropy_loss(
        x, y, smoothing=smoothing), logits, labels, dloss)
    want = _jax_vjp(lambda x, y: jx.softmax_cross_entropy_loss(
        x, y, smoothing=smoothing), logits, labels, dloss)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=TOL)
    assert np.all(got[0][::6] == 0.0) and np.all(got[1][::6] == 0.0)
    assert np.any(got[1][1::6] != 0.0)


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_reference_matches_jax(smoothing):
    logits, labels, _ = _inputs(32, 256, 2)
    got = xentropy_reference(torch.from_numpy(logits),
                             torch.from_numpy(labels), smoothing)
    want = jx.xentropy_reference(jnp.asarray(logits), jnp.asarray(labels),
                                 smoothing)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(
        softmax_cross_entropy_loss(torch.from_numpy(logits),
                                   torch.from_numpy(labels),
                                   smoothing).numpy(),
        got.numpy(), rtol=0, atol=TOL)


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_scatter_backward_is_the_onehot_backward_bitwise(smoothing):
    logits, labels, dloss = _inputs(48, 512, 10, pad_every=6)
    _, got = _torch_vjp(lambda x, y: softmax_cross_entropy_loss(
        x, y, smoothing=smoothing), logits, labels, dloss)
    x = torch.from_numpy(logits)
    lab = torch.from_numpy(labels).long()
    pad = lab == -100
    safe = torch.where(pad, 0, lab)
    p = torch.exp(x - torch.logsumexp(x, dim=-1)[:, None])
    onehot = torch.nn.functional.one_hot(safe, x.shape[1]).float()
    ref = p - (1.0 - smoothing) * onehot - smoothing / x.shape[1]
    ref = ref * torch.where(pad, 0.0, torch.from_numpy(dloss))[:, None]
    np.testing.assert_array_equal(got, ref.numpy())


def test_contrib_shim_gives_the_same_result():
    logits, labels, dloss = _inputs(16, 128, 6, pad_every=5)
    args = (0.1, -100, True)
    got = _torch_vjp(lambda x, y: SoftmaxCrossEntropyLoss.apply(x, y, *args),
                     logits, labels, dloss)
    direct = _torch_vjp(lambda x, y: softmax_cross_entropy_loss(x, y, *args),
                        logits, labels, dloss)
    want = _jax_vjp(lambda x, y: JShim.apply(x, y, *args), logits, labels,
                    dloss)
    for g, d, w in zip(got, direct, want):
        np.testing.assert_array_equal(g, d)
        np.testing.assert_allclose(g, w, rtol=0, atol=TOL)


def test_batched_shape_and_bf16_logits():
    rng = np.random.RandomState(8)
    logits = (rng.randn(4, 8, 64) * 2).astype(np.float32)
    labels = rng.randint(0, 64, size=(4, 8))
    x = torch.from_numpy(logits).bfloat16().requires_grad_()
    loss = softmax_cross_entropy_loss(x, torch.from_numpy(labels))
    assert loss.shape == (4, 8) and loss.dtype == torch.float32
    loss.sum().backward()
    assert x.grad.dtype == torch.bfloat16 and x.grad.shape == x.shape
    want = jx.softmax_cross_entropy_loss(
        jnp.asarray(logits).astype(jnp.bfloat16), jnp.asarray(labels))
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(want),
                               rtol=0, atol=TOL)


@pytest.fixture
def _tp1():
    parallel_state.destroy_model_parallel()
    parallel_state.initialize_model_parallel(1)
    yield
    parallel_state.destroy_model_parallel()


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_half_residuals_match_jax(_tp1, smoothing):
    """``[s, b, V]`` fp32 logits, as the models give them."""
    logits, labels, dloss = _inputs(2 * 24, 128, 3)
    logits, labels, dloss = (a.reshape(24, 2, *a.shape[1:])
                             for a in (logits, labels, dloss))
    got = _torch_vjp(lambda x, y: vocab_parallel_cross_entropy(
        x, y, smoothing, half_residuals=True), logits, labels, dloss)
    want = _jax_vjp(lambda x, y: jvpce(x, y, smoothing,
                                       half_residuals=True),
                    logits, labels, dloss)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=TOL)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=2.0 ** -8)
    # and against the fp32 path: the softmax's bf16 rounding only
    full = _torch_vjp(lambda x, y: vocab_parallel_cross_entropy(
        x, y, smoothing), logits, labels, dloss)
    np.testing.assert_allclose(got[0], full[0], rtol=0, atol=TOL)
    np.testing.assert_allclose(got[1], full[1], rtol=0, atol=2.0 ** -8)


def test_half_residuals_save_the_softmax_in_bf16():
    logits, labels, _ = _inputs(16, 64, 4)
    saved = []

    def pack(t):
        saved.append((tuple(t.shape), t.dtype))
        return t

    x = torch.from_numpy(logits).requires_grad_()
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        vocab_parallel_cross_entropy(x, torch.from_numpy(labels),
                                     half_residuals=True)
    assert ((16, 64), torch.bfloat16) in saved
    assert not [s for s in saved if s == ((16, 64), torch.float32)]


def test_half_residuals_raise_only_at_tp_above_1():
    """At tp > 1 the sharded loss runs over its process group
    (tests/test_torch_tp_training.py); without a topology it raises,
    naming initialize_model_parallel."""
    logits, labels, _ = _inputs(4, 16, 5)
    with pytest.raises(RuntimeError, match="initialize_model_parallel"):
        vocab_parallel_cross_entropy(torch.from_numpy(logits),
                                     torch.from_numpy(labels),
                                     half_residuals=True,
                                     tensor_model_parallel_size=2)
