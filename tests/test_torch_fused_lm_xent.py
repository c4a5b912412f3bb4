"""The port's chunked fused LM head + cross entropy
(``ops/fused_lm_xent.py``) against the JAX op on the same seeded numpy
inputs (CPU), mirroring the JAX package's own suite: fp32 loss and
grads over token counts the chunk does and does not divide (and one
under it) with smoothing 0 and 0.1, the vocab-chunked online logsumexp,
bf16, padding rows, chunk 0 as the unfused path, leading dims, the
tp = 1 vocab-parallel call; and that the fused op saves no tensor of
tokens x vocab elements while the unfused path does.

Tolerances, the JAX suite's: fp32 ``TOL_F32`` 5e-6 on the grads and
``TOL_F32 * n`` on the summed loss (reduction order only); the
vocab-chunked path 2e-4; bf16 the loss within 1e-3 relative and the
grads 1.6e-2 absolute (values of order 1: a bf16 ulp there is 2^-8).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import fused_lm_xent as jfx
from apex_tpu.transformer import parallel_state
from apex_tpu_torch.ops import fused_lm_xent as tfx

from _torch_isolation import restore_torch_from_amp  # noqa: F401

TOL = 2e-4
TOL_F32 = 5e-6


@pytest.fixture(autouse=True)
def _tp1():
    parallel_state.destroy_model_parallel()
    parallel_state.initialize_model_parallel(1)
    yield
    parallel_state.destroy_model_parallel()


def _fixture(n, h, v, pad_every=0, seed=0):
    rng = np.random.RandomState(seed)
    hid = rng.randn(n, h).astype(np.float32)
    w = (rng.randn(v, h) * 0.3).astype(np.float32)
    lab = rng.randint(0, v, size=n).astype(np.int32)
    if pad_every:
        lab[::pad_every] = -100
    return hid, w, lab


def _torch(fn, hid, w, lab, dtype=torch.float32):
    h = torch.from_numpy(hid).to(dtype).requires_grad_()
    wt = torch.from_numpy(w).to(dtype).requires_grad_()
    loss = fn(h, wt, torch.from_numpy(lab)).sum()
    loss.backward()
    return (loss.item(), h.grad.float().numpy(), wt.grad.float().numpy())


def _jax(fn, hid, w, lab, dtype=jnp.float32):
    loss, (gh, gw) = jax.value_and_grad(
        lambda h, w: fn(h, w, jnp.asarray(lab)).sum(), argnums=(0, 1))(
            jnp.asarray(hid).astype(dtype), jnp.asarray(w).astype(dtype))
    return (float(loss), np.asarray(gh.astype(jnp.float32)),
            np.asarray(gw.astype(jnp.float32)))


def _close(got, want, loss_atol, atol, loss_rtol=0.0):
    np.testing.assert_allclose(got[0], want[0], rtol=loss_rtol,
                               atol=loss_atol)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=atol)
    np.testing.assert_allclose(got[2], want[2], rtol=0, atol=atol)


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("n,chunk", [(64, 16), (37, 8), (5, 8)])
def test_fp32_loss_and_grads_match_jax(smoothing, n, chunk):
    # 37 % 8 != 0: the internal pad; 5 < 8: the chunk clamps to n
    args = _fixture(n, 16, 96, pad_every=5)
    got = _torch(lambda h, w, y: tfx.fused_lm_head_cross_entropy(
        h, w, y, smoothing=smoothing, token_chunk=chunk), *args)
    want = _jax(lambda h, w, y: jfx.fused_lm_head_cross_entropy(
        h, w, y, smoothing=smoothing, token_chunk=chunk), *args)
    _close(got, want, TOL_F32 * n, TOL_F32)
    ref = _torch(lambda h, w, y: tfx.lm_head_xentropy_reference(
        h, w, y, smoothing=smoothing), *args)
    _close(got, ref, TOL_F32 * n, TOL_F32)


@pytest.mark.parametrize("vocab_chunk", [32, 48])
def test_vocab_chunked_inner_loop_matches_jax(vocab_chunk):
    args = _fixture(40, 16, 96, pad_every=7)
    got = _torch(lambda h, w, y: tfx.fused_lm_head_cross_entropy(
        h, w, y, smoothing=0.1, token_chunk=8, vocab_chunk=vocab_chunk),
        *args)
    want = _jax(lambda h, w, y: jfx.fused_lm_head_cross_entropy(
        h, w, y, smoothing=0.1, token_chunk=8, vocab_chunk=vocab_chunk),
        *args)
    _close(got, want, TOL, TOL)


def test_vocab_chunk_must_divide():
    hid, w, lab = (torch.from_numpy(a) for a in _fixture(16, 8, 96))
    with pytest.raises(ValueError, match="divide"):
        tfx.fused_lm_head_cross_entropy(hid, w, lab, token_chunk=8,
                                        vocab_chunk=7)


def test_bf16_within_ulp_scale():
    args = _fixture(64, 32, 128, seed=1)
    got = _torch(lambda h, w, y: tfx.fused_lm_head_cross_entropy(
        h, w, y, smoothing=0.1, token_chunk=16), *args, torch.bfloat16)
    want = _jax(lambda h, w, y: jfx.fused_lm_head_cross_entropy(
        h, w, y, smoothing=0.1, token_chunk=16), *args, jnp.bfloat16)
    _close(got, want, 0.0, 1.6e-2, loss_rtol=1e-3)
    ref = _torch(lambda h, w, y: tfx.lm_head_xentropy_reference(
        h, w, y, smoothing=0.1), *args, torch.bfloat16)
    _close(got, ref, 0.0, 1.6e-2, loss_rtol=1e-3)


def test_padding_rows_give_zero_loss_and_grad():
    hid, w, lab = _fixture(32, 16, 64, pad_every=4)
    h = torch.from_numpy(hid).requires_grad_()
    loss = tfx.fused_lm_head_cross_entropy(h, torch.from_numpy(w),
                                           torch.from_numpy(lab),
                                           token_chunk=8)
    assert torch.all(loss[::4] == 0.0)
    loss.sum().backward()
    assert torch.all(h.grad[::4] == 0.0)
    assert torch.any(h.grad[1::4] != 0.0)


def test_chunk_zero_is_the_unfused_path_bitwise(monkeypatch):
    hid, w, lab = (torch.from_numpy(a) for a in _fixture(24, 16, 64))
    ref = tfx.lm_head_xentropy_reference(hid, w, lab)
    out = tfx.fused_lm_head_cross_entropy(hid, w, lab, token_chunk=0)
    assert torch.equal(out, ref)
    monkeypatch.delenv("APEX_TPU_XENT_CHUNK", raising=False)
    assert torch.equal(tfx.fused_lm_head_cross_entropy(hid, w, lab), ref)
    np.testing.assert_allclose(
        out.numpy(), np.asarray(jfx.lm_head_xentropy_reference(
            *(jnp.asarray(t.numpy()) for t in (hid, w, lab)))),
        rtol=0, atol=TOL_F32)


def test_env_sets_the_chunks(monkeypatch):
    monkeypatch.setenv("APEX_TPU_XENT_CHUNK", "8")
    monkeypatch.setenv("APEX_TPU_XENT_VOCAB_CHUNK", "32")
    assert tfx.xent_chunk_default() == jfx.xent_chunk_default() == 8
    assert tfx.xent_vocab_chunk_default() == jfx.xent_vocab_chunk_default() \
        == 32
    args = _fixture(24, 16, 96, seed=2)
    got = _torch(lambda h, w, y: tfx.fused_lm_head_cross_entropy(h, w, y),
                 *args)
    want = _torch(lambda h, w, y: tfx.fused_lm_head_cross_entropy(
        h, w, y, token_chunk=8, vocab_chunk=32), *args)
    assert got[0] == want[0]
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g, w)


def test_leading_dims_flatten():
    hid, w, lab = (torch.from_numpy(a) for a in _fixture(24, 16, 64))
    out2 = tfx.fused_lm_head_cross_entropy(
        hid.reshape(4, 6, 16), w, lab.reshape(4, 6), token_chunk=8)
    out1 = tfx.fused_lm_head_cross_entropy(hid, w, lab, token_chunk=8)
    assert out2.shape == (4, 6)
    assert torch.equal(out2.reshape(-1), out1)


def test_vocab_parallel_at_tp1_is_the_local_op():
    args = _fixture(24, 16, 64, seed=3)
    got = _torch(lambda h, w, y:
                 tfx.fused_lm_head_vocab_parallel_cross_entropy(
                     h, w, y, token_chunk=8), *args)
    local = _torch(lambda h, w, y: tfx.fused_lm_head_cross_entropy(
        h, w, y, token_chunk=8, vocab_chunk=0), *args)
    assert got[0] == local[0]
    for g, w in zip(got[1:], local[1:]):
        np.testing.assert_array_equal(g, w)
    want = _jax(lambda h, w, y:
                jfx.fused_lm_head_vocab_parallel_cross_entropy(
                    h, w, y, token_chunk=8), *args)
    _close(got, want, TOL_F32 * 24, TOL_F32)
    hid, w, lab = (torch.from_numpy(a) for a in args)
    # tp > 1 runs over its process group (tests/test_torch_tp_training.py);
    # without a topology it raises rather than compute one rank's shard
    with pytest.raises(RuntimeError, match="initialize_model_parallel"):
        tfx.fused_lm_head_vocab_parallel_cross_entropy(
            hid, w, lab, token_chunk=8, tensor_model_parallel_size=2)


def _saved_numels(fn, n, v, **kw):
    hid, w, lab = _fixture(n, 16, v, seed=4)
    h = torch.from_numpy(hid).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    numels = []

    def pack(t):
        numels.append(t.numel())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss = fn(h, wt, torch.from_numpy(lab), **kw).sum()
    loss.backward()
    return numels


def test_fused_op_saves_no_full_logits_residual():
    n, v = 64, 96
    fused = _saved_numels(tfx.fused_lm_head_cross_entropy, n, v,
                          token_chunk=16)
    assert fused and max(fused) < n * v
    unfused = _saved_numels(tfx.lm_head_xentropy_reference, n, v)
    assert n * v in unfused
