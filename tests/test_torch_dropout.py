"""Port parity for attention dropout and the masked backward:
``apex_tpu_torch.ops.attention`` against ``apex_tpu.ops.attention`` on
the same numpy inputs (CPU, fp32; the JAX kernels in Pallas interpret
mode, its XLA route as XLA).

The keep mask (``_keep_mask``, the murmur3 finalizer over the global
``(batch*head, row, col)``) is held bit for bit over seeds at the int32
edges, batch-heads past 2^16 and offsets, at rates 0.1 and 0.5.
``flash_attention``'s forward and ``(dq, dk, dv)`` (``jax.vjp`` of the
JAX entry against ``backward`` of the port's) are held at 1e-5 absolute
(``_ATOL``: fp32 on both sides, the JAX kernels' blockwise online
softmax against one pass; the same keep mask on both sides, so dropout
adds no difference): causal and not, masks per batch, per head and
shared with a fully masked row, rate 0 against no dropout, the
``use_kernel=False`` route against the JAX XLA route, and both backward
routes (the one-pass kernel's plain version and the split pair's,
forced on both sides by ``_FUSED_BWD_MAX_BYTES``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import attention as jattn
from apex_tpu_torch.ops import _build
from apex_tpu_torch.ops import attention as tattn

from _torch_isolation import restore_torch_from_amp  # noqa: F401

_ATOL = 1e-5


@pytest.mark.parametrize("rate", [0.1, 0.5])
@pytest.mark.parametrize("seed", [0, 1, -1, 2 ** 31 - 1, -2 ** 31,
                                  -2 ** 31 + 1, 987654321])
def test_keep_mask_is_jax_bit_for_bit(seed, rate):
    for bi in (0, 1, 255, 2 ** 16 - 1, 2 ** 16, 2 ** 16 + 3):
        for row_off, col_off in ((0, 0), (7, 130), (2 ** 31 - 8, -5)):
            j = np.asarray(jattn._keep_mask(
                jnp.int32(seed), bi, 1, 2, 16, 24, rate, jnp.int32(row_off),
                jnp.int32(col_off)))
            t = tattn._keep_mask(seed, bi, 1, 2, 16, 24, rate, row_off,
                                 col_off).numpy()
            assert t.dtype == np.bool_ and t.shape == (16, 24)
            np.testing.assert_array_equal(t, j)


def _folded_keep(seed, bh, rows, cols, rate, row_off, col_off):
    """The forward kernel's keep bits as a uint32 model: the row's and the
    column's parts each folded through the finalizer's first xor-shift
    (it distributes over their xor), the rest of the finalizer over their
    xor, and the top 24 bits compared as ``h >= threshold << 8`` (a
    threshold of 2^24 keeps nothing)."""
    u = np.uint32
    fold = (lambda x: x ^ (x >> u(16)))
    rows = (u(row_off & 0xFFFFFFFF) + rows.astype(u)) * u(tattn._H2)
    cols = (u(col_off & 0xFFFFFFFF) + cols.astype(u)) * u(tattn._H3)
    row_part = fold(u(seed & 0xFFFFFFFF) ^ (u(bh) * u(tattn._H1)) ^ rows)
    h = row_part[:, None] ^ fold(cols)[None, :]
    h = h * u(tattn._H2)
    h = h ^ (h >> u(13))
    h = h * u(tattn._H3)
    h = h ^ (h >> u(16))
    threshold = tattn._drop_threshold(rate)
    if threshold >= 1 << 24:
        return np.zeros(h.shape, dtype=bool)
    return h >= u(threshold << 8)


@pytest.mark.parametrize("rate", [0.1, 0.5, 2.0 ** -24, 3 * 2.0 ** -24,
                                  (2 ** 23 + 1) * 2.0 ** -24,
                                  (2 ** 24 - 1) * 2.0 ** -24])
def test_folded_keep_bits_are_jax_bit_for_bit(rate):
    """The forward kernel's arithmetic for the keep bits (``fold16`` on the
    row's and the column's parts, ``h >= threshold << 8``) gives JAX's
    ``_keep_mask`` bit for bit: random int32 seeds (negative ones among
    them), batch-heads, query and key blocks and offsets."""
    rng = np.random.RandomState(int(rate * 2 ** 24) % 2 ** 31)
    seeds = [0, -1, -2 ** 31, 2 ** 31 - 1] + rng.randint(
        -2 ** 31, 2 ** 31, size=4).tolist()
    with np.errstate(over="ignore"):
        for seed in seeds:
            bi = int(rng.randint(0, 2 ** 20))
            qi, ki = (int(x) for x in rng.randint(0, 64, size=2))
            row_off, col_off = (int(x) for x in rng.randint(
                -2 ** 31, 2 ** 31, size=2))
            bq, bk = 24, 40
            j = np.asarray(jattn._keep_mask(
                jnp.int32(seed), bi, qi, ki, bq, bk, rate,
                jnp.int32(row_off), jnp.int32(col_off)))
            got = _folded_keep(seed, bi, qi * bq + np.arange(bq),
                               ki * bk + np.arange(bk), rate, row_off,
                               col_off)
            np.testing.assert_array_equal(got, j)


def test_keep_mask_of_many_batch_heads_and_its_rate():
    """``bi`` as ``[n, 1, 1]`` gives each batch-head's own mask (the
    plain versions' draw), and the kept share is 1 - rate within 3
    sigma."""
    bi = torch.arange(70000, 70000 + 8)[:, None, None]
    t = tattn._keep_mask(-7, bi, 0, 0, 64, 96, 0.1).numpy()
    for i in range(8):
        j = np.asarray(jattn._keep_mask(jnp.int32(-7), 70000 + i, 0, 0, 64,
                                        96, 0.1))
        np.testing.assert_array_equal(t[i], j)
    n = t.size
    assert abs(t.mean() - 0.9) <= 3 * np.sqrt(0.09 / n)


def test_dropout_reference_and_mha_reference_match_jax():
    rng = np.random.RandomState(0)
    p = rng.rand(2, 3, 16, 20).astype(np.float32)
    np.testing.assert_array_equal(
        tattn._dropout_reference(torch.from_numpy(p), rate=0.2,
                                 seed=-99).numpy(),
        np.asarray(jattn._dropout_reference(jnp.asarray(p), rate=0.2,
                                            seed=-99)))
    q, k, v = (rng.randn(2, 2, 24, 16).astype(np.float32) for _ in range(3))
    ref = np.asarray(jattn.mha_reference(
        *(jnp.asarray(a) for a in (q, k, v)), causal=True, dropout_rate=0.3,
        dropout_seed=5))
    got = tattn.mha_reference(*(torch.from_numpy(a) for a in (q, k, v)),
                              causal=True, dropout_rate=0.3,
                              dropout_seed=5).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=_ATOL)


def test_seed_operand():
    np.testing.assert_array_equal(
        tattn._seed_operand(-5, 3, 4).numpy(),
        np.asarray(jattn._seed_operand(-5, 3, 4)))
    s = tattn._seed_operand(torch.tensor([2 ** 31 - 1], dtype=torch.int32))
    assert s.dtype == torch.int32 and s.tolist() == [2 ** 31 - 1, 0, 0]


def _mask(kind, b, h, sq, sk, seed):
    if kind is None:
        return None
    shape = {"per-batch": (b, 1, sq, sk), "per-head": (b, h, sq, sk),
             "one": (1, 1, sq, sk), "key-only": (b, 1, 1, sk)}[kind]
    m = np.random.RandomState(seed).rand(*shape) > 0.65
    if shape[2] > 1:
        m[..., 3, :] = True                 # a fully masked row
    else:
        m[-1] = True                        # every key of the last batch
    return m


def _both(q, k, v, do, *, causal, mask, rate, seed, use_kernel=None,
          split=False, monkeypatch=None):
    """(JAX out, JAX grads), (port out, port grads) of one call."""
    if split:
        monkeypatch.setattr(jattn, "_FUSED_BWD_MAX_BYTES", 0)
        monkeypatch.setattr(tattn, "_FUSED_BWD_MAX_BYTES", 0)
    kw = dict(causal=causal, dropout_rate=rate,
              dropout_seed=seed if rate else None, use_kernel=use_kernel)
    jm = None if mask is None else jnp.asarray(mask)
    out, vjp = jax.vjp(lambda a, b_, c: jattn.flash_attention(
        a, b_, c, mask=jm, **kw), *(jnp.asarray(x) for x in (q, k, v)))
    jgrads = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    tm = None if mask is None else torch.from_numpy(mask)
    tout = tattn.flash_attention(tq, tk, tv, mask=tm, **kw)
    tout.backward(torch.from_numpy(do))
    return ((np.asarray(out), [np.asarray(g) for g in jgrads]),
            (tout.detach().numpy(), [t.grad.numpy() for t in (tq, tk, tv)]))


def _assert_close(j, t):
    np.testing.assert_allclose(t[0], j[0], rtol=0, atol=_ATOL)
    for name, tg, jg in zip(("dq", "dk", "dv"), t[1], j[1]):
        np.testing.assert_allclose(tg, jg, rtol=0, atol=_ATOL,
                                   err_msg=name)


def _inputs(b, h, sq, sk, d, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, h, s, d).astype(np.float32)
            for s in (sq, sk, sk, sq)]


@pytest.mark.parametrize("kind", [None, "per-batch", "per-head", "one",
                                  "key-only"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("split", [False, True])
def test_flash_attention_mask_and_dropout_match_jax(kind, causal, split,
                                                    monkeypatch):
    b, h, sq, sk, d = 2, 3, 40, 48, 16
    q, k, v, do = _inputs(b, h, sq, sk, d, 1)
    mask = _mask(kind, b, h, sq, sk, 2)
    j, t = _both(q, k, v, do, causal=causal, mask=mask, rate=0.2,
                 seed=-12345, split=split, monkeypatch=monkeypatch)
    _assert_close(j, t)


@pytest.mark.parametrize("kind", ["per-batch", "per-head", "one"])
@pytest.mark.parametrize("split", [False, True])
def test_masked_backward_without_dropout_matches_jax(kind, split,
                                                     monkeypatch):
    """V1: the mask in the backward alone (the forward's mask3 carried
    into it), with a fully masked row giving zero grads there."""
    b, h, sq, sk, d = 2, 2, 36, 36, 16
    q, k, v, do = _inputs(b, h, sq, sk, d, 3)
    mask = _mask(kind, b, h, sq, sk, 4)
    j, t = _both(q, k, v, do, causal=False, mask=mask, rate=0.0, seed=None,
                 split=split, monkeypatch=monkeypatch)
    _assert_close(j, t)
    assert np.all(t[1][0][:, :, 3] == 0)        # dq of the masked row


@pytest.mark.parametrize("kind", [None, "per-batch"])
@pytest.mark.parametrize("causal", [True, False])
def test_xla_route_with_dropout_matches_jax(kind, causal):
    """``use_kernel=False``: the plain chain drops the same elements as
    the JAX XLA route, and autograd gives its grads."""
    b, h, sq, sk, d = 2, 2, 24, 24, 16
    q, k, v, do = _inputs(b, h, sq, sk, d, 5)
    mask = _mask(kind, b, h, sq, sk, 6)
    j, t = _both(q, k, v, do, causal=causal, mask=mask, rate=0.1,
                 seed=2 ** 31 - 1, use_kernel=False)
    _assert_close(j, t)
    # the two routes of the port agree as well (the same keep mask)
    _, tk = _both(q, k, v, do, causal=causal, mask=mask, rate=0.1,
                  seed=2 ** 31 - 1, use_kernel=True)
    _assert_close(t, tk)


def test_rate_zero_is_no_dropout():
    q, k, v, do = _inputs(1, 2, 32, 32, 16, 7)
    a = _both(q, k, v, do, causal=True, mask=None, rate=0.0, seed=None)[1]
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = tattn.flash_attention(tq, tk, tv, causal=True, dropout_rate=0.0,
                                dropout_seed=3)
    out.backward(torch.from_numpy(do))
    np.testing.assert_array_equal(out.detach().numpy(), a[0])
    for g, r in zip((tq.grad, tk.grad, tv.grad), a[1]):
        np.testing.assert_array_equal(g.numpy(), r)


def test_dropout_drops_what_the_seed_says_and_launches_nothing():
    """A different seed drops other elements; the kernel route on the
    CPU takes the plain versions and launches no kernel; the seed as a
    tensor gives the same result as the int."""
    q, k, v, do = _inputs(1, 2, 32, 32, 16, 8)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    _build.reset_launch_counts()
    a = tattn.flash_attention(tq, tk, tv, dropout_rate=0.3, dropout_seed=1)
    b = tattn.flash_attention(tq, tk, tv, dropout_rate=0.3, dropout_seed=2)
    c = tattn.flash_attention(tq, tk, tv, dropout_rate=0.3,
                              dropout_seed=torch.tensor(1,
                                                        dtype=torch.int32))
    assert not any(_build.launch_counts().values())
    assert not torch.equal(a, b)
    assert torch.equal(a, c)


@pytest.mark.parametrize("split", [False, True])
def test_plain_split_pair_carries_mask_and_dropout(split, monkeypatch):
    """``_bwd`` on the plain versions with ``mask3`` and the seed
    operand, both routes, against the JAX ``_bwd_impl`` on the same
    residuals (``bh0`` shifts the hashed batch-heads of a slice)."""
    bh, s, d = 4, 32, 16
    rng = np.random.RandomState(9)
    q, k, v, do = (rng.randn(bh, s, d).astype(np.float32) for _ in range(4))
    mask3 = rng.rand(2, s, s) > 0.7
    seed3 = tattn._seed_operand(41)
    if split:
        monkeypatch.setattr(jattn, "_FUSED_BWD_MAX_BYTES", 0)
        monkeypatch.setattr(tattn, "_FUSED_BWD_MAX_BYTES", 0)
    scale = d ** -0.5
    jo, jl = jattn._fwd(*(jnp.asarray(x) for x in (q, k, v)),
                        jnp.asarray(mask3), False, scale, s, s, rate=0.25,
                        seed3=jattn._seed_operand(41))
    jg = jattn._bwd_impl(*(jnp.asarray(x) for x in (q, k, v)),
                         jnp.asarray(mask3), jo, jl, jnp.asarray(do), False,
                         scale, s, s, rate=0.25,
                         seed3=jattn._seed_operand(41))
    t3 = [torch.from_numpy(x) for x in (q, k, v, do)]
    m3 = torch.from_numpy(mask3)
    to, tl = tattn._fwd(*t3[:3], False, scale, mask3=m3, rate=0.25,
                        seed3=seed3)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=_ATOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    tg = tattn._bwd(*t3[:3], to, tl, t3[3], False, scale, mask3=m3,
                    rate=0.25, seed3=seed3)
    for g, r in zip(tg, jg):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=_ATOL)
    # the second half of the batch-heads alone, as a slice of the call
    half = tattn._bwd_reference(*(x[2:] for x in t3[:3]), to[2:], tl[2:],
                                t3[3][2:], False, scale, mask3=m3[1:],
                                rate=0.25, seed3=seed3, bh0=2)
    for g, r in zip(half, tg):
        np.testing.assert_allclose(g.numpy(), r[2:].numpy(), atol=1e-6)
