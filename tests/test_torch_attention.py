"""Port parity: ``apex_tpu_torch.ops.attention`` against
``apex_tpu.ops.attention`` on the same numpy inputs (fp32, CPU).

The JAX flash forward runs its Pallas kernel in interpret mode (non-TPU
backends always take the kernel); the port's CPU path is the plain
version of its CUDA kernel.  Both outputs AND the base-2 log-sum-exp
that ``_fwd`` returns are held together: the backward and the ring
merge of later slices consume lse in base 2.  Tolerance 2e-5 absolute:
fp32 on both sides, the JAX kernel's blockwise online softmax against a
one-pass softmax.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import attention as jattn
from apex_tpu_torch.ops import attention as tattn

from _torch_isolation import restore_torch_from_amp  # noqa: F401

_ATOL = 2e-5


def _qkv(b, h, sq, sk, d, kvh=None, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, h, sq, d).astype(np.float32)
    k = rng.randn(b, kvh or h, sk, d).astype(np.float32)
    v = rng.randn(b, kvh or h, sk, d).astype(np.float32)
    return q, k, v


def _t(*arrs):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]


@pytest.mark.parametrize("sq,sk", [(40, 40), (40, 72), (48, 32)])
def test_flash_attention_causal_matches_jax(sq, sk):
    """sq < sk exercises the causal offset sk - sq; sq > sk leaves the
    first rows with no visible key (they must emit zeros)."""
    q, k, v = _qkv(2, 3, sq, sk, 32, seed=sq + sk)
    ref = np.asarray(jattn.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True))
    got = tattn.flash_attention(*_t(q, k, v), causal=True).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=_ATOL)
    if sq > sk:
        assert np.all(got[:, :, :sq - sk] == 0)


@pytest.mark.parametrize("causal", [True, False])
def test_fwd_padded_window_out_and_base2_lse_match_jax(causal):
    """A padded bucket: 100 real rows/columns inside a 128-long buffer
    masked by the validity window; out and base-2 lse of every row
    (padded rows included: 0 and -1e30) match the JAX ``_fwd``."""
    bh, s, real, d = 3, 128, 100, 32
    q, k, v = (a.reshape(bh, s, d) for a in _qkv(1, bh, s, s, d, seed=7))
    scale = d ** -0.5
    j_out, j_lse = jattn._fwd(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), None, causal, scale, 64, 64,
                              causal_off=0, valid=(real, real))
    t_out, t_lse = tattn._fwd(*_t(q, k, v), causal, scale, causal_off=0,
                              valid=(real, real))
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out),
                               rtol=1e-5, atol=_ATOL)
    np.testing.assert_allclose(t_lse.numpy()[:, :real],
                               np.asarray(j_lse)[:, :real], rtol=1e-6,
                               atol=_ATOL)
    assert np.all(t_lse.numpy()[:, real:] == np.asarray(j_lse)[:, real:])


def test_fwd_lse_is_base_two():
    """lse = log2(sum exp(scale * s)) — natural-log lse would be off by
    the factor log2(e)."""
    q, k, v = (a.reshape(2, 16, 8) for a in _qkv(1, 2, 16, 16, 8, seed=3))
    scale = 8 ** -0.5
    _, lse = tattn._fwd(*_t(q, k, v), False, scale)
    s = np.einsum("bqd,bkd->bqk", q, k) * scale
    want = np.log2(np.exp(s).sum(-1))
    np.testing.assert_allclose(lse.numpy(), want, rtol=1e-5, atol=1e-5)


def test_prefix_window_attention_matches_jax():
    """Warm prefill: GQA group 2, a 64-column cached window of which the
    first 20 are live (the rest is garbage that must stay masked)."""
    rng = np.random.RandomState(11)
    q = rng.randn(1, 4, 16, 32).astype(np.float32)
    k = rng.randn(1, 2, 16, 32).astype(np.float32)
    v = rng.randn(1, 2, 16, 32).astype(np.float32)
    wk = rng.randn(1, 2, 64, 32).astype(np.float32)
    wv = rng.randn(1, 2, 64, 32).astype(np.float32)
    ref = np.asarray(jattn.prefix_window_attention(
        *(jnp.asarray(a) for a in (q, k, v, wk, wv)), 20))
    got = tattn.prefix_window_attention(*_t(q, k, v, wk, wv), 20).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=_ATOL)


def test_mha_reference_with_mask_matches_jax():
    q, k, v = _qkv(2, 2, 24, 24, 16, seed=5)
    mask = np.random.RandomState(6).rand(2, 1, 24, 24) > 0.7
    ref = np.asarray(jattn.mha_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        mask=jnp.asarray(mask)))
    got = tattn.mha_reference(*_t(q, k, v), causal=True,
                              mask=torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=_ATOL)
    # the public entry takes the mask on the CPU through the masked
    # kernel's plain version (the JAX entry's mask3)
    pub = tattn.flash_attention(*_t(q, k, v), causal=True,
                                mask=torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(pub, ref, rtol=1e-5, atol=_ATOL)


def test_dropout_raises_not_implemented_naming_its_roadmap_item():
    """(Named for the raise this call met before dropout was ported.)
    The same call now drops attention probabilities: it equals the JAX
    oracle ``mha_reference`` with the same rate and seed (the keep mask
    is the same bits)."""
    q, k, v = _qkv(1, 1, 8, 8, 8)
    got = tattn.flash_attention(*_t(q, k, v), dropout_rate=0.1,
                                dropout_seed=1).numpy()
    ref = np.asarray(jattn.mha_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), dropout_rate=0.1,
        dropout_seed=1))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=_ATOL)


@pytest.mark.parametrize("case", ["rate 1", "rate below 0", "no seed",
                                  "2-D mask", "mask with sk + 1 columns"])
def test_flash_attention_argument_checks_match_jax(case):
    """The JAX entry's ValueError checks, in its order: both entries
    raise ValueError on the same inputs."""
    q, k, v = _qkv(1, 2, 8, 8, 8, seed=13)
    kw = {"rate 1": dict(dropout_rate=1.0, dropout_seed=1),
          "rate below 0": dict(dropout_rate=-0.1, dropout_seed=1),
          "no seed": dict(dropout_rate=0.1),
          "2-D mask": dict(mask=np.zeros((8, 8), bool)),
          "mask with sk + 1 columns": dict(
              mask=np.zeros((1, 1, 8, 9), bool))}[case]
    jkw = {n: jnp.asarray(x) if n == "mask" else x for n, x in kw.items()}
    tkw = {n: torch.from_numpy(x) if n == "mask" else x
           for n, x in kw.items()}
    with pytest.raises(ValueError):
        jattn.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              **jkw)
    with pytest.raises(ValueError):
        tattn.flash_attention(*_t(q, k, v), **tkw)


# -- fp32 outputs on bf16 operands (ring attention's partials) ------------
#
# JAX's ``_fwd`` and ``_bwd_impl`` take ``out_dtype=jnp.float32``; the
# port's ``_fwd`` and ``_bwd`` take ``out_dtype=torch.float32``, whose
# plain versions (the CPU route) return fp32 without rounding through
# bf16.  Held on the same bf16 operands (one block a pair on the JAX
# side, as the ring's shards tile), with dropout at the ring's second
# step's offsets, within 2^-10 of each output's largest magnitude: fp32
# on both sides, p and dS rounded to bf16 for their products on both (a
# rounding an fp32 ulp flips moves an element by ~2^-9 of one product
# term); an output rounded to bf16 is off by up to 2^-9 of each element.

_F32_CASES = [(True, 0.0, (0, 0)), (False, 0.0, (0, 0)),
              (True, 0.1, (0, 0)), (False, 0.1, (64, 0))]


def _bf16_case(bh, s, d, seed):
    rng = np.random.RandomState(seed)
    arrs = [rng.randn(bh, s, d).astype(np.float32) for _ in range(4)]
    j = [jnp.asarray(a).astype(jnp.bfloat16) for a in arrs]
    t = [torch.from_numpy(a).to(torch.bfloat16) for a in arrs]
    return j, t


def _close_f32(got, want, tol=2.0 ** -10):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


@pytest.mark.parametrize("causal,rate,offs", _F32_CASES)
def test_fwd_out_dtype_f32_matches_jax(causal, rate, offs):
    bh, s, d = 3, 64, 32
    (jq, jk, jv, _), (tq, tk, tv, _) = _bf16_case(bh, s, d, 11)
    scale = d ** -0.5
    j_out, j_lse = jattn._fwd(
        jq, jk, jv, None, causal, scale, s, s, out_dtype=jnp.float32,
        rate=rate, seed3=jattn._seed_operand(99, *offs) if rate else None)
    t_out, t_lse = tattn._fwd(
        tq, tk, tv, causal, scale, rate=rate,
        seed3=tattn._seed_operand(99, *offs) if rate else None,
        out_dtype=torch.float32)
    assert t_out.dtype == torch.float32 and j_out.dtype == jnp.float32
    _close_f32(t_out, j_out)
    np.testing.assert_allclose(t_lse.numpy(), np.asarray(j_lse),
                               rtol=1e-5, atol=1e-4)
    # not bf16 values: nothing rounded the output
    assert not torch.equal(t_out, t_out.to(torch.bfloat16).float())
    # the default stays q's type
    assert tattn._fwd(tq, tk, tv, causal, scale)[0].dtype == torch.bfloat16


@pytest.mark.parametrize("causal,rate,offs", _F32_CASES)
@pytest.mark.parametrize("split", [False, True])
def test_bwd_out_dtype_f32_matches_jax(causal, rate, offs, split,
                                       monkeypatch):
    """Both JAX backward routes (one-pass, and the split pair past the
    gate) with fp32 dq, dk and dv from the global bf16 out and lse."""
    bh, s, d = 3, 64, 32
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _bf16_case(bh, s, d, 12)
    scale = d ** -0.5
    jseed = jattn._seed_operand(5, *offs) if rate else None
    tseed = tattn._seed_operand(5, *offs) if rate else None
    j_out, j_lse = jattn._fwd(jq, jk, jv, None, causal, scale, s, s,
                              rate=rate, seed3=jseed)
    t_out, t_lse = tattn._fwd(tq, tk, tv, causal, scale, rate=rate,
                              seed3=tseed)
    if split:
        monkeypatch.setattr(jattn, "_FUSED_BWD_MAX_BYTES", 0)
        monkeypatch.setattr(tattn, "_FUSED_BWD_MAX_BYTES", 0)
    want = jattn._bwd_impl(jq, jk, jv, None, j_out, j_lse, jdo,
                           causal, scale, s, s, out_dtype=jnp.float32,
                           rate=rate, seed3=jseed)
    got = tattn._bwd(tq, tk, tv, t_out, t_lse, tdo, causal, scale,
                     rate=rate, seed3=tseed, out_dtype=torch.float32)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and w.dtype == jnp.float32
        _close_f32(g, w)
