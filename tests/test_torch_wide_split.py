"""The fp32 operands of the wide kernels' tensor-core route (#3w, #5w,
#6w), on the CPU: the split of an fp32 operand into three bf16 planes
(``attention._split_planes``, the plain version of the card's split
kernel), which operands the wrappers hand the C entries
(``_wide_tc_operands``; the dk/dv wrapper's and the backward pair's
hand-over with the library stubbed, nothing launched), the six-product
matmul (``_matmul6``), and a plain forward, dq and dk/dv that run each
product as six against the JAX package's fp32 ``_fwd`` and
``_bwd_impl`` (Pallas in interpret mode).

Tolerances: the planes' sum within 2^-24 |x| of x (each plane keeps 8
bits, rounded to nearest, so what three leave is at most 2^-24 |x| while
every plane is a normal number: the exponents drawn keep them so); the
six-product matmul within (k + 8) 2^-24 (|a| @ |b|) of the exact product
(the dropped terms and the planes' remainders are at most 4 2^-24 |a_i
b_i| a term, fp32 summation over k terms adds k 2^-24 of their
magnitudes) and within 2^-20 (|a| @ |b|) of torch's fp32 matmul; the
forward's out and lse within 2e-5 of their max|ref|, dq, dk and dv
within 1e-4 (the card tests' fp32 limits for the wide kernels).
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from apex_tpu_torch.ops import attention as tattn

jattn = importlib.import_module("apex_tpu.ops.attention")

_U = 2.0 ** -24


@settings(max_examples=200, deadline=None, database=None)
@given(st.lists(st.tuples(st.floats(1.0, 2.0, exclude_max=True),
                          st.integers(-60, 60), st.booleans()),
                min_size=1, max_size=21))
def test_planes_are_bf16_and_sum_to_x(elems):
    """Three bf16 planes whose sum recovers x within 2^-24 |x|, over
    mantissas and exponents 2^-60 .. 2^60 of either sign; the padding
    columns up to a multiple of 8 are 0."""
    x = torch.tensor([(-m if neg else m) * 2.0 ** e for m, e, neg in elems],
                     dtype=torch.float32)
    planes = tattn._split_planes(x[None])
    d = x.numel()
    assert planes.dtype == torch.bfloat16
    assert tuple(planes.shape) == (3, 1, d + (-d % 8))
    assert bool((planes[..., d:] == 0).all())
    total = planes[..., :d].double().sum(0)[0]
    err = (total - x.double()).abs()
    assert bool((err <= _U * x.double().abs()).all())
    # each plane is the bf16 rounding of what the ones before leave
    x0 = x.to(torch.bfloat16)
    assert torch.equal(planes[0, 0, :d], x0)
    assert torch.equal(planes[1, 0, :d], (x - x0.float()).to(torch.bfloat16))


@pytest.mark.parametrize("m,k,n", [(33, 70, 21), (96, 200, 96),
                                   (64, 48, 128)])
def test_six_product_matmul_matches_fp32(m, k, n):
    """``_matmul6`` against the exact product of its fp32 inputs and
    against torch's fp32 matmul."""
    rng = np.random.RandomState(m + k + n)
    a = torch.from_numpy(rng.randn(2, m, k).astype(np.float32))
    b = torch.from_numpy((rng.randn(2, k, n) * 3).astype(np.float32))
    exact = a.double() @ b.double()
    mag = a.double().abs() @ b.double().abs()
    got = tattn._matmul6(a, b).double()
    assert bool(((got - exact).abs() <= (k + 8) * _U * mag).all())
    assert bool(((got - (a @ b).double()).abs() <= 2.0 ** -20 * mag).all())
    # the transposed operand the forward's S product passes
    got_t = tattn._matmul6(a, b.transpose(1, 2).contiguous().transpose(1, 2))
    assert torch.equal(got_t, got.float())


class _FakeWideLibrary:
    """Stands in for the kernel library: records each wide backward
    entry's operand pointers and operand code, launches nothing."""

    def __init__(self):
        self.calls = []

    def _entry(kernel):
        def call(self, *args):
            self.calls.append((kernel, args[:4], args[-2]))
            return 0
        return call

    apex_flash_wide_dq = _entry("dq")
    apex_flash_wide_dkv = _entry("dkv")


def _fake_wide_launches(monkeypatch):
    """The wide backward's wrappers on CPU tensors with nothing launched:
    the library, the stream, the launch counter and the operands' device
    check stubbed; the split into planes its plain version, each call
    recorded as ``(operand, planes)``.  Returns ``(library, splits)``."""
    lib, splits = _FakeWideLibrary(), []
    split = tattn._split_kernel

    def spy(x3):
        planes = split(x3)
        splits.append((x3, planes))
        return planes

    monkeypatch.setattr(tattn, "_split_kernel", spy)
    monkeypatch.setattr(tattn._build, "library", lambda: lib)
    monkeypatch.setattr(tattn._build, "stream_ptr", lambda device: None)
    monkeypatch.setattr(tattn._build, "count", lambda kernel: None)
    # no mask, no dropout: the pointers, ints, 1 / (1 - rate) and code
    # _wide_operands returns once the operands are on a card
    monkeypatch.setattr(tattn, "_wide_operands", lambda kernel, q3, *a, **k: (
        (None, None), (1, 0), 1.0, tattn._WIDE_DTYPES[q3.dtype]))
    return lib, splits


@pytest.mark.parametrize("dtype,d,planes", [
    (torch.float32, 1, True), (torch.float32, 36, True),
    (torch.float32, 128, True), (torch.float32, 129, False),
    (torch.float32, 256, False), (torch.bfloat16, 200, False),
    (torch.float16, 37, False)])
def test_wide_operands_by_type_and_head_dim(monkeypatch, dtype, d, planes):
    """What the wide wrappers hand their C entries (``_wide_tc_operands``,
    the one place that picks the kernel): fp32 up to head dim 128 as its
    three bf16 planes (the tensor cores), fp32 past 128 and 16-bit
    operands as they are; the dk/dv wrapper (``_dkv_wide``) hands its
    entry the same."""
    rng = np.random.RandomState(d)
    ops = [torch.from_numpy(rng.randn(2, 5, d).astype(np.float32)).to(dtype)
           for _ in range(4)]
    code = tattn._WIDE_DTYPES[dtype]
    got, got_code = tattn._wide_tc_operands(code, ops)
    assert tattn._wide_on_tensor_cores(dtype, d) == (
        planes or dtype != torch.float32)
    if not planes:
        assert got_code == code and all(g is t for g, t in zip(got, ops))
    else:
        assert got_code == tattn._WIDE_F32_PLANES
        for g, t in zip(got, ops):
            assert torch.equal(g, tattn._split_planes(t))
    lib, splits = _fake_wide_launches(monkeypatch)
    stats = torch.zeros(2, 5)
    tattn._dkv_wide(ops[0], ops[1], ops[2], stats, stats, ops[3], True,
                    d ** -0.5)
    (kernel, ptrs, entry_code), = lib.calls
    assert kernel == "dkv" and entry_code == got_code
    assert [x for x, _ in splits] == (ops if planes else [])
    handed = [p for _, p in splits] if planes else ops
    assert ptrs == tuple(t.data_ptr() for t in handed)
    for t, g in zip(handed, got):
        assert torch.equal(t, g)


@pytest.mark.parametrize("dtype,d", [
    (torch.float32, 48), (torch.float32, 128), (torch.float32, 200),
    (torch.bfloat16, 200), (torch.float16, 100)])
def test_wide_backward_splits_each_operand_once(monkeypatch, dtype, d):
    """``_bwd``'s wide branch (``_bwd_wide``) splits fp32 q, k, v and dO
    into planes once each where ``_wide_on_tensor_cores`` says and hands
    the same planes (or the operands as they are) to #5w and #6w."""
    lib, splits = _fake_wide_launches(monkeypatch)
    rng = np.random.RandomState(d)
    q, k, v, o, do = (torch.from_numpy(rng.randn(2, 9, d).astype(
        np.float32)).to(dtype) for _ in range(5))
    lse = torch.zeros(2, 9)
    dq, dk, dv = tattn._bwd_wide(q, k, v, o, lse, do, True, d ** -0.5)
    assert dq.shape == q.shape and dk.shape == dv.shape == k.shape
    on_tc = dtype == torch.float32 and tattn._wide_on_tensor_cores(dtype, d)
    ops = [q, k, v, do]
    assert len(splits) == (4 if on_tc else 0)
    assert all(x is t for (x, _), t in zip(splits, ops))
    handed = [p for _, p in splits] if on_tc else ops
    (k1, ptrs1, code1), (k2, ptrs2, code2) = lib.calls
    assert (k1, k2) == ("dq", "dkv")
    assert ptrs1 == ptrs2 == tuple(t.data_ptr() for t in handed)
    assert code1 == code2 == (tattn._WIDE_F32_PLANES if on_tc
                              else tattn._WIDE_DTYPES[dtype])


def _mask3(kind, sq, sk, rng):
    if kind == "causal":
        return None
    m = rng.rand(2, sq, sk) < 0.3
    m[0, 5] = True                   # a fully masked row
    return m


@pytest.mark.parametrize("d", [48, 128, 200])
@pytest.mark.parametrize("kind", ["causal", "mask"])
def test_six_product_forward_and_dq_match_jax(d, kind):
    """The plain forward and dq with every product as six
    (``mm=_matmul6``) against the JAX fp32 ``_fwd`` and ``_bwd_impl`` at
    ``[1, 2, 96, d]``: causal, or a per-head mask with a fully masked
    row; dq from the JAX forward's out and lse, as the kernels take
    them."""
    rng = np.random.RandomState(d + len(kind))
    sq = sk = 96
    q, k, v, do = (rng.randn(2, s, d).astype(np.float32)
                   for s in (sq, sk, sk, sq))
    mask = _mask3(kind, sq, sk, rng)
    causal = kind == "causal"
    scale = d ** -0.5
    jq, jk, jv, jdo = (jnp.asarray(a) for a in (q, k, v, do))
    jmask = None if mask is None else jnp.asarray(mask)
    o, lse = jattn._fwd(jq, jk, jv, jmask, causal, scale, 32, 32)
    dq_ref = jattn._bwd_impl(jq, jk, jv, jmask, o, lse, jdo, causal, scale,
                             32, 32)[0]
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    tmask = None if mask is None else torch.from_numpy(mask)
    out, tlse = tattn._fwd_reference(tq, tk, tv, causal, scale,
                                     mask3=tmask, mm=tattn._matmul6)
    ref_o, ref_lse = np.array(o), np.array(lse)
    assert np.abs(out.numpy() - ref_o).max() <= 2e-5 * np.abs(ref_o).max()
    live = ref_lse > -1e29
    assert np.array_equal(tlse.numpy() > -1e29, live)
    assert np.abs(tlse.numpy() - ref_lse)[live].max() <= \
        2e-5 * np.abs(ref_lse[live]).max()
    jo, jl = torch.from_numpy(ref_o), torch.from_numpy(ref_lse)
    dq = tattn._dq_reference(tq, tk, tv, jl, tattn._delta(jo, tdo), tdo,
                             causal, scale, mask3=tmask, mm=tattn._matmul6)
    dq_ref = np.asarray(dq_ref)
    assert np.abs(dq.numpy() - dq_ref).max() <= 1e-4 * np.abs(dq_ref).max()


@pytest.mark.parametrize("d", [48, 128, 200])
@pytest.mark.parametrize("kind", ["causal", "mask"])
def test_six_product_dkv_matches_jax(d, kind):
    """The plain dk/dv with every product as six (``mm=_matmul6``: the
    fp32 tensor-core route's arithmetic) against the JAX fp32
    ``_bwd_impl``'s dk and dv at ``[1, 2, 96, d]``: causal, or a per-head
    mask with a fully masked row; from the JAX forward's out and lse, as
    the kernels take them."""
    rng = np.random.RandomState(2 * d + len(kind))
    sq = sk = 96
    q, k, v, do = (rng.randn(2, s, d).astype(np.float32)
                   for s in (sq, sk, sk, sq))
    mask = _mask3(kind, sq, sk, rng)
    causal = kind == "causal"
    scale = d ** -0.5
    jq, jk, jv, jdo = (jnp.asarray(a) for a in (q, k, v, do))
    jmask = None if mask is None else jnp.asarray(mask)
    o, lse = jattn._fwd(jq, jk, jv, jmask, causal, scale, 32, 32)
    _, dk_ref, dv_ref = jattn._bwd_impl(jq, jk, jv, jmask, o, lse, jdo,
                                        causal, scale, 32, 32)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    tmask = None if mask is None else torch.from_numpy(mask)
    jo, jl = torch.from_numpy(np.array(o)), torch.from_numpy(np.array(lse))
    dk, dv = tattn._dkv_reference(tq, tk, tv, jl, tattn._delta(jo, tdo), tdo,
                                  causal, scale, mask3=tmask,
                                  mm=tattn._matmul6)
    for got, ref in ((dk, dk_ref), (dv, dv_ref)):
        ref = np.asarray(ref)
        assert got.dtype == torch.float32
        assert np.abs(got.numpy() - ref).max() <= 1e-4 * np.abs(ref).max()
