"""The port's CUDA kernels against their plain PyTorch versions, on the
card, over the shapes and options the main paths do not reach (other
head dims and query groups, small pages, q/k lengths that differ,
padded validity windows, the fp32 LayerNorm paths, LayerNorm's
backward, odd flat lengths and offset views for the unscale, Adam, the
L2 norm, LAMB's phase 1, SGD and Adagrad, the L2 norm's run-to-run
repeatability, the LAMB rule against its plain route,
the fused decode block's query groups, head dims, edge lengths, slot
groups and its attention-only variant).

A CUDA kernel has no CPU mode, so every test here takes the ``cuda``
fixture and skips without a card.  On a machine with one (the package's
JAX reference is not needed, nor the repo's test ``conftest.py``)::

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py -q

Tolerances: bf16 outputs within 2e-2 absolute (unit-scale inputs; both
sides compute in fp32 and round p and the output to bf16, in a
different order); base-2 lse within 1e-3; norms within 2^-6 of the
output's magnitude (a few bf16 ulps).
"""
import importlib

import numpy as np
import pytest
import torch

from apex_tpu_torch.ops import _build
from apex_tpu_torch.ops import attention as attn
from apex_tpu_torch.ops import paged_attention as pa

# by module name: the package re-exports a function called layer_norm
ln = importlib.import_module("apex_tpu_torch.ops.layer_norm")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _randn(shape, seed, dev, dtype=torch.bfloat16):
    rng = np.random.RandomState(seed)
    return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(
        dev, dtype)


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("sq,sk", [(100, 100), (40, 200), (130, 64)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_matches_plain(cuda, d, sq, sk, causal):
    q, k, v = (_randn((3, s, d), seed, cuda)
               for seed, s in ((1, sq), (2, sk), (3, sk)))
    before = _build.launch_counts()["flash_attention"]
    out, lse = attn._fwd(q, k, v, causal, d ** -0.5)
    assert _build.launch_counts()["flash_attention"] == before + 1
    ref_out, ref_lse = attn._fwd_reference(q, k, v, causal, d ** -0.5)
    torch.cuda.synchronize()
    assert (out.float() - ref_out.float()).abs().max().item() <= 2e-2
    assert (lse - ref_lse).abs().max().item() <= 1e-3


def test_flash_kernel_validity_window_and_offset(cuda):
    """A padded bucket (90 real of 128 rows and columns) with an
    explicit causal offset: padded rows emit 0 and lse -1e30."""
    q, k, v = (_randn((2, 128, 64), seed, cuda) for seed in (4, 5, 6))
    out, lse = attn._fwd(q, k, v, True, 0.125, causal_off=0,
                         valid=(90, 90))
    ref_out, ref_lse = attn._fwd_reference(q, k, v, True, 0.125,
                                           causal_off=0, valid=(90, 90))
    assert (out.float() - ref_out.float()).abs().max().item() <= 2e-2
    assert (lse - ref_lse).abs().max().item() <= 1e-3
    assert bool((out[:, 90:] == 0).all())


def test_flash_kernel_refuses_what_it_does_not_take(cuda):
    q = _randn((1, 2, 16, 64), 7, cuda, torch.float32)
    with pytest.raises(TypeError, match="bfloat16"):
        attn.flash_attention(q, q, q, causal=True)
    qb = q.to(torch.bfloat16)
    with pytest.raises(NotImplementedError):
        attn.flash_attention(qb, qb, qb, mask=torch.zeros(
            16, 16, dtype=torch.bool, device=cuda))


@pytest.mark.parametrize("group", [1, 2, 4, 8])
@pytest.mark.parametrize("d,ps", [(64, 16), (128, 64)])
def test_paged_kernel_matches_plain(cuda, group, d, ps):
    slots, kvh, layers, mpps = 6, 2, 3, 700 // ps + 1
    lengths_l = [0, 1, ps, ps + 1, 300, 700]
    n_pages = slots * mpps
    pool_k = _randn((n_pages + 1, layers, kvh, ps, d), 8, cuda)
    pool_v = _randn((n_pages + 1, layers, kvh, ps, d), 9, cuda)
    perm = np.random.RandomState(10).permutation(n_pages)
    table = np.full((slots, mpps), n_pages, np.int32)
    cursor = 0
    for s, n in enumerate(lengths_l):
        need = -(-n // ps)
        table[s, :need] = perm[cursor:cursor + need]
        cursor += need
    table = torch.from_numpy(table).to(cuda)
    lengths = torch.tensor(lengths_l, dtype=torch.int32, device=cuda)
    q = _randn((slots, kvh * group, d), 11, cuda)
    kp, vp = pool_k[:, 1], pool_v[:, 1]            # strided layer views
    got = pa.paged_decode_attention(q, kp, vp, table, lengths)
    ref = pa.paged_decode_reference(q, kp, vp, table, lengths, d ** -0.5)
    torch.cuda.synchronize()
    assert (got.float() - ref.float()).abs().max().item() <= 2e-2
    assert bool((got[0] == 0).all())


@pytest.mark.parametrize("hidden", [4096, 1001, 64])
@pytest.mark.parametrize("x_dtype,w_dtype", [
    (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
    (torch.float32, torch.bfloat16), (torch.float32, torch.float32)])
def test_norm_kernels_match_plain(cuda, hidden, x_dtype, w_dtype):
    x = _randn((37, hidden), 12, cuda, x_dtype) * 3 + 0.5
    w = 1 + 0.1 * _randn((hidden,), 13, cuda, w_dtype)
    b = 0.1 * _randn((hidden,), 14, cuda, w_dtype)
    for got, ref in ((ln.rms_norm(x, w), ln.rms_norm_reference(x, w)),
                     (ln.layer_norm(x, w, b),
                      ln.layer_norm_reference(x, w, b))):
        assert got.dtype == x_dtype
        tol = 2.0 ** -6 * ref.float().abs().max().item()
        assert (got.float() - ref.float()).abs().max().item() <= tol


# -- the training slice's kernels ----------------------------------------
#
# Tolerances: norm dx within 2^-6 of its magnitude (bf16 ulps), dw within
# 1e-3 of its magnitude (fp32 sums over rows in another order, of
# products of rounded inputs); flash dq/dk/dv element by element within
# 2^-6 |ref| + 2^-9 (two bf16 ulps of each element and a floor far below
# a typical element; fp32 accumulation, p and ds rounded to bf16 on both
# sides, dq summed by atomics in any order) and each output within a
# relative L2 of 1e-2; through autograd against the fp32 math of the
# whole attention (p not rounded), a relative L2 of 1e-2 per grad; the
# unscale exact (one fp32 multiply, the same on both sides); Adam within
# 1e-6 relative (the kernel may contract multiply-adds into FMAs), and
# bit-identical under the noop flag.


def _maxdiff(a, b):
    return (a.float() - b.float()).abs().max().item()


def _rel_l2(a, b):
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm()).item()


def _assert_flash_bwd_close(got, ref):
    for g, r in zip(got, ref):
        assert g.dtype == torch.bfloat16
        g, r = g.float(), r.float()
        assert bool(((g - r).abs() <= 2.0 ** -6 * r.abs() + 2.0 ** -9).all())
        assert _rel_l2(g, r) <= 1e-2


@pytest.mark.parametrize("hidden", [4096, 1001, 64])
@pytest.mark.parametrize("x_dtype,w_dtype", [
    (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
    (torch.float32, torch.float32)])
@pytest.mark.parametrize("rms", [True, False])
def test_norm_bwd_kernel_matches_plain(cuda, hidden, x_dtype, w_dtype, rms):
    x = _randn((300, hidden), 20, cuda, x_dtype) * 2 + 0.3
    w = 1 + 0.1 * _randn((hidden,), 21, cuda, w_dtype)
    dy = _randn((300, hidden), 22, cuda, x_dtype)
    before = _build.launch_counts()["layer_norm_bwd"]
    dx, dw, db = ln._bwd_2d(x, w, dy, 1e-5, rms)
    assert _build.launch_counts()["layer_norm_bwd"] == before + 1
    rdx, rdw, rdb = ln._bwd_reference(x, w, dy, 1e-5, rms)
    torch.cuda.synchronize()
    assert dx.dtype == x_dtype and dw.dtype == torch.float32
    assert _maxdiff(dx, rdx) <= 2.0 ** -6 * rdx.float().abs().max().item()
    assert _maxdiff(dw, rdw) <= 1e-3 * rdw.abs().max().item()
    if rms:
        assert db is None
    else:
        assert _maxdiff(db, rdb) <= 1e-3 * rdb.abs().max().item()


def test_norm_autograd_launches_the_backward_kernel(cuda):
    x = _randn((64, 256), 23, cuda).requires_grad_()
    w = (1 + 0.1 * _randn((256,), 24, cuda)).requires_grad_()
    before = _build.launch_counts()["layer_norm_bwd"]
    ln.rms_norm(x, w).float().square().sum().backward()
    assert _build.launch_counts()["layer_norm_bwd"] == before + 1
    assert x.grad.dtype == torch.bfloat16 and w.grad.dtype == torch.bfloat16


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("sq,sk", [(100, 100), (40, 200), (130, 64),
                                   (256, 256)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_kernel_matches_plain(cuda, d, sq, sk, causal):
    q, k, v = (_randn((3, s, d), seed, cuda)
               for seed, s in ((30, sq), (31, sk), (32, sk)))
    do = _randn((3, sq, d), 33, cuda)
    scale = d ** -0.5
    out, lse = attn._fwd(q, k, v, causal, scale)
    before = _build.launch_counts()["flash_attention_bwd"]
    got = attn._bwd(q, k, v, out, lse, do, causal, scale)
    assert _build.launch_counts()["flash_attention_bwd"] == before + 1
    ref = attn._bwd_reference(q, k, v, out, lse, do, causal, scale)
    torch.cuda.synchronize()
    _assert_flash_bwd_close(got, ref)


def test_flash_bwd_kernel_validity_window_and_offset(cuda):
    q, k, v, do = (_randn((2, 128, 64), seed, cuda) for seed in (34, 35, 36,
                                                                37))
    out, lse = attn._fwd(q, k, v, True, 0.125, causal_off=0, valid=(90, 90))
    got = attn._bwd(q, k, v, out, lse, do, True, 0.125, causal_off=0,
                    valid=(90, 90))
    ref = attn._bwd_reference(q, k, v, out, lse, do, True, 0.125,
                              causal_off=0, valid=(90, 90))
    _assert_flash_bwd_close(got, ref)
    assert bool((got[0][:, 90:] == 0).all()) and bool((got[1][:, 90:] == 0)
                                                      .all())


def test_flash_autograd_sums_gqa_groups(cuda):
    """k/v broadcast to the q heads before the kernel, as the model does:
    autograd sums dk/dv over each group."""
    q = _randn((1, 4, 96, 64), 38, cuda).requires_grad_()
    kk = _randn((1, 2, 96, 64), 39, cuda).requires_grad_()
    vv = _randn((1, 2, 96, 64), 40, cuda).requires_grad_()
    k, v = (t[:, :, None].expand(1, 2, 2, 96, 64).reshape(1, 4, 96, 64)
            for t in (kk, vv))
    do = _randn((1, 4, 96, 64), 41, cuda)
    attn.flash_attention(q, k, v, causal=True).backward(do)
    q2, k2, v2 = (t.detach().float().requires_grad_() for t in (q, kk, vv))
    kf, vf = (t[:, :, None].expand(1, 2, 2, 96, 64).reshape(1, 4, 96, 64)
              for t in (k2, v2))
    attn.mha_reference(q2, kf, vf, causal=True).backward(do.float())
    for g, r in ((q.grad, q2.grad), (kk.grad, k2.grad), (vv.grad, v2.grad)):
        assert _rel_l2(g, r) <= 1e-2


@pytest.mark.parametrize("n", [1 << 20, 1000003])
@pytest.mark.parametrize("src_dtype", [torch.float32, torch.bfloat16])
def test_fused_scale_kernel_matches_plain(cuda, n, src_dtype):
    fu = importlib.import_module("apex_tpu_torch.ops.fused_update")
    x = _randn((n,), 42, cuda, src_dtype) * 1000
    scale = torch.full((), 2.0 ** -16, device=cuda)
    before = _build.launch_counts()["fused_scale"]
    out, flag = fu.fused_scale(x, scale, torch.float32)
    assert _build.launch_counts()["fused_scale"] == before + 1
    ref, rflag = fu._scale_reference(x, scale, torch.float32)
    assert torch.equal(out, ref) and flag.item() == 0.0 == rflag.item()
    x[n // 3] = float("inf")
    _, flag = fu.fused_scale(x, scale, torch.float32)
    assert flag.item() == 1.0
    # in place, on an offset view (the scalar path of the kernel)
    y = _randn((n + 1,), 43, cuda)[1:]
    want = y * 0.5
    y[7] = float("nan")
    want[7] = float("nan")
    got, flag = fu.fused_scale(y, 0.5, out=y)
    assert got.data_ptr() == y.data_ptr() and flag.item() == 1.0
    assert torch.equal(torch.nan_to_num(got, 9.0), torch.nan_to_num(want,
                                                                     9.0))


@pytest.mark.parametrize("adam_w", [True, False])
@pytest.mark.parametrize("g_dtype", [torch.float32, torch.bfloat16])
def test_fused_adam_kernel_matches_plain(cuda, adam_w, g_dtype):
    fu = importlib.import_module("apex_tpu_torch.ops.fused_update")
    n = 1000003
    p, m = _randn((n,), 44, cuda, torch.float32), _randn((n,), 45, cuda,
                                                         torch.float32)
    v = _randn((n,), 46, cuda, torch.float32).abs()
    g = _randn((n,), 47, cuda, g_dtype)
    kw = dict(lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.01,
              step=torch.full((), 3.0, device=cuda), adam_w_mode=adam_w,
              grad_scale=0.5)
    hp = fu._adam_hparams(cuda, noop_flag=0.0, bias_correction=True,
                          **{k: kw[k] for k in ("lr", "beta1", "beta2", "eps",
                                                "weight_decay", "step",
                                                "grad_scale")})
    ref = fu._adam_kernel_reference(p, g, m, v, hp, adam_w)
    before = _build.launch_counts()["fused_adam"]
    got = fu.fused_adam_flat(p, g, m, v, **kw)
    assert _build.launch_counts()["fused_adam"] == before + 1
    assert got[0].data_ptr() == p.data_ptr()
    for a, b in zip(got, ref):
        assert _maxdiff(a, b) <= 1e-6 * b.abs().max().item()
    snap = [t.clone() for t in (p, m, v)]
    fu.fused_adam_flat(p, g, m, v, noop_flag=torch.ones((), device=cuda),
                       **kw)
    assert all(torch.equal(a, b) for a, b in zip((p, m, v), snap))


# -- the optimizer family: L2 norm, LAMB phase 1, SGD, Adagrad ------------
#
# Each at an odd length and on views that start one element in (LAMB's
# per-leaf slices start anywhere: the kernels' scalar path), with fp32
# and bf16 grads; the update kernels against their plain versions within
# 1e-6 of the output's magnitude (one fp32 multiply-add contracted or
# not), and a noop step bit for bit.

def _fu():
    return importlib.import_module("apex_tpu_torch.ops.fused_update")


def _flat(n, seed, dev, offset, dtype=torch.float32):
    """n elements starting ``offset`` elements into their allocation."""
    return _randn((n + offset,), seed, dev, dtype)[offset:]


@pytest.mark.parametrize("n", [5, 1000003, 1 << 22])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset", [0, 1])
def test_fused_l2norm_kernel_matches_plain_and_repeats(cuda, n, dtype,
                                                       offset):
    fu = _fu()
    x = _flat(n, 48, cuda, offset, dtype) * 3
    before = _build.launch_counts()["fused_l2norm"]
    got = fu.fused_l2norm(x)
    assert _build.launch_counts()["fused_l2norm"] == before + 1
    ref = fu._l2norm_reference(x)
    # fp32 sums of squares in another order
    assert abs(got.item() - ref.item()) <= 1e-5 * ref.item()
    # a fixed summation order: the same bits every run
    for _ in range(3):
        assert torch.equal(fu.fused_l2norm(x), got)
    norms = torch.zeros(4, device=cuda)
    fu.fused_l2norm(x, out=norms[2])
    assert norms[2].item() == got.item() and norms[3].item() == 0.0
    assert fu.fused_l2norm(x[:0]).item() == 0.0


@pytest.mark.parametrize("g_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset", [0, 1])
def test_fused_lamb1_kernel_matches_plain(cuda, g_dtype, offset):
    fu = _fu()
    n = 1000003
    p = _flat(n, 49, cuda, offset)
    m = _flat(n, 50, cuda, offset) * 0.1
    v = _flat(n, 51, cuda, offset).abs()
    g = _flat(n, 52, cuda, offset, g_dtype)
    u = torch.empty(n + offset, device=cuda)[offset:]
    kw = dict(beta1=0.9, beta2=0.999, eps=1e-6, weight_decay=0.01,
              step=torch.full((), 3.0, device=cuda), bias_correction=True,
              grad_scale=0.5, grad_averaging=True)
    hp = fu._lamb1_hparams(cuda, noop_flag=0.0, **kw)
    ref = fu._lamb1_kernel_reference(p, g, m, v, hp)
    before = _build.launch_counts()["fused_lamb1"]
    got = fu.fused_lamb_phase1_flat(p, g, m, v, u=u, **kw)
    assert _build.launch_counts()["fused_lamb1"] == before + 1
    assert got[2].data_ptr() == u.data_ptr()
    for a, b in zip(got, ref):
        assert _maxdiff(a, b) <= 1e-6 * b.abs().max().item()
    snap = [t.clone() for t in (m, v)]
    fu.fused_lamb_phase1_flat(p, g, m, v, u=u,
                              noop_flag=torch.ones((), device=cuda), **kw)
    assert torch.equal(m, snap[0]) and torch.equal(v, snap[1])
    assert torch.equal(u, torch.zeros_like(u))


@pytest.mark.parametrize("nesterov,wd_after,first,momentum", [
    (False, False, False, 0.9), (True, True, False, 0.9),
    (True, False, True, 0.9), (False, False, False, 0.0)])
@pytest.mark.parametrize("g_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset", [0, 1])
def test_fused_sgd_kernel_matches_plain(cuda, nesterov, wd_after, first,
                                        momentum, g_dtype, offset):
    fu = _fu()
    n = 1000003
    p, b = _flat(n, 53, cuda, offset), _flat(n, 54, cuda, offset)
    g = _flat(n, 55, cuda, offset, g_dtype)
    kw = dict(lr=0.1, momentum=momentum, dampening=0.1, weight_decay=0.01,
              first_run=torch.full((), float(first), device=cuda),
              grad_scale=0.5)
    hp = fu._sgd_hparams(cuda, noop_flag=0.0, **kw)
    ref = fu._sgd_kernel_reference(p, g, b, hp, nesterov, wd_after)
    before = _build.launch_counts()["fused_sgd"]
    got = fu.fused_sgd_flat(p, g, b, nesterov=nesterov,
                            wd_after_momentum=wd_after, **kw)
    assert _build.launch_counts()["fused_sgd"] == before + 1
    assert got[0].data_ptr() == p.data_ptr()
    for a, r in zip(got, ref):
        assert _maxdiff(a, r) <= 1e-6 * r.abs().max().item()
    snap = [t.clone() for t in (p, b)]
    fu.fused_sgd_flat(p, g, b, nesterov=nesterov, wd_after_momentum=wd_after,
                      noop_flag=torch.ones((), device=cuda), **kw)
    assert torch.equal(p, snap[0]) and torch.equal(b, snap[1])


@pytest.mark.parametrize("w_mode", [False, True])
@pytest.mark.parametrize("g_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset", [0, 1])
def test_fused_adagrad_kernel_matches_plain(cuda, w_mode, g_dtype, offset):
    fu = _fu()
    n = 1000003
    p = _flat(n, 56, cuda, offset)
    h = _flat(n, 57, cuda, offset).abs()
    g = _flat(n, 58, cuda, offset, g_dtype)
    kw = dict(lr=1e-2, eps=1e-10, weight_decay=0.01, grad_scale=0.5)
    hp = fu._adagrad_hparams(cuda, noop_flag=0.0, **kw)
    ref = fu._adagrad_kernel_reference(p, g, h, hp, w_mode)
    before = _build.launch_counts()["fused_adagrad"]
    got = fu.fused_adagrad_flat(p, g, h, w_mode=w_mode, **kw)
    assert _build.launch_counts()["fused_adagrad"] == before + 1
    assert got[1].data_ptr() == h.data_ptr()
    for a, r in zip(got, ref):
        assert _maxdiff(a, r) <= 1e-6 * r.abs().max().item()
    snap = [t.clone() for t in (p, h)]
    fu.fused_adagrad_flat(p, g, h, w_mode=w_mode,
                          noop_flag=torch.ones((), device=cuda), **kw)
    assert torch.equal(p, snap[0]) and torch.equal(h, snap[1])


def test_lamb_rule_on_the_card_matches_its_plain_route(cuda):
    """One LAMB update of a 3-leaf flat state through the kernels (one
    global norm, a weight and a direction norm per leaf, one phase-1
    launch) against the same update with each kernel swapped for its
    plain version."""
    from apex_tpu_torch.optimizers import functional
    fu = _fu()
    sizes = {"a": 1001, "b": 4096, "c": 7}
    tree = {k: _randn((n,), 59 + i, cuda, torch.float32)
            for i, (k, n) in enumerate(sizes.items())}
    tx = functional.fused_lamb(lr=1e-2, weight_decay=0.01)
    g = _randn((sum(sizes.values()),), 63, cuda, torch.bfloat16)
    states = [tx.init(tree) for _ in range(2)]
    _build.reset_launch_counts()
    states[0] = tx.update(states[0], g)
    counts = _build.launch_counts()
    assert counts["fused_l2norm"] == 1 + 2 * len(sizes)
    assert counts["fused_lamb1"] == 1
    saved = (fu._l2norm_kernel, fu._lamb1_kernel)
    fu._l2norm_kernel, fu._lamb1_kernel = fu._l2norm_plain, fu._lamb1_plain
    try:
        states[1] = tx.update(states[1], g)
    finally:
        fu._l2norm_kernel, fu._lamb1_kernel = saved
    assert _build.launch_counts() == counts
    for a, b in ((states[0].master, states[1].master),
                 (states[0].slots["exp_avg"], states[1].slots["exp_avg"]),
                 (states[0].slots["exp_avg_sq"],
                  states[1].slots["exp_avg_sq"])):
        assert _maxdiff(a, b) <= 1e-6 * b.abs().max().item()


# -- the fused decode block ----------------------------------------------
#
# Tolerances: y, k_tok and v_tok within 2^-6 of each output's magnitude
# (bf16 outputs, a few ulps: the kernel and the plain version round the
# same values at the same points, and differ by fp32 sums in another
# order and by p rounded against a split's running maximum instead of
# the window's), and within a relative L2 of 1e-2 each.


def _fused_case(cuda, group, d, lengths, ps=16, mpps=20, heads=8, ffn=1376):
    kvh, slots = heads // group, len(lengths)
    hidden = heads * d
    pa_ = importlib.import_module("apex_tpu_torch.ops.paged_attention")
    from apex_tpu_torch.transformer.testing.standalone_llama import (
        _rope_cos_sin)

    def lin(i, o, seed):
        return _randn((i, o), seed, cuda) * i ** -0.5

    blk = {"ln1_w": 1 + 0.1 * _randn((1, hidden), 50, cuda),
           "wq": lin(hidden, heads * d, 51), "wk": lin(hidden, kvh * d, 52),
           "wv": lin(hidden, kvh * d, 53), "wo": lin(heads * d, hidden, 54),
           "ln2_w": 1 + 0.1 * _randn((1, hidden), 55, cuda),
           "wg": lin(hidden, ffn, 56), "wu": lin(hidden, ffn, 57),
           "wd": lin(ffn, hidden, 58)}
    n_pages = slots * mpps
    pool_k = _randn((n_pages + 1, 3, kvh, ps, d), 59, cuda)
    pool_v = _randn((n_pages + 1, 3, kvh, ps, d), 60, cuda)
    perm = np.random.RandomState(61).permutation(n_pages)
    table = np.full((slots, mpps), n_pages, np.int32)
    cursor = 0
    for s_, n in enumerate(lengths):
        need = min(-(-n // ps), mpps)
        table[s_, :need] = perm[cursor:cursor + need]
        cursor += need
    cos_t, sin_t = _rope_cos_sin(mpps * ps, d, 500000.0, device=cuda)
    pos = torch.clamp(torch.tensor(lengths, device=cuda), max=mpps * ps - 1)
    return pa_, (_randn((slots, hidden), 62, cuda), blk, pool_k[:, 1],
                 pool_v[:, 1], torch.from_numpy(table).to(cuda),
                 torch.tensor(lengths, dtype=torch.int32, device=cuda)), \
        dict(kind="llama", eps=1e-5, cos=cos_t.reshape(-1, d)[pos],
             sin=sin_t.reshape(-1, d)[pos])


def _assert_fused_close(got, ref):
    for name, g, r in zip(("y", "k_tok", "v_tok"), got, ref):
        assert g.dtype == torch.bfloat16 and g.shape == r.shape, name
        assert _maxdiff(g, r) <= 2.0 ** -6 * r.float().abs().max().item(), name
        assert _rel_l2(g, r) <= 1e-2, name


@pytest.mark.parametrize("group", [1, 2, 4, 8])
@pytest.mark.parametrize("d", [64, 128])
def test_fused_block_kernel_matches_plain(cuda, group, d):
    """Lengths 0, 1, ps - 1, ps and the full window (two 256-token
    splits, the second partial) of a strided 3-layer pool view."""
    pa_, args, kw = _fused_case(cuda, group, d, [0, 1, 15, 16, 320])
    before = _build.launch_counts()["fused_block_decode"]
    got = pa_.fused_block_decode(*args, **kw)
    assert _build.launch_counts()["fused_block_decode"] == before + 1
    ref = pa_.fused_block_reference(*args, **kw)
    torch.cuda.synchronize()
    _assert_fused_close(got, ref)


@pytest.mark.parametrize("ln_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("fuse_mlp", [True, False])
def test_fused_block_kernel_slot_groups_and_attention_only(cuda, fuse_mlp,
                                                           ln_dtype):
    """Ten slots (two passes of eight over each weight tile), lengths past
    the window clamp to it; without the MLP, y = x + attention; the norm
    weights in bf16 or fp32."""
    lengths = [0, 3, 64, 65, 100, 200, 319, 320, 400, 7]
    pa_, args, kw = _fused_case(cuda, 4, 128, lengths)
    blk = args[1]
    for n in ("ln1_w", "ln2_w"):
        blk[n] = blk[n].to(ln_dtype)
    got = pa_.fused_block_decode(*args, fuse_mlp=fuse_mlp, **kw)
    ref = pa_.fused_block_reference(*args, fuse_mlp=fuse_mlp, **kw)
    torch.cuda.synchronize()
    _assert_fused_close(got, ref)


def test_fused_block_kernel_refuses_what_it_does_not_take(cuda):
    pa_, (x, blk, kp, vp, table, lengths), kw = _fused_case(
        cuda, 2, 64, [0, 5, 16])
    before = _build.launch_counts()["fused_block_decode"]
    with pytest.raises(TypeError, match="bfloat16"):
        pa_.fused_block_decode(x.float(), blk, kp, vp, table, lengths, **kw)
    bad = dict(blk, wq=blk["wq"].T.contiguous().T)
    with pytest.raises(ValueError, match="contiguous"):
        pa_.fused_block_decode(x, bad, kp, vp, table, lengths, **kw)
    _, (x3, blk3, kp3, vp3, t3, l3), kw3 = _fused_case(cuda, 3, 64,
                                                        [0, 5, 16], heads=6)
    with pytest.raises(ValueError, match="group"):
        pa_.fused_block_decode(x3, blk3, kp3, vp3, t3, l3, **kw3)
    with pytest.raises(NotImplementedError, match="GPT serving"):
        pa_.fused_block_decode(x, blk, kp, vp, table, lengths,
                               **dict(kw, kind="gpt"))
    assert _build.launch_counts()["fused_block_decode"] == before
