"""The port's CUDA kernels against their plain PyTorch versions, on the
card, over the shapes and options the serving path does not reach
(other head dims and query groups, small pages, q/k lengths that differ,
padded validity windows, the fp32 LayerNorm paths).

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
