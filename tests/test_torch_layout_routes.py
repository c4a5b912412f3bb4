"""Which kernel takes a bf16 view that the instances cannot read in place
(CPU: the routing decisions only; the card tests run the kernels).

The paged decode instance (#7) reads a pool whose page stride is a
multiple of 8 elements from 16-byte aligned bases; any other bf16 pool
view goes to #7w (``paged_attention._paged_route``), whose host
predicate sends it to the CUDA-core mode.  The dense decode kernel reads
a cache with equal k/v strides, contiguous rows, slot and head strides
that are multiples of 8 elements and aligned bases
(``attention._decode_in_place``); ``decode_attention`` copies any other
layout first.  ``data_ptr()`` and ``stride()`` are the same questions on
a CPU tensor.
"""
import pytest
import torch

from apex_tpu_torch.ops import attention as tattn
from apex_tpu_torch.ops import paged_attention as tpa

from _torch_isolation import restore_torch_from_amp  # noqa: F401

BF = torch.bfloat16
PAGES, LAYERS, KVH, PS, D = 9, 2, 2, 64, 128


def _pool():
    pool = torch.zeros(PAGES, LAYERS, KVH, PS, D, dtype=BF)
    assert pool.data_ptr() % 16 == 0
    return pool[:, 1]                         # one layer: strided pages


def _unaligned():
    """The layer's pages, 8 bytes into their buffer."""
    n = PAGES * KVH * PS * D
    flat = torch.zeros(n + 4, dtype=BF)
    return flat[4:].view(PAGES, KVH, PS, D)


def _odd_stride():
    """Pages 4 elements apart beyond their rows: a page stride of
    ``KVH * PS * D + 4`` (a multiple of 4, not of 8)."""
    inner = KVH * PS * D
    buf = torch.zeros(PAGES, inner + 4, dtype=BF)
    return buf.as_strided((PAGES, KVH, PS, D), (inner + 4, PS * D, D, 1))


def _route(k, v=None, q_dtype=BF, group=4):
    v = k if v is None else v
    return tpa._paged_route(q_dtype, k.dtype, group, k.shape[3], k.shape[2],
                            k.stride(0), (k.data_ptr(), v.data_ptr()))


def test_aligned_pool_views_take_the_instance():
    kp = _pool()
    assert kp.stride(0) == LAYERS * KVH * PS * D
    assert _route(kp) == "paged_attention"
    # the engine's build-time check asks without a view: its pool is
    # aligned
    assert tpa._paged_route(BF, BF, 4, D, PS) == "paged_attention"


@pytest.mark.parametrize("make", [_unaligned, _odd_stride],
                         ids=["unaligned", "odd-page-stride"])
def test_unreadable_pool_views_go_to_the_wide_kernel(make):
    kp = make()
    assert _route(kp) == "paged_attention_wide"
    # one unaligned operand is enough
    assert _route(_pool(), kp if make is _unaligned else None) == (
        "paged_attention_wide" if make is _unaligned else "paged_attention")
    # and #7w takes it on its CUDA-core mode
    assert not tpa._wide_paged_tma(BF, D, PS, kp.stride(0), kp.data_ptr(),
                                   kp.data_ptr())


@pytest.mark.parametrize("make", [_pool, _unaligned, _odd_stride],
                         ids=["aligned", "unaligned", "odd-page-stride"])
def test_other_pools_keep_their_route(make):
    """The layout adds a condition to the instance's and takes nothing
    from #7w: fp16, fp32 queries and groups past 8 go to #7w as before."""
    kp = make()
    assert _route(kp, q_dtype=torch.float16) == "paged_attention_wide"
    assert _route(kp, group=16) == "paged_attention_wide"
    half = kp.to(torch.float16)
    assert _route(half, q_dtype=torch.float16) == "paged_attention_wide"


def _cache_layer():
    cache = torch.zeros(3, LAYERS, KVH, 256, D, dtype=BF)
    return cache[:, 1]                 # one layer of the dense cache


def test_dense_cache_layer_is_read_in_place():
    k = _cache_layer()
    assert not k.is_contiguous()
    assert tattn._decode_in_place(k, _cache_layer())


@pytest.mark.parametrize("layout", ["unaligned", "odd-slot-stride",
                                    "rows-transposed", "unequal-strides"])
def test_dense_cache_layouts_the_kernel_cannot_read(layout):
    k = _cache_layer()
    v = _cache_layer()
    if layout == "unaligned":
        flat = torch.zeros(k.numel() + 4, dtype=BF)
        k = flat[4:].view(k.shape)
    elif layout == "odd-slot-stride":
        buf = torch.zeros(3, KVH * 256 * D + 4, dtype=BF)
        k = buf.as_strided(k.shape, (KVH * 256 * D + 4, 256 * D, D, 1))
        v = k
    elif layout == "rows-transposed":
        k = torch.zeros(3, KVH, D, 256, dtype=BF).transpose(2, 3)
        v = k
    else:
        v = v.contiguous()
    assert not tattn._decode_in_place(k, v)
    # a contiguous copy, as decode_attention makes, is read in place
    kc, vc = (t.clone(memory_format=torch.contiguous_format)
              for t in (k, v))
    assert tattn._decode_in_place(kc, vc)


def test_unreadable_views_run_on_the_cpu():
    """On the CPU both entries take their plain versions, whatever the
    layout: the same result as from an aligned copy."""
    g = torch.Generator().manual_seed(0)
    kp = _unaligned()
    kp.copy_(torch.randn(kp.shape, generator=g).to(BF))
    vp = _odd_stride()
    vp.copy_(torch.randn(vp.shape, generator=g).to(BF))
    q = torch.randn(2, KVH * 4, D, generator=g).to(BF)
    table = torch.tensor([[0, 1, 2, 3], [4, 5, 6, 7]], dtype=torch.int32)
    lengths = torch.tensor([100, 250], dtype=torch.int32)
    got = tpa.paged_decode_attention(q, kp, vp, table, lengths)
    want = tpa.paged_decode_attention(q, kp.contiguous(), vp.contiguous(),
                                      table, lengths)
    assert torch.equal(got, want)
