"""Port parity: the paged pool of ``apex_tpu_torch.inference.kv_cache``
against ``apex_tpu.inference.kv_cache`` on the same writes, plus the
refcount laws of the copied ``PageAllocator``.

The JAX mutations are pure (a new cache per call); the port's update
the pool in place — so each test applies the same sequence to both and
compares every array of the result bit for bit (fp32 copies, no
arithmetic).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.inference import kv_cache as jkv
from apex_tpu_torch.inference import kv_cache as tkv

from _torch_isolation import restore_torch_from_amp  # noqa: F401

PAGES, LAYERS, KVH, PS, D, SLOTS, MPPS = 6, 2, 2, 4, 8, 2, 4


def _pair():
    j = jkv.init_paged_cache(PAGES, LAYERS, KVH, PS, D, slots=SLOTS,
                             max_pages_per_slot=MPPS, dtype=jnp.float32)
    t = tkv.init_paged_cache(PAGES, LAYERS, KVH, PS, D, slots=SLOTS,
                             max_pages_per_slot=MPPS, dtype=torch.float32,
                             device="cpu")
    return j, t


def _same(j, t):
    for name in ("k", "v", "page_table", "lengths", "capacity"):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)),
                                      err_msg=name)


def _slab(s, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(LAYERS, KVH, s, D).astype(np.float32),
            rng.randn(LAYERS, KVH, s, D).astype(np.float32))


def _insert(j, t, slot, k, v, length, row, start):
    j = jkv.insert_tokens(j, slot, jnp.asarray(k), jnp.asarray(v), length,
                          jnp.asarray(row), start)
    t = tkv.insert_tokens(t, slot, torch.from_numpy(k), torch.from_numpy(v),
                          length, row, start)
    return j, t


def test_init_and_trash_page_convention():
    j, t = _pair()
    _same(j, t)
    assert t.null_page == PAGES and t.pages == PAGES + 1
    assert t.max_seq == MPPS * PS
    assert bool((t.page_table == PAGES).all())


def test_insert_tokens_cold_unaligned_and_overrun_match_jax():
    j, t = _pair()
    row0 = tkv.page_row([3, 0], MPPS, PAGES)
    k, v = _slab(8, 0)                     # a bucket of 8, 6 real tokens
    j, t = _insert(j, t, 0, k, v, 6, row0, 0)
    _same(j, t)
    # a mid-page resume (prefix hit / chunk) into slot 1
    row1 = tkv.page_row([5, 1, 2], MPPS, PAGES)
    k, v = _slab(8, 1)
    j, t = _insert(j, t, 1, k, v, 13, row1, 5)
    _same(j, t)
    # a slab running past the virtual window: those rows are dropped
    k, v = _slab(8, 2)
    j, t = _insert(j, t, 1, k, v, 16, row1, 12)
    _same(j, t)


def test_append_advance_evict_and_cow_match_jax():
    j, t = _pair()
    row0 = tkv.page_row([3, 0], MPPS, PAGES)
    row1 = tkv.page_row([4], MPPS, PAGES)
    k, v = _slab(4, 3)
    j, t = _insert(j, t, 0, k, v, 7, row0, 0)
    j, t = _insert(j, t, 1, k, v, 4, row1, 0)    # slot 1 at capacity
    rng = np.random.RandomState(9)
    for layer in range(LAYERS):
        kt = rng.randn(SLOTS, KVH, D).astype(np.float32)
        vt = rng.randn(SLOTS, KVH, D).astype(np.float32)
        j = jkv.append_layer(j, layer, jnp.asarray(kt), jnp.asarray(vt))
        t = tkv.append_layer(t, layer, torch.from_numpy(kt),
                             torch.from_numpy(vt))
        _same(j, t)
    active = np.array([True, True])
    j, jtr = jkv.advance(j, jnp.asarray(active))
    t, ttr = tkv.advance(t, torch.from_numpy(active))
    _same(j, t)
    np.testing.assert_array_equal(ttr.numpy(), np.asarray(jtr))
    assert ttr.tolist() == [False, True]
    j, t = jkv.cow_page(j, 3, 5), tkv.cow_page(t, 3, 5)
    _same(j, t)
    j, t = jkv.evict(j, 0), tkv.evict(t, 0)
    _same(j, t)


def test_allocator_refcount_laws():
    alloc = tkv.PageAllocator(8, PS, MPPS)
    a = alloc.acquire(3)
    b = alloc.acquire(2)
    assert alloc.free_pages + alloc.live_pages == 8
    alloc.share(a[:2])                      # a second owner of two pages
    assert alloc.shared_pages() == 2
    assert alloc.weighted_live() == 3 + 2 + 2
    alloc.release(a)
    assert alloc.live_pages == 4 and alloc.refcount(a[0]) == 1
    alloc.release(a[:2])
    assert alloc.free_pages + alloc.live_pages == 8
    assert alloc.acquire(1) == [a[1]]       # LIFO reuse
    with pytest.raises(ValueError):
        alloc.release([a[2]])               # double release
    with pytest.raises(ValueError):
        alloc.share([a[0]])                 # sharing a freed page
    assert alloc.acquire(9) is None         # backpressure, not failure
    alloc.release(b)
    assert alloc.pages_needed(0) == 1 and alloc.pages_needed(100) == MPPS


def test_allocator_copy_is_the_jax_allocator():
    """Same operations, same books: the copy behaves as the original."""
    ja, ta = jkv.PageAllocator(6, PS, MPPS), tkv.PageAllocator(6, PS, MPPS)
    for alloc in (ja, ta):
        x = alloc.acquire(4)
        alloc.share(x[1:3])
        alloc.release(x)
    assert ja.snapshot() == ta.snapshot()
