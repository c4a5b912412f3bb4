"""Port parity: ``apex_tpu_torch.ops.paged_attention`` against the JAX
Pallas ``_paged_kernel`` (forced with ``use_kernel=True``, interpret
mode) on the same numpy pool.

Ragged lengths include 0 (emits zeros), page boundaries (16, 17) and a
full window; GQA group 2; a shuffled page table whose dead entries
point at the trash page; the port reads one layer of a 5-D
``[pages, layers, kv_heads, page_size, head_dim]`` pool through a
strided view, as the engine does.  Tolerance: fp32 2e-5 (both fp32,
base-2 online vs one-pass softmax); bf16 one bf16 ulp at the output's
magnitude (both round P to bf16 for P·V and the output once).
"""
import importlib
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops.paged_attention import (
    paged_decode_attention as jax_paged,
)
from apex_tpu_torch.ops.paged_attention import paged_decode_attention

from _torch_isolation import restore_torch_from_amp  # noqa: F401

# by module name: the package re-exports the function of the same name
tpa = importlib.import_module("apex_tpu_torch.ops.paged_attention")

SLOTS, H, KVH, D, PS, MPPS, LAYERS = 5, 4, 2, 32, 16, 4, 3
LENGTHS = [0, 1, 16, 17, 64]


def _pool(seed=0):
    rng = np.random.RandomState(seed)
    n_pages = SLOTS * MPPS                 # + 1 trash page at the end
    shape = (n_pages + 1, LAYERS, KVH, PS, D)
    pool_k = rng.randn(*shape).astype(np.float32)
    pool_v = rng.randn(*shape).astype(np.float32)
    perm = rng.permutation(n_pages)
    table = np.full((SLOTS, MPPS), n_pages, np.int32)
    cursor = 0
    for s, n in enumerate(LENGTHS):
        need = -(-n // PS)
        table[s, :need] = perm[cursor:cursor + need]
        cursor += need
    q = rng.randn(SLOTS, H, D).astype(np.float32)
    return q, pool_k, pool_v, table, np.asarray(LENGTHS, np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layer", [0, 2])
def test_paged_decode_matches_jax_kernel(layer, dtype):
    q, pk, pv, table, lengths = _pool(seed=layer)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    ref = jax_paged(jnp.asarray(q, jd), jnp.asarray(pk[:, layer], jd),
                    jnp.asarray(pv[:, layer], jd), jnp.asarray(table),
                    jnp.asarray(lengths), use_kernel=True)
    ref = np.asarray(ref.astype(jnp.float32))
    tk = torch.from_numpy(pk).to(td)
    tv = torch.from_numpy(pv).to(td)
    got = paged_decode_attention(
        torch.from_numpy(q).to(td), tk[:, layer], tv[:, layer],
        torch.from_numpy(table), torch.from_numpy(lengths)).float().numpy()
    assert got.shape == (SLOTS, H, D)
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=2e-5)
    else:
        atol = 2.0 ** -7 * max(1.0, float(np.abs(ref).max()))
        np.testing.assert_allclose(got, ref, rtol=0, atol=atol)
    assert np.all(got[0] == 0)             # the length-0 slot


def test_four_dim_query_layout_matches():
    """``q [slots, h, 1, d]`` in, ``[slots, h, 1, d]`` out."""
    q, pk, pv, table, lengths = _pool(seed=4)
    args = (torch.from_numpy(pk[:, 1]), torch.from_numpy(pv[:, 1]),
            torch.from_numpy(table), torch.from_numpy(lengths))
    three = paged_decode_attention(torch.from_numpy(q), *args)
    four = paged_decode_attention(torch.from_numpy(q)[:, :, None], *args)
    assert four.shape == (SLOTS, H, 1, D)
    assert torch.equal(four[:, :, 0], three)


def test_bad_operands_raise():
    q, pk, pv, table, lengths = _pool()
    tq = torch.from_numpy(q)
    with pytest.raises(ValueError, match="kv_heads"):
        paged_decode_attention(tq[:, :3], torch.from_numpy(pk[:, 0]),
                               torch.from_numpy(pv[:, 0]),
                               torch.from_numpy(table),
                               torch.from_numpy(lengths))
    with pytest.raises(ValueError, match="q_len == 1"):
        paged_decode_attention(torch.zeros(SLOTS, H, 2, D),
                               torch.from_numpy(pk[:, 0]),
                               torch.from_numpy(pv[:, 0]),
                               torch.from_numpy(table),
                               torch.from_numpy(lengths))


# -- the edge shapes the card kernel's split plan cuts --------------------
#
# Group 8 (one kv head for eight query rows), page 64, a 576-position
# window over 6 slots: the lengths end just before, on and just after
# the first split boundary of the kernel's plan on a 132-SM card (an
# H100), fill the window and run past it (scored as the whole window).
# The same tolerances as above.

EDGE = dict(slots=6, h=8, kvh=1, d=64, ps=64, mpps=9)


def _edge_lengths():
    e = EDGE
    plan = tpa._plan_splits(e["slots"], e["kvh"], e["h"] // e["kvh"],
                            e["d"], e["ps"], e["mpps"], 132)
    assert plan.nsplit > 1
    b = plan.pages_per_split * e["ps"]
    window = e["mpps"] * e["ps"]
    return [0, b - 1, b, b + 1, window, window + 24]


def _edge_pool(seed):
    e = EDGE
    lengths = _edge_lengths()
    rng = np.random.RandomState(seed)
    n_pages = e["slots"] * e["mpps"]
    shape = (n_pages + 1, 2, e["kvh"], e["ps"], e["d"])
    pool_k = rng.randn(*shape).astype(np.float32)
    pool_v = rng.randn(*shape).astype(np.float32)
    table = np.full((e["slots"], e["mpps"]), n_pages, np.int32)
    perm = rng.permutation(n_pages)
    cursor = 0
    for s, n in enumerate(lengths):
        need = min(-(-n // e["ps"]), e["mpps"])
        table[s, :need] = perm[cursor:cursor + need]
        cursor += need
    q = rng.randn(e["slots"], e["h"], e["d"]).astype(np.float32)
    return q, pool_k, pool_v, table, np.asarray(lengths, np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_decode_edge_shapes_match_jax_kernel(dtype):
    q, pk, pv, table, lengths = _edge_pool(seed=7)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    ref = jax_paged(jnp.asarray(q, jd), jnp.asarray(pk[:, 1], jd),
                    jnp.asarray(pv[:, 1], jd), jnp.asarray(table),
                    jnp.asarray(lengths), use_kernel=True)
    ref = np.asarray(ref.astype(jnp.float32))
    got = paged_decode_attention(
        torch.from_numpy(q).to(td), torch.from_numpy(pk).to(td)[:, 1],
        torch.from_numpy(pv).to(td)[:, 1], torch.from_numpy(table),
        torch.from_numpy(lengths)).float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=2e-5)
    else:
        atol = 2.0 ** -7 * max(1.0, float(np.abs(ref).max()))
        np.testing.assert_allclose(got, ref, rtol=0, atol=atol)
    assert np.all(got[0] == 0) and np.isfinite(got).all()


# -- the split plan (host side of the card kernel) ------------------------

PLANS = [
    # slots, kvh, group, d, ps, mpps, sms
    (8, 8, 4, 128, 64, 64, 132),      # the kernels phase and the serve
    (1, 8, 4, 128, 64, 64, 132),
    (64, 8, 4, 128, 64, 64, 132),
    (256, 8, 4, 128, 64, 64, 132),
    (1, 8, 4, 128, 64, 128, 132),     # an 8192-position window
    (8, 8, 4, 128, 16, 512, 132),
    (8, 8, 4, 128, 128, 32, 132),     # page 128
    (6, 2, 8, 64, 16, 44, 132),
    (3, 1, 1, 64, 32, 1, 132),        # a one-page window
    (65535, 1, 2, 64, 16, 3, 132),
    (2, 4, 2, 128, 64, 1000, 16),
    (1, 1, 1, 64, 16, 100000, 132),   # a window past the split cap
]


@pytest.mark.parametrize("slots,kvh,group,d,ps,mpps,sms", PLANS)
def test_split_plan_invariants(slots, kvh, group, d, ps, mpps, sms):
    plan = tpa._plan_splits(slots, kvh, group, d, ps, mpps, sms)
    pps, nsplit = plan.pages_per_split, plan.nsplit
    # whole pages, covering the window with no empty split
    assert isinstance(pps, int) and 1 <= pps <= mpps
    assert (nsplit - 1) * pps < mpps <= nsplit * pps
    assert nsplit <= tpa._MAX_SPLITS
    # no split shorter than the floor unless the window is
    assert pps * ps >= min(tpa._MIN_SPLIT_TOKENS, mpps * ps)
    # the grid the kernel launches, within CUDA's limits
    assert plan.grid == (nsplit, kvh, slots)
    assert nsplit <= 2 ** 31 - 1 and kvh <= 65535 and slots <= 65535
    # scratch sized to the plan: partials per query row and split, one
    # merge counter per (slot, kv head); none with one split
    if nsplit > 1:
        assert plan.part_acc == (slots * kvh * group, nsplit, d)
        assert plan.part_ml == (slots * kvh * group, nsplit, 2)
        assert plan.counters == slots * kvh
    else:
        assert plan.part_acc is None and plan.part_ml is None
        assert plan.counters == 0


def test_split_plan_fills_the_card_when_windows_are_full():
    """At the serve's shape full windows give the blocks an SM the plan
    aims for; with many slots one split a window is enough."""
    plan = tpa._plan_splits(8, 8, 4, 128, 64, 64, 132)
    assert plan.nsplit * 8 * 8 >= tpa._BLOCKS_PER_SM * 132
    assert tpa._plan_splits(256, 8, 4, 128, 64, 64, 132).nsplit == 1


def test_split_plan_takes_no_lengths():
    """The lengths live on the device: planning from them would sync."""
    params = inspect.signature(tpa._plan_splits).parameters
    assert "lengths" not in params
    assert list(params) == ["slots", "kvh", "group", "d", "ps", "mpps",
                            "sms"]


def test_kernel_call_refuses_a_page_size_it_has_no_instance_for():
    slots, h, kvh, d, ps = 2, 4, 2, 64, 8
    q = torch.zeros(slots, h, d, dtype=torch.bfloat16)
    pages = torch.zeros(5, kvh, ps, d, dtype=torch.bfloat16)
    table = torch.zeros(slots, 2, dtype=torch.int32)
    lengths = torch.zeros(slots, dtype=torch.int32)
    with pytest.raises(ValueError, match="page_size"):
        tpa._kernel_call(q, pages, pages, table, lengths, 0.125)


@pytest.mark.parametrize("ps", [1, 2, 4, 8, 16, 32, 64, 128, 256])
def test_kernel_page_sizes_are_checked_by_one_rule(ps):
    """The pool check the card engine runs when it is built is the paged
    route's: every page size has a kernel (the instance's four, the wide
    kernel #7w for the rest), so none is refused; what the instance's
    wrapper refuses, the route sends to #7w."""
    takes = ps in (16, 32, 64, 128)
    tpa.check_kernel_page_size(ps)
    tpa.check_kernel_page_size(ps, group=4, head_dim=64,
                               dtype=torch.float32)
    bf = torch.bfloat16
    assert tpa._paged_route(bf, bf, 4, 64, ps) == (
        "paged_attention" if takes else "paged_attention_wide")
    assert (ps in tpa._KERNEL_PAGE_SIZES) == takes
