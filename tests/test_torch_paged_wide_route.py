"""#7w's mode, on the CPU: the one host predicate
(``paged_attention._wide_paged_tma``) that sends a wide paged-decode
pool to the TMA modes of ``csrc/kv_decode.cuh`` or keeps it on the
CUDA-core kernel of ``csrc/paged_wide.cu``, over every shape class; the
query rows a block (``_wide_rows``); what ``_wide_call`` hands the C
entry in each mode (a stand-in library records the arguments: no card
here); and the split plan of the ``chip_smoke.py`` rows, #7's among
them, as the card runs them (132 SMs).
"""
import ctypes
import importlib

import pytest
import torch

from apex_tpu_torch.ops import _build

# by module name: the package re-exports the function of the same name
pa = importlib.import_module("apex_tpu_torch.ops.paged_attention")

F32, BF16, F16 = torch.float32, torch.bfloat16, torch.float16
_E = {F32: 4, BF16: 2, F16: 2}


def _tma(dtype, d, ps, page_stride=None, ptrs=(0, 256)):
    """The predicate for a two-layer pool of 4 kv heads (page stride two
    layers' [kvh, ps, d] unless given) at 16-byte aligned bases."""
    stride = 2 * 4 * ps * d if page_stride is None else page_stride
    return pa._wide_paged_tma(dtype, d, ps, stride, *ptrs)


@pytest.mark.parametrize("dtype", [BF16, F16])
@pytest.mark.parametrize("d", [8, 64, 80, 96, 128, 200, 256])
@pytest.mark.parametrize("ps", [8, 16, 24, 48, 64, 256])
def test_16bit_rows_of_whole_16_bytes_take_the_tma_modes(dtype, d, ps):
    """fp16 and bf16 pools whose rows are a multiple of 8 elements and
    whose pages are a multiple of 8 rows: the TMA modes, at every head
    dim up to 256 and any such page."""
    assert _tma(dtype, d, ps)


@pytest.mark.parametrize("dtype", [BF16, F16])
@pytest.mark.parametrize("d", [1, 36, 100, 250])
def test_16bit_rows_tma_cannot_box_stay_on_the_cuda_cores(dtype, d):
    assert not _tma(dtype, d, 64)


@pytest.mark.parametrize("d", [4, 64, 80, 96, 128])
@pytest.mark.parametrize("ps", [8, 24, 64, 256])
def test_fp32_rows_up_to_128_take_the_tma_mode(d, ps):
    assert _tma(F32, d, ps)


@pytest.mark.parametrize("d", [1, 98, 126, 132, 160, 256])
def test_fp32_rows_past_128_or_ragged_stay_on_the_cuda_cores(d):
    """fp32 rows with d % 4 != 0 (TMA cannot address them) and fp32
    past head dim 128 (no ring of two stages a warp group fits)."""
    assert not _tma(F32, d, 64)


@pytest.mark.parametrize("dtype", [F32, BF16, F16])
@pytest.mark.parametrize("ps", [1, 4, 12, 20, 100, 130])
def test_pages_that_are_not_whole_boxes_stay_on_the_cuda_cores(dtype, ps):
    """A page size that is not a multiple of 8 rows cannot land as boxes
    on the 128-byte swizzle's period."""
    assert not _tma(dtype, 64, ps)


@pytest.mark.parametrize("dtype", [F32, BF16, F16])
def test_a_page_stride_off_16_bytes_stays_on_the_cuda_cores(dtype):
    e = _E[dtype]
    assert _tma(dtype, 64, 64, page_stride=64 * 64 + 16 // e)
    assert not _tma(dtype, 64, 64, page_stride=64 * 64 + 4 // e)


@pytest.mark.parametrize("dtype", [F32, BF16, F16])
@pytest.mark.parametrize("ptrs", [(8, 256), (0, 264), (4, 4)])
def test_an_unaligned_base_stays_on_the_cuda_cores(dtype, ptrs):
    assert not _tma(dtype, 64, 64, ptrs=ptrs)


@pytest.mark.parametrize("dtype,d,group,rows", [
    (BF16, 64, 1, 8), (BF16, 64, 3, 8), (BF16, 64, 16, 16),
    (BF16, 64, 17, 24), (F16, 64, 32, 32), (F16, 64, 48, 32),
    (BF16, 80, 16, 16), (F16, 128, 12, 16), (BF16, 128, 32, 16),
    (F16, 256, 4, 8), (BF16, 256, 16, 8), (F32, 64, 1, 8),
    (F32, 128, 12, 8)])
def test_rows_a_block_of_the_tma_modes(dtype, d, group, rows):
    """The group in whole n = 8 tiles, at most 32, 16 and 8 rows at the
    head-dim buckets 64, 128 and 256 (16-bit), 8 on an fp32 pool."""
    assert pa._wide_rows(dtype, d, group, True) == rows


@pytest.mark.parametrize("dtype", [F32, BF16, F16])
def test_rows_a_block_of_the_cuda_core_kernel(dtype):
    assert pa._wide_rows(dtype, 100, 3, False) == pa._WIDE_ROWS == 32


class _Recorder:
    """Stands in for the kernel library: records ``apex_paged_wide``'s
    arguments and returns success."""

    def __init__(self):
        self.calls = []

    def apex_paged_wide(self, *args):
        self.calls.append(args)
        return 0


def _wide_case(pool, d, ps, group, query=None, kvh=2, slots=3, mpps=40):
    gen = torch.Generator().manual_seed(d + ps + group)
    pages = slots * mpps + 1
    pool_k = torch.randn(pages, 2, kvh, ps, d, generator=gen).to(pool)
    q = torch.randn(slots, kvh * group, d, generator=gen).to(query or pool)
    table = torch.arange(slots * mpps, dtype=torch.int32).reshape(slots,
                                                                  mpps)
    lengths = torch.tensor([0, 5, mpps * ps], dtype=torch.int32)[:slots]
    return q, pool_k[:, 1], pool_k[:, 0], table, lengths


# argument positions of apex_paged_wide (ops/_build.py's signature)
_COUNTERS, _H, _KVH, _D, _DTYPE, _TMA, _QDT, _PLANES, _ROWS = (
    8, 10, 11, 13, 20, 21, 22, 23, 24)


@pytest.mark.parametrize("pool,query,d,ps,group,tma,qdt,planes,rows", [
    (F16, None, 128, 64, 4, 1, 2, 1, 8),
    (BF16, None, 64, 8, 16, 1, 1, 1, 16),
    (BF16, None, 80, 24, 48, 1, 1, 1, 16),
    (BF16, F32, 128, 64, 4, 1, 0, 2, 8),
    (F16, BF16, 96, 256, 2, 1, 1, 2, 8),
    (F32, None, 128, 64, 1, 1, 0, 1, 8),
    (F32, BF16, 64, 48, 12, 1, 1, 1, 8),
    (BF16, None, 100, 64, 4, 0, 0, 1, 32),
    (F32, None, 256, 64, 2, 0, 0, 1, 32),
    (F16, None, 64, 20, 40, 0, 0, 1, 32)])
def test_the_wrapper_hands_the_entry_the_mode_it_picked(
        monkeypatch, pool, query, d, ps, group, tma, qdt, planes, rows):
    """``_wide_call`` on the predicate's mode: the TMA modes take q and
    the output in q's own type (q planes: 1 where q is of the pool's
    type or the pool fp32, else 2) and the rows a block of
    ``_wide_rows``; the CUDA-core kernel q and the output in fp32 (cast
    back) and 32 rows; the merge counters one a (slot, kv head, row
    chunk); one launch counted."""
    rec = _Recorder()
    monkeypatch.setattr(_build, "library", lambda: rec)
    monkeypatch.setattr(_build, "stream_ptr", lambda dev: ctypes.c_void_p(0))
    monkeypatch.setattr(pa, "_sm_count", lambda dev: 132)
    monkeypatch.setattr(pa, "_COUNTERS", {})
    q, kp, vp, table, lengths = _wide_case(pool, d, ps, group, query)
    before = _build.launch_counts()
    out = pa._wide_call(q, kp, vp, table, lengths, d ** -0.5)
    after = _build.launch_counts()
    assert after["paged_attention_wide"] == \
        before["paged_attention_wide"] + 1
    assert after["paged_attention"] == before["paged_attention"]
    (args,) = rec.calls
    assert (args[_TMA], args[_QDT], args[_PLANES], args[_ROWS]) == (
        tma, qdt, planes, rows)
    assert args[_DTYPE] == {F32: 0, BF16: 1, F16: 2}[pool]
    assert (args[_H], args[_KVH], args[_D]) == (q.shape[1], kp.shape[1], d)
    assert out.dtype == q.dtype and out.shape == q.shape
    plan = pa._plan_splits(q.shape[0], kp.shape[1], group, d, ps,
                           table.shape[1], 132)
    if plan.nsplit > 1:
        (buf,) = pa._COUNTERS.values()
        assert buf.numel() >= plan.counters * -(-group // rows)
        assert args[_COUNTERS] == buf.data_ptr()
    else:
        assert args[_COUNTERS] is None


# (slots, kv heads, group, head dim, page, pages a slot) -> (pages a
# split, splits): #7's kernels-phase shape, and chip_smoke.py's #7w rows
_PLANS = {
    (8, 8, 4, 128, 64, 64): (22, 3),      # #7; the fp16 row at its shape
    (8, 16, 1, 128, 64, 32): (16, 2),     # GPT-3 1.3B fp32 and fp16 pools
    (8, 8, 16, 64, 64, 32): (11, 3),      # group 16
    (8, 32, 1, 80, 64, 32): (32, 1),      # GPT-3 2.7B, head dim 80
    (8, 16, 1, 128, 8, 256): (128, 2),    # page 8
    (8, 16, 1, 128, 256, 8): (4, 2)}      # page 256


@pytest.mark.parametrize("shape", sorted(_PLANS))
def test_split_plans_of_the_card_rows(shape):
    """The wide modes run #7's plan (``tools/paged_wide_probe.py`` found
    no other plan faster on the card): at least one block an SM of the
    H100's 132 when every window is full, a split of at least 512
    positions unless the window is shorter; #7's own plan as it was."""
    slots, kvh, group, d, ps, mpps = shape
    plan = pa._plan_splits(slots, kvh, group, d, ps, mpps, 132)
    assert (plan.pages_per_split, plan.nsplit) == _PLANS[shape]
    assert plan.grid == (plan.nsplit, kvh, slots)
    assert plan.nsplit * kvh * slots >= 132
    assert plan.pages_per_split * ps >= min(512, mpps * ps)
