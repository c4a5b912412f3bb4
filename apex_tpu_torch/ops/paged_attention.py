"""Ragged paged decode attention — one query token per slot against a
paged KV pool.

Port of ``apex_tpu/ops/paged_attention.py :: paged_decode_attention``::

    k_pages, v_pages : [pages, kv_heads, page_size, head_dim]
    page_table       : [slots, max_pages_per_slot]  int32
    lengths          : [slots]                      int32

virtual position ``t`` of a slot resolves to physical page
``page_table[slot, t // page_size]``, row ``t % page_size``.

The call takes the JAX entry's routing arguments.  ``use_kernel=True``,
and ``use_kernel=None`` whatever the window, run a counterpart of the
Pallas ``_paged_kernel`` on CUDA, on the route of :func:`_paged_route`:
``csrc/paged_attention.cu`` for bf16 pools at groups 1/2/4/8, head dims
64/128 and pages of 16 to 128 (counter ``paged_attention``), and #7w
(counter ``paged_attention_wide``) for every other pool up to head dim
256 (fp32, bf16 or fp16; any group, page size and page stride): its TMA
modes (``csrc/kv_decode.cuh``'s template, the wide operand modes) where
:func:`_wide_paged_tma` says, else its CUDA-core kernel
(``csrc/paged_wide.cu``); ``use_kernel=False`` gathers the slots' windows and
scores them through ``decode_attention(use_kernel=False)``, the JAX
package's XLA route, on any device.  The JAX entry's ``None`` applies
its crossover (:func:`paged_xla_max_pages`: ``xla_max_pages`` >
``APEX_TPU_PAGED_XLA_MAX_PAGES`` > 64 pages a slot) on every backend;
here it is read and checked but sends nothing to the gathered route,
since on the H100 the kernel has not been measured against it at short
windows (ROADMAP).  The k/v operands are usually one layer's strided
view of the engine's ``[pages, layers, kv_heads, page_size, head_dim]``
pool; the kernel takes the page stride and reads the pool in place, so
no call copies the pool.  On the kernel route a CPU tensor takes the
kernel's plain version, which gathers the slots' windows and scores
them in fp32 in base 2.

Speculative verify, port of ``paged_slab_attention``: ``S`` drafted
rows per slot against the slot's window, causal within the slab.  The
JAX package gathers the window and scores it in XLA; here that is the
plain version (the CPU's).  On CUDA the slab runs on the paged decode
kernels: row ``r`` of slot ``b`` is a q_len-1 decode of a virtual slot
with ``b``'s page-table row and ``lengths[b] + r + 1`` live tokens (0
past the window), so ``slots * S`` virtual slots go through one call of
:func:`paged_decode_attention`'s route, with no gather.

Fused-block decode, port of ``fused_block_decode`` and its dispatch
knobs (``decode_fusion``, ``fusion_min_pages``,
``resolve_decode_fusion``): a whole decoder layer for every slot as one
launch of ``csrc/fused_block_decode.cu`` (the counterpart of the Pallas
``_fused_block_kernel``).  ``kind="llama"``: RMSNorm, q/k/v, RoPE,
paged attention with the current token folded in, o-proj, RMSNorm,
SwiGLU (launch counter ``fused_block_decode``).  ``kind="gpt"``:
LayerNorm with bias, biased q/k/v, no RoPE, the same attention, biased
o-proj, LayerNorm, ``gelu(h2 @ wu + bu) @ wd + bd`` with GELU in the
tanh approximation (counter ``fused_block_decode_gpt``).  With
``partial_out=True`` (a tensor-parallel rank's shard; ``fuse_mlp=False``)
each instance stores the rank-partial out-projection alone, no residual
and no bias, from entries of its own (counters
``fused_block_decode_partial``, ``fused_block_decode_gpt_partial``).
"""
from __future__ import annotations

import ctypes
import functools
import os
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from apex_tpu_torch.ops import _build
from apex_tpu_torch.ops.attention import (_LOG2E, _NEG_INF, _WIDE_DTYPES,
                                          _WIDE_MAX_HEAD_DIM, _int_knob)

__all__ = ["paged_decode_attention", "paged_decode_reference",
           "paged_xla_max_pages", "paged_slab_attention",
           "check_kernel_page_size", "decode_fusion", "fusion_min_pages",
           "resolve_decode_fusion", "fused_block_decode",
           "fused_block_reference"]

#: query rows per kv head, head dims and page sizes the kernel is
#: instantiated for
_KERNEL_GROUPS = (1, 2, 4, 8)
_KERNEL_HEAD_DIMS = (64, 128)
_KERNEL_PAGE_SIZES = (16, 32, 64, 128)
#: query rows a block of #7w's CUDA-core kernel takes: a group past it
#: runs as several row chunks
_WIDE_ROWS = 32
#: the most query rows a block of #7w's TMA modes takes on a 16-bit pool,
#: by head-dim bucket (rows x bucket <= 2048: a warp's accumulator in 64
#: registers a thread), and on an fp32 pool
_WIDE_TMA_ROWS = {64: 32, 128: 16, 256: 8}
_WIDE_TMA_F32_ROWS = 8
#: the largest head dim of #7w's fp32 TMA mode (past it, two stages a
#: warp group of eight warps' 8-row tiles would take 256 KB of shared
#: memory)
_WIDE_TMA_F32_MAX_HEAD_DIM = 128
#: the fewest window positions a split covers: a shorter split ends
#: before the kernel's ring of pages fills
_MIN_SPLIT_TOKENS = 512
#: blocks per SM the split plan aims for when every window is full (at
#: page 64 and head dim 128 a block's 128 KB ring leaves no room for a
#: second)
_BLOCKS_PER_SM = 1
#: the most splits a window runs as (the merging block holds each
#: split's weights in shared memory)
_MAX_SPLITS = 256
#: the JAX entry's paged-decode crossover in pages a slot, and its
#: environment override (read and checked here, not applied)
_PAGED_XLA_MAX_PAGES = 64
_PAGED_XLA_MAX_PAGES_ENV = "APEX_TPU_PAGED_XLA_MAX_PAGES"


def _paged_route(q_dtype, pool_dtype, group: int, d: int, ps: int,
                 page_stride: Optional[int] = None, ptrs=()) -> str:
    """The kernel a paged decode call takes: ``"paged_attention"``, the
    mma instance (bf16 query and pool, groups 1/2/4/8, head dims 64/128,
    pages of 16 to 128, and a view it can read: a page stride that is a
    multiple of 8 elements and 16-byte aligned bases ``ptrs``), or
    ``"paged_attention_wide"`` (#7w) for every other pool: fp32, bf16 or
    fp16, any group, page size and layout, head dims up to 256, on the
    mode :func:`_wide_paged_tma` picks.  ``page_stride=None`` asks for
    the engine's own pool, which is aligned.  Past 256 raises (ROADMAP
    V9), as does a page size below 1."""
    if ps < 1:
        raise ValueError(f"page_size must be positive, got {ps}")
    if not 1 <= d <= _WIDE_MAX_HEAD_DIM:
        raise ValueError(
            f"paged attention kernels take head_dim 1..{_WIDE_MAX_HEAD_DIM}, "
            f"got {d}: head dims past {_WIDE_MAX_HEAD_DIM} are ROADMAP V9")
    readable = (page_stride is None or page_stride % 8 == 0) \
        and all(p % 16 == 0 for p in ptrs)
    if q_dtype == pool_dtype == torch.bfloat16 and group in _KERNEL_GROUPS \
            and d in _KERNEL_HEAD_DIMS and ps in _KERNEL_PAGE_SIZES \
            and readable:
        return "paged_attention"
    return "paged_attention_wide"


def _wide_paged_tma(pool_dtype, d: int, ps: int, page_stride: int,
                    *ptrs: int) -> bool:
    """Whether #7w runs a pool on its TMA modes (the wide operand modes
    of ``csrc/kv_decode.cuh :: paged_decode_kernel``), the one place that
    decides (the C entry runs what it is told): TMA boxes must address
    the pool's rows and pages, so a row (``d`` elements) and the page
    stride are multiples of 16 bytes, the bases (``ptrs``) 16-byte
    aligned, and a page a multiple of 8 rows (the boxes' row count, so
    that each lands on the 128-byte swizzle's period); fp32 pools up to
    head dim 128.  Every other pool runs the CUDA-core kernel
    (``csrc/paged_wide.cu``)."""
    e = pool_dtype.itemsize
    if pool_dtype == torch.float32 and d > _WIDE_TMA_F32_MAX_HEAD_DIM:
        return False
    return (d * e % 16 == 0 and ps % 8 == 0 and page_stride * e % 16 == 0
            and all(p % 16 == 0 for p in ptrs))


def _wide_rows(pool_dtype, d: int, group: int, tma: bool) -> int:
    """Query rows a block of #7w takes: 32 on the CUDA-core kernel; on
    the TMA modes the group rounded up to whole n = 8 tiles, at most
    :data:`_WIDE_TMA_ROWS` of the head-dim bucket (16-bit) or 8 (fp32).
    A group past it runs as row chunks, each reading the pages."""
    if not tma:
        return _WIDE_ROWS
    if pool_dtype == torch.float32:
        return _WIDE_TMA_F32_ROWS
    cap = _WIDE_TMA_ROWS[64 if d <= 64 else 128 if d <= 128 else 256]
    return min(cap, 8 * -(-group // 8))


def check_kernel_page_size(page_size: int, *, group: int = 1,
                           head_dim: int = 64,
                           dtype=torch.bfloat16) -> None:
    """Raise unless a paged kernel takes the pool (``page_size``, the
    query ``group``, ``head_dim``, the pool's ``dtype``): an engine on
    the card checks its pool once, when it is built, not at its first
    decode step.  With the wide kernel, every page size, group and
    float type is taken up to head dim 256 (:func:`_paged_route`)."""
    _paged_route(dtype, dtype, group, head_dim, page_size)


class SplitPlan(NamedTuple):
    """How one call runs the window: ``nsplit`` splits of
    ``pages_per_split`` whole pages, one block per (split, kv head,
    slot); with more than one split, fp32 partials of the shapes given
    and one merge counter per (slot, kv head)."""
    pages_per_split: int
    nsplit: int
    grid: Tuple[int, int, int]
    part_acc: Optional[Tuple[int, int, int]]
    part_ml: Optional[Tuple[int, int, int]]
    counters: int


@functools.lru_cache(maxsize=64)
def _plan_splits(slots: int, kvh: int, group: int, d: int, ps: int,
                 mpps: int, sms: int) -> SplitPlan:
    """Split the window over blocks from what the host knows (window,
    slots, kv heads, group, head dim, SM count): enough splits that the
    (slot, kv head) pairs fill ``_BLOCKS_PER_SM`` blocks an SM if every
    window were full, none shorter than ``_MIN_SPLIT_TOKENS``.  The
    lengths live on the device and are not read (reading them would
    put a sync into every decode step); the kernel skips what is past
    each slot's length."""
    if min(slots, kvh, group, d, ps, mpps, sms) < 1:
        raise ValueError("the split plan needs positive sizes")
    want = -(-(_BLOCKS_PER_SM * sms) // (slots * kvh))
    pps = max(-(-_MIN_SPLIT_TOKENS // ps), -(-mpps // want),
              -(-mpps // _MAX_SPLITS))
    pps = min(pps, mpps)
    nsplit = -(-mpps // pps)
    rows = slots * kvh * group
    many = nsplit > 1
    return SplitPlan(pps, nsplit, (nsplit, kvh, slots),
                     (rows, nsplit, d) if many else None,
                     (rows, nsplit, 2) if many else None,
                     slots * kvh if many else 0)


#: the SM count of each device, and the merge counters of each (device,
#: stream): zero between launches (the kernel's merging block resets
#: its own), so launches on one stream, which run in order, share them
_SMS: dict = {}
_COUNTERS: dict = {}


def _sm_count(device) -> int:
    if device not in _SMS:
        _SMS[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _SMS[device]


def _counters(device, stream, n: int):
    key = (device, stream.value)
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 256), dtype=torch.int32, device=device)
        _COUNTERS[key] = buf
    return buf


def _check_operands(q3, k_pages, v_pages, page_table, lengths):
    slots, h, d = q3.shape
    if k_pages.shape != v_pages.shape or k_pages.dim() != 4 \
            or k_pages.shape[3] != d:
        raise ValueError(
            f"k/v pages must be [pages, kv_heads, page_size, {d}] and "
            f"equal-shaped; got k {tuple(k_pages.shape)} v "
            f"{tuple(v_pages.shape)}")
    kvh = k_pages.shape[1]
    if kvh == 0 or h % kvh:
        raise ValueError(f"kv_heads ({kvh}) must divide query heads ({h})")
    if page_table.dim() != 2 or page_table.shape[0] != slots:
        raise ValueError(
            f"page_table must be [{slots}, max_pages_per_slot], got "
            f"{tuple(page_table.shape)}")
    if lengths.shape != (slots,):
        raise ValueError(
            f"lengths must be [{slots}], got {tuple(lengths.shape)}")


def _window(pages, page_table):
    """Each slot's virtual window gathered from one layer's pool
    ``[pages, kvh, ps, d]`` through ``page_table [slots, mpps]``:
    ``[slots, kvh, mpps * ps, d]``, position for position the dense
    cache's layout."""
    slots, mpps = page_table.shape
    _, kvh, ps, d = pages.shape
    g = pages[page_table.long()]                  # [slots, mpps, kvh, ps, d]
    return g.permute(0, 2, 1, 3, 4).reshape(slots, kvh, mpps * ps, d)


def paged_decode_reference(q3, k_pages, v_pages, page_table, lengths,
                           scale: float):
    """Plain version: gather each slot's virtual window and score it
    (fp32, base-2 softmax; p rounded to the value dtype for P·V, the
    normalizer from the fp32 p).  ``q3 [slots, h, d]``."""
    slots, h, d = q3.shape
    kvh = k_pages.shape[1]
    kw, vw = _window(k_pages, page_table), _window(v_pages, page_table)
    qg = q3.reshape(slots, kvh, h // kvh, d).float()
    s = torch.einsum("bkgd,bkwd->bkgw", qg, kw.float()) * (scale * _LOG2E)
    live = (torch.arange(kw.shape[2], device=q3.device)[None, :]
            < lengths.long()[:, None])[:, None, None, :]
    s = torch.where(live, s, torch.full_like(s, _NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(live, torch.exp2(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgw,bkwd->bkgd", p.to(vw.dtype).float(),
                       vw.float())
    out = out / torch.where(l == 0, torch.ones_like(l), l)
    return out.reshape(slots, h, d).to(q3.dtype)


def _gathered_decode(q3, k_pages, v_pages, page_table, lengths, scale):
    """The JAX entry's ``use_kernel=False`` route: the slots' virtual
    windows gathered from the pool (``[slots, kvh, mpps * ps, d]``) and
    scored by ``decode_attention``'s plain grouped chain."""
    from apex_tpu_torch.ops.attention import decode_attention
    return decode_attention(q3, _window(k_pages, page_table),
                            _window(v_pages, page_table), lengths,
                            sm_scale=scale, use_kernel=False)


def _check_pool_view(q3, k_pages, v_pages, page_table, lengths):
    """What both paged kernels take of the operands' layout: int32
    ``page_table`` and ``lengths`` on q's device, contiguous q, table and
    lengths, a pool view with heads and rows contiguous inside a page and
    any page stride (one layer of the ``[pages, layers, ...]`` pool),
    at most 65535 slots and a nonempty window."""
    slots, _, d = q3.shape
    ps = k_pages.shape[2]
    if page_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("page_table and lengths must be int32")
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages),
                    ("page_table", page_table), ("lengths", lengths)):
        if t.device != q3.device:
            raise ValueError(f"{name} is on {t.device}, q on {q3.device}")
    if not (q3.is_contiguous() and page_table.is_contiguous()
            and lengths.is_contiguous()):
        raise ValueError("q, page_table and lengths must be contiguous")
    inner = (ps * d, d, 1)
    if k_pages.stride()[1:] != inner or v_pages.stride() != k_pages.stride():
        raise ValueError(
            f"k/v pages must have inner strides {inner} and equal strides; "
            f"got k {k_pages.stride()} v {v_pages.stride()}")
    if slots > 65535:
        raise ValueError(f"{slots} slots exceed the kernel grid (65535)")
    if page_table.shape[1] == 0:
        raise ValueError("page_table has no columns: the window is empty")


def _kernel_call(q3, k_pages, v_pages, page_table, lengths, scale):
    slots, h, d = q3.shape
    _, kvh, ps, _ = k_pages.shape
    mpps = page_table.shape[1]
    if q3.dtype != torch.bfloat16 or k_pages.dtype != torch.bfloat16 \
            or v_pages.dtype != torch.bfloat16:
        raise TypeError(f"paged attention kernel takes bfloat16 q/k/v, got "
                        f"{q3.dtype}/{k_pages.dtype}/{v_pages.dtype}")
    _check_pool_view(q3, k_pages, v_pages, page_table, lengths)
    if h // kvh not in _KERNEL_GROUPS or d not in _KERNEL_HEAD_DIMS \
            or ps not in _KERNEL_PAGE_SIZES:
        raise ValueError(
            f"paged attention kernel takes group (h / kv_heads) in "
            f"{_KERNEL_GROUPS}, head_dim in {_KERNEL_HEAD_DIMS} and "
            f"page_size in {_KERNEL_PAGE_SIZES}, got group {h // kvh}, "
            f"head_dim {d}, page_size {ps}")
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16 \
            or k_pages.stride(0) % 8:
        raise ValueError("k/v pages must be 16-byte aligned with a page "
                         "stride that is a multiple of 8 elements")
    # split the window over blocks (flash-decoding); the last block of
    # each (slot, kv head) to finish merges its splits' partial states
    plan = _plan_splits(slots, kvh, h // kvh, d, ps, mpps,
                        _sm_count(q3.device))
    out = torch.empty_like(q3)
    f32 = dict(dtype=torch.float32, device=q3.device)
    part_acc = torch.empty(plan.part_acc, **f32) if plan.part_acc else None
    part_ml = torch.empty(plan.part_ml, **f32) if plan.part_ml else None
    stream = _build.stream_ptr(q3.device)
    counters = _counters(q3.device, stream, plan.counters) \
        if plan.counters else None
    lib = _build.library()
    _build.count("paged_attention")
    err = lib.apex_paged_decode_attention(
        q3.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        part_acc.data_ptr() if part_acc is not None else None,
        part_ml.data_ptr() if part_ml is not None else None,
        counters.data_ptr() if counters is not None else None, slots, h,
        kvh, ps, d, mpps, k_pages.shape[0], k_pages.stride(0), plan.nsplit,
        plan.pages_per_split, float(scale * _LOG2E), stream)
    if err and counters is not None:
        counters.zero_()      # whatever a failed launch left behind
    _build.check(err, "paged_attention")
    return out


def _wide_call(q3, k_pages, v_pages, page_table, lengths, scale):
    """#7w, the wide paged decode (entry ``csrc/paged_wide.cu``, counter
    ``paged_attention_wide``): any float query against an fp32, bf16 or
    fp16 pool at any group, page size and page stride, head_dim 1..256,
    on the mode :func:`_wide_paged_tma` names.  The TMA modes read q in
    its own type (an fp32 or fp16 query against another 16-bit pool as
    two planes of the pool's type) and write the output in it; the
    CUDA-core kernel reads q in fp32 and its fp32 output is cast back.
    The window runs as :func:`_plan_splits`' splits; a group past
    :func:`_wide_rows` as several row chunks, each with its own merge
    counter."""
    slots, h, d = q3.shape
    _, kvh, ps, _ = k_pages.shape
    mpps = page_table.shape[1]
    if k_pages.dtype not in _WIDE_DTYPES or v_pages.dtype != k_pages.dtype:
        raise TypeError(f"wide paged kernel takes an fp32, bf16 or fp16 "
                        f"pool of one type, got {k_pages.dtype}/"
                        f"{v_pages.dtype}")
    if not q3.is_floating_point():
        raise TypeError(f"q must be a float tensor, got {q3.dtype}")
    _check_pool_view(q3, k_pages, v_pages, page_table, lengths)
    group = h // kvh
    tma = _wide_paged_tma(k_pages.dtype, d, ps, k_pages.stride(0),
                          k_pages.data_ptr(), v_pages.data_ptr())
    rows = _wide_rows(k_pages.dtype, d, group, tma)
    plan = _plan_splits(slots, kvh, group, d, ps, mpps, _sm_count(q3.device))
    own = tma and q3.dtype in _WIDE_DTYPES    # q and out in q's own type
    qk = q3 if own else q3.float().contiguous()
    # a 16-bit pool's TMA mode takes another type's q as two planes
    planes = 2 if tma and k_pages.dtype != torch.float32 \
        and qk.dtype != k_pages.dtype else 1
    out = torch.empty(q3.shape, dtype=qk.dtype, device=q3.device)
    f32 = dict(dtype=torch.float32, device=q3.device)
    part_acc = torch.empty(plan.part_acc, **f32) if plan.part_acc else None
    part_ml = torch.empty(plan.part_ml, **f32) if plan.part_ml else None
    stream = _build.stream_ptr(q3.device)
    counters = _counters(q3.device, stream, plan.counters * -(
        -group // rows)) if plan.counters else None
    lib = _build.library()
    _build.count("paged_attention_wide")
    err = lib.apex_paged_wide(
        qk.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        part_acc.data_ptr() if part_acc is not None else None,
        part_ml.data_ptr() if part_ml is not None else None,
        counters.data_ptr() if counters is not None else None, slots, h,
        kvh, ps, d, mpps, k_pages.shape[0], k_pages.stride(0), plan.nsplit,
        plan.pages_per_split, float(scale * _LOG2E),
        _WIDE_DTYPES[k_pages.dtype], int(tma), _WIDE_DTYPES[qk.dtype],
        planes, rows, stream)
    if err and counters is not None:
        counters.zero_()      # whatever a failed launch left behind
    _build.check(err, "paged_attention_wide")
    return out.to(q3.dtype)


def paged_xla_max_pages(override=None) -> int:
    """The JAX entry's paged-decode crossover, in pages a slot: explicit
    override > ``APEX_TPU_PAGED_XLA_MAX_PAGES`` > 64."""
    return _int_knob(override, _PAGED_XLA_MAX_PAGES_ENV, _PAGED_XLA_MAX_PAGES)


def paged_decode_attention(q, k_pages, v_pages, page_table, lengths, *,
                           sm_scale: Optional[float] = None,
                           use_kernel: Optional[bool] = None,
                           xla_max_pages: Optional[int] = None):
    """Single-token attention against a paged KV pool.

    * ``q``: ``[slots, h, 1, d]`` (or ``[slots, h, d]``).
    * ``k_pages``/``v_pages``: ``[pages, kv_heads, page_size, d]`` —
      one layer's (possibly strided) slice of the pool, ``kv_heads``
      dividing ``h``.
    * ``page_table``: ``[slots, max_pages_per_slot]`` int32; dead
      entries may hold any valid page (the trash page by convention).
    * ``lengths``: ``[slots]`` int32 live tokens; length 0 emits zeros.

    ``use_kernel=False`` gathers the windows and scores them through
    ``decode_attention(use_kernel=False)`` (the JAX package's XLA
    route) on any device.  ``use_kernel=True`` or ``None``: on CUDA the
    kernel :func:`_paged_route` names (the instance, or #7w for every
    other pool up to head dim 256), on the CPU their plain version.  Unlike the JAX entry,
    ``None`` keeps the kernel on CUDA whatever the window: the
    crossover (:func:`paged_xla_max_pages`, ``xla_max_pages`` first) is
    read and checked, not applied (module docstring)."""
    squeezed = q.dim() == 3
    q3 = q if squeezed else q[:, :, 0, :]
    if not squeezed and q.shape[2] != 1:
        raise ValueError(
            f"paged_decode_attention is the q_len == 1 path, got q_len "
            f"{q.shape[2]}; use flash_attention for prefill")
    _check_operands(q3, k_pages, v_pages, page_table, lengths)
    d = q3.shape[-1]
    scale = (d ** -0.5) if sm_scale is None else sm_scale
    if use_kernel is None:
        paged_xla_max_pages(xla_max_pages)
        use_kernel = True
    if not use_kernel:
        out = _gathered_decode(q3, k_pages, v_pages, page_table, lengths,
                               scale)
    elif q3.device.type == "cpu":
        out = paged_decode_reference(q3, k_pages, v_pages, page_table,
                                     lengths, scale)
    elif q3.device.type == "cuda":
        route = _paged_route(q3.dtype, k_pages.dtype,
                             q3.shape[1] // k_pages.shape[1], d,
                             k_pages.shape[2], k_pages.stride(0),
                             (k_pages.data_ptr(), v_pages.data_ptr()))
        call = _kernel_call if route == "paged_attention" else _wide_call
        out = call(q3.contiguous(), k_pages, v_pages, page_table, lengths,
                   scale)
    else:
        raise ValueError(f"paged_decode_attention runs on cuda or cpu, got "
                         f"{q3.device}")
    return out if squeezed else out[:, :, None, :]


def paged_slab_reference(q, k_pages, v_pages, page_table, lengths,
                         scale: float):
    """Plain version of :func:`paged_slab_attention`, the JAX package's
    function: each slot's virtual window gathered from the pool
    (``[slots, kv_heads, max_pages_per_slot * page_size, d]``) and scored
    by :func:`~apex_tpu_torch.ops.attention.slab_decode_attention`."""
    from apex_tpu_torch.ops.attention import slab_decode_attention
    return slab_decode_attention(q, _window(k_pages, page_table),
                                 _window(v_pages, page_table), lengths,
                                 sm_scale=scale)


def _slab_fold(q, page_table, lengths, window: int):
    """The slab as ``slots * S`` virtual slots of a q_len-1 decode: q
    ``[slots * S, h, d]`` (row ``r`` of slot ``b`` at ``b * S + r``),
    each slot's page-table row repeated ``S`` times, and the lengths
    ``lengths[b] + r + 1``, or 0 for a row past the ``window`` (computed
    on the device: no host read)."""
    slots, h, sq, d = q.shape
    q3 = q.transpose(1, 2).reshape(slots * sq, h, d).contiguous()
    table = page_table.repeat_interleave(sq, dim=0)
    pos = lengths.to(torch.int32)[:, None] + torch.arange(
        sq, dtype=torch.int32, device=q.device)[None]
    live = torch.where(pos < window, pos + 1, torch.zeros_like(pos))
    return q3, table, live.reshape(-1).contiguous()


def paged_slab_attention(q, k_pages, v_pages, page_table, lengths, *,
                         sm_scale: Optional[float] = None):
    """Speculative-verify attention against the paged pool: ``S``
    drafted tokens per slot, already appended at positions ``[lengths,
    lengths + S)``, score the slot's virtual window, causally within the
    slab.

    * ``q``: ``[slots, h, S, d]``.
    * ``k_pages``/``v_pages``: ``[pages, kv_heads, page_size, d]``, one
      layer's (possibly strided) view of the pool.
    * ``page_table``: ``[slots, max_pages_per_slot]`` int32.
    * ``lengths``: ``[slots]`` int32, live tokens before the slab.

    Returns ``[slots, h, S, d]``; a row past the window emits 0.  On the
    CPU the plain version (:func:`paged_slab_reference`).  On CUDA the
    slab folds into ``slots * S`` virtual slots of a q_len-1 decode
    (:func:`_slab_fold`) and runs as one call of the paged decode
    kernel :func:`_paged_route` names (#7, or #7w for every other pool),
    which launches or raises: ``slots * S`` is limited to the kernels'
    65535 slots."""
    slots, h, sq, d = q.shape
    _check_operands(q[:, :, 0], k_pages, v_pages, page_table, lengths)
    scale = (d ** -0.5) if sm_scale is None else sm_scale
    if q.device.type == "cpu":
        return paged_slab_reference(q, k_pages, v_pages, page_table, lengths,
                                    scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_slab_attention runs on cuda or cpu, got "
                         f"{q.device}")
    q3, table, live = _slab_fold(q, page_table, lengths,
                                 page_table.shape[1] * k_pages.shape[2])
    out = paged_decode_attention(q3, k_pages, v_pages, table, live,
                                 sm_scale=scale, use_kernel=True)
    return out.reshape(slots, sq, h, d).transpose(1, 2)


# --------------------------------------------------------------------------
# fused-block decode
# --------------------------------------------------------------------------

_DECODE_FUSION_ENV = "APEX_TPU_DECODE_FUSION"
#: fused/unfused crossover in pages per slot for ``"auto"``; override
#: with ``APEX_TPU_FUSION_MIN_PAGES`` (the JAX package's default)
_FUSION_MIN_PAGES = 8
_FUSION_MIN_PAGES_ENV = "APEX_TPU_FUSION_MIN_PAGES"


def decode_fusion(override=None) -> str:
    """Effective fused-block decode mode: explicit override >
    ``APEX_TPU_DECODE_FUSION`` > ``"0"``.  ``"0"`` is the per-op path,
    ``"1"`` the fused-block kernel, ``"auto"`` fuses when the engine's
    window is at least :func:`fusion_min_pages` pages."""
    val = override if override is not None \
        else (os.environ.get(_DECODE_FUSION_ENV) or "0")
    val = str(val).strip().lower() or "0"
    if val in ("0", "false", "off"):
        return "0"
    if val in ("1", "true", "on"):
        return "1"
    if val == "auto":
        return "auto"
    raise ValueError(
        f"{_DECODE_FUSION_ENV} must be 0, 1 or auto, got {val!r}")


def fusion_min_pages(override=None) -> int:
    """Effective auto-fusion crossover: explicit override >
    ``APEX_TPU_FUSION_MIN_PAGES`` > 8."""
    return _int_knob(override, _FUSION_MIN_PAGES_ENV, _FUSION_MIN_PAGES)


def resolve_decode_fusion(mode=None, *, paged: bool,
                          max_pages: Optional[int] = None,
                          min_pages: Optional[int] = None) -> bool:
    """Does this engine run the fused-block decode kernel?  The kernel
    reads the slot's pages through the page table, so ``"1"`` on a
    non-paged engine is a configuration error, while ``"auto"`` there
    resolves to the unfused path."""
    mode = decode_fusion(mode)
    if mode == "0":
        return False
    if not paged:
        if mode == "1":
            raise ValueError(
                "fused-block decode streams the slot's KV pages via "
                "the page table (APEX_TPU_DECODE_FUSION=1 needs a "
                "paged engine); this engine runs the dense slot cache")
        return False
    if mode == "1":
        return True
    return int(max_pages or 0) >= fusion_min_pages(min_pages)


def _fused_geometry(x, blk, k_pages, v_pages, page_table, lengths, kind,
                    cos, sin, partial_out, fuse_mlp=True):
    """The JAX checks; returns ``(kvh, ps, d, h)``."""
    if kind not in ("gpt", "llama"):
        raise ValueError(f"unknown block kind {kind!r}")
    if partial_out and fuse_mlp:
        raise ValueError(
            "partial_out emits the pre-psum attention shard; the MLP "
            "runs after the row-boundary reduction (fuse_mlp=False)")
    slots = x.shape[0]
    if k_pages.shape != v_pages.shape or k_pages.dim() != 4:
        raise ValueError(
            f"k/v pages must be [pages, kv_heads, page_size, d] and "
            f"equal-shaped; got k {tuple(k_pages.shape)} v "
            f"{tuple(v_pages.shape)}")
    _, kvh, ps, d = k_pages.shape
    hd = blk["wq"].shape[1]
    if hd % d:
        raise ValueError(f"wq width {hd} must be a multiple of head_dim {d}")
    h = hd // d
    if h % kvh:
        raise ValueError(f"kv_heads ({kvh}) must divide query heads ({h})")
    if page_table.dim() != 2 or page_table.shape[0] != slots \
            or tuple(lengths.shape) != (slots,):
        raise ValueError(
            f"page_table/lengths must cover {slots} slots; got "
            f"{tuple(page_table.shape)} / {tuple(lengths.shape)}")
    if kind == "llama" and (cos is None or sin is None):
        raise ValueError("llama fused block needs cos/sin RoPE rows")
    return kvh, ps, d, h


def fused_block_reference(x, blk, k_pages, v_pages, page_table, lengths, *,
                          kind: str, eps: float, cos=None, sin=None,
                          sm_scale: Optional[float] = None,
                          fuse_mlp: bool = True, partial_out: bool = False):
    """Plain version of :func:`fused_block_decode`, with the kernel's
    rounding points: fp32 norms and residual, bf16 matmul operands with
    fp32 sums (GPT: the fp32 bias added to each product), fp32 RoPE
    (LLaMA), scores from the rounded q over the gathered window in base
    2, p rounded for P.V (normaliser from fp32 p), then the current
    token folded in as one more column from the unrounded fp32 q, k,
    v.  ``partial_out``: ``y`` is ``ctx @ wo`` alone (no residual, no
    ``bo``), rounded to x's type."""
    kvh, ps, d, h = _fused_geometry(x, blk, k_pages, v_pages, page_table,
                                    lengths, kind, cos, sin, partial_out,
                                    fuse_mlp)
    gpt = kind == "gpt"
    slots = x.shape[0]
    group = h // kvh
    mpps = page_table.shape[1]
    scale = (d ** -0.5) if sm_scale is None else sm_scale
    f32 = torch.float32

    def norm(v, w, b=None):
        w = w.reshape(1, -1).to(f32)
        if gpt:
            mu = v.mean(dim=1, keepdim=True)
            var = ((v - mu) ** 2).mean(dim=1, keepdim=True)
            return (v - mu) * torch.rsqrt(var + eps) * w \
                + b.reshape(1, -1).to(f32)
        ms = (v * v).mean(dim=1, keepdim=True)
        return v * torch.rsqrt(ms + eps) * w

    def matmul(a, w, b=None):
        y = torch.matmul(a.to(w.dtype).to(f32), w.to(f32))
        return y if b is None else y + b.reshape(1, -1).to(f32)

    def bias(name):
        return blk[name] if gpt else None

    def rope(t):                                  # t [slots, n, d]
        c = cos.to(f32)[:, None, :]
        s = sin.to(f32)[:, None, :]
        t1, t2 = torch.chunk(t, 2, dim=-1)
        return t * c + torch.cat((-t2, t1), dim=-1) * s

    xv = x.to(f32)
    h1 = norm(xv, blk["ln1_w"], bias("ln1_b"))
    q = matmul(h1, blk["wq"], bias("bq")).reshape(slots, h, d)
    k_new = matmul(h1, blk["wk"], bias("bk")).reshape(slots, kvh, d)
    v_new = matmul(h1, blk["wv"], bias("bv")).reshape(slots, kvh, d)
    if not gpt:
        q, k_new = rope(q), rope(k_new)

    # the live pages, as the unfused path's plain version gathers them
    idx = page_table.long()
    kw = k_pages[idx].permute(0, 2, 1, 3, 4).reshape(slots, kvh, mpps * ps, d)
    vw = v_pages[idx].permute(0, 2, 1, 3, 4).reshape(slots, kvh, mpps * ps, d)
    qg = q.reshape(slots, kvh, group, d)
    s = torch.einsum("bkgd,bkwd->bkgw", qg.to(k_pages.dtype).to(f32),
                     kw.to(f32)) * (scale * _LOG2E)
    live = (torch.arange(mpps * ps, device=x.device)[None, :]
            < lengths.long()[:, None])[:, None, None, :]
    s = torch.where(live, s, torch.full_like(s, _NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(live, torch.exp2(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bkgw,bkwd->bkgd", p.to(v_pages.dtype).to(f32),
                       vw.to(f32))
    # the current token: one more column, from the fp32 q, k, v
    s_new = (qg * k_new[:, :, None, :]).sum(-1, keepdim=True) \
        * (scale * _LOG2E)
    m_new = torch.maximum(m, s_new)
    alpha = torch.exp2(m - m_new)
    p_new = torch.exp2(s_new - m_new)
    l = l * alpha + p_new
    acc = acc * alpha + p_new * v_new[:, :, None, :]
    ctx = (acc / l).reshape(slots, h * d)

    if partial_out:
        return (matmul(ctx, blk["wo"]).to(x.dtype), k_new.to(x.dtype),
                v_new.to(x.dtype))
    x2 = xv + matmul(ctx, blk["wo"], bias("bo"))
    if fuse_mlp and gpt:
        h2 = norm(x2, blk["ln2_w"], blk["ln2_b"])
        act = F.gelu(matmul(h2, blk["wu"], blk["bu"]), approximate="tanh")
        y = x2 + matmul(act, blk["wd"], blk["bd"])
    elif fuse_mlp:
        h2 = norm(x2, blk["ln2_w"])
        act = F.silu(matmul(h2, blk["wg"])) * matmul(h2, blk["wu"])
        y = x2 + matmul(act, blk["wd"])
    else:
        y = x2
    return (y.to(x.dtype), k_new.to(x.dtype), v_new.to(x.dtype))


#: workspace bytes of each launch geometry, asked of the library once
_WS_BYTES: dict = {}


def _fused_kernel_call(x, blk, k_pages, v_pages, page_table, lengths, cos,
                       sin, eps, scale, fuse_mlp, kvh, ps, d, h, clock=None,
                       kind="llama", partial_out=False):
    """Launch the kernel (``partial_out``: the rank-partial entry,
    ``csrc/fused_block_partial.cu``, which takes no MLP and, GPT, no
    ``bo``).  ``clock``: ``None``, or a zeroed int64 CUDA tensor of 9
    that receives the launch's phase times in ns: the whole layer's
    start, the end of each of its 7 phases that end in a grid barrier,
    and the last block's end; the rank-partial kernel's start, the last
    end of each of its item classes (norm1 statistics, q/k/v, attention,
    o) and the last block's end in its first 6."""
    gpt = kind == "gpt"
    slots, hidden = x.shape
    bf = torch.bfloat16
    mlp_w = (["wu", "wd"] if gpt else ["wg", "wu", "wd"]) if fuse_mlp \
        else []
    names = ["wq", "wk", "wv", "wo"] + mlp_w
    ffn = blk["wu"].shape[1] if fuse_mlp else 0
    shapes = {"wq": (hidden, h * d), "wk": (hidden, kvh * d),
              "wv": (hidden, kvh * d), "wo": (h * d, hidden),
              "wg": (hidden, ffn), "wu": (hidden, ffn), "wd": (ffn, hidden)}
    if x.dtype != bf or k_pages.dtype != bf or v_pages.dtype != bf \
            or any(blk[n].dtype != bf for n in names):
        raise TypeError(
            f"fused block kernel takes bfloat16 x, weights and pool, got x "
            f"{x.dtype}, pool {k_pages.dtype}, weights "
            f"{sorted({str(blk[n].dtype) for n in names})}")
    norms = ["ln1_w"] + (["ln2_w"] if fuse_mlp else [])
    if gpt:
        if h != kvh:
            raise ValueError(f"the GPT fused block kernel takes group 1 "
                             f"(h == kv_heads), got {h} over {kvh}")
        # every vector fp32, as fused_layer_params stores them
        sizes = {"ln1_w": hidden, "ln1_b": hidden, "bq": h * d,
                 "bk": kvh * d, "bv": kvh * d}
        if not partial_out:
            sizes["bo"] = hidden
        if fuse_mlp:
            sizes.update(ln2_w=hidden, ln2_b=hidden, bu=ffn, bd=hidden)
        if any(blk[n].dtype != torch.float32 for n in sizes):
            raise TypeError(
                f"the GPT fused block kernel takes float32 norm affines and "
                f"biases, got {sorted({str(blk[n].dtype) for n in sizes})}")
        vec = {n: blk[n].reshape(-1) for n in sizes}
        for n, size in sizes.items():
            if vec[n].numel() != size:
                raise ValueError(f"{n} must hold {size} values, got "
                                 f"{tuple(blk[n].shape)}")
    else:
        vec = {}
        ln_dtypes = {blk[n].dtype for n in norms}
        if len(ln_dtypes) != 1 or not ln_dtypes <= {bf, torch.float32}:
            raise TypeError(f"norm weights must all be bfloat16 or all "
                            f"float32, got {sorted(map(str, ln_dtypes))}")
    if page_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("page_table and lengths must be int32")
    rope = [] if gpt else [("cos", cos), ("sin", sin)]
    tensors = [("x", x), ("k_pages", k_pages), ("v_pages", v_pages),
               ("page_table", page_table), ("lengths", lengths)] + rope + [
                   (n, blk[n]) for n in names + norms] + list(vec.items())
    for name, t in tensors:
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    for n in names:
        if tuple(blk[n].shape) != shapes[n]:
            raise ValueError(f"{n} must be {shapes[n]}, got "
                             f"{tuple(blk[n].shape)}")
    for n in norms:
        if blk[n].numel() != hidden:
            raise ValueError(f"{n} must hold {hidden} weights, got "
                             f"{tuple(blk[n].shape)}")
    if h // kvh not in _KERNEL_GROUPS or d not in _KERNEL_HEAD_DIMS:
        raise ValueError(
            f"fused block kernel takes group (h / kv_heads) in "
            f"{_KERNEL_GROUPS} and head_dim in {_KERNEL_HEAD_DIMS}, got "
            f"group {h // kvh}, head_dim {d}")
    if hidden % 8 or ffn % 8:
        raise ValueError(f"fused block kernel takes hidden and ffn in "
                         f"multiples of 8, got {hidden} and {ffn}")
    inner = (ps * d, d, 1)
    if k_pages.stride()[1:] != inner or v_pages.stride() != k_pages.stride() \
            or k_pages.stride(0) % 8:
        raise ValueError(
            f"k/v pages must have inner strides {inner}, equal strides and "
            f"a page stride that is a multiple of 8; got k "
            f"{k_pages.stride()} v {v_pages.stride()}")
    if not gpt:
        cos = cos.to(torch.float32).contiguous()
        sin = sin.to(torch.float32).contiguous()
        if tuple(cos.shape) != (slots, d) or tuple(sin.shape) != (slots, d):
            raise ValueError(f"cos/sin must be [{slots}, {d}], got "
                             f"{tuple(cos.shape)} / {tuple(sin.shape)}")
    ops = [x, page_table, lengths] + [blk[n] for n in names + norms] \
        + list(vec.values())
    if not all(t.is_contiguous() for t in ops):
        raise ValueError("x, page_table, lengths and the weights must be "
                         "contiguous")
    if any(t.data_ptr() % 16 for t in ops + [k_pages, v_pages]):
        raise ValueError("x, the weights and the pool must be 16-byte "
                         "aligned")
    y = torch.empty_like(x)
    kt = torch.empty((slots, kvh, d), dtype=bf, device=x.device)
    vt = torch.empty_like(kt)
    lib = _build.library()
    stream = _build.stream_ptr(x.device)
    ptr = (lambda t: None if t is None else t.data_ptr())
    counter = ("fused_block_decode_gpt" if gpt else "fused_block_decode") \
        + ("_partial" if partial_out else "")
    pool = (k_pages.data_ptr(), v_pages.data_ptr(), page_table.data_ptr(),
            lengths.data_ptr(), y.data_ptr(), kt.data_ptr(), vt.data_ptr())
    geo = (slots, hidden, h, kvh, d)

    def launch_partial(ws, ws_bytes):
        tail = (ws, ws_bytes, ptr(clock), *geo, ps, page_table.shape[1],
                k_pages.stride(0))
        if gpt:
            return lib.apex_fused_block_decode_gpt_partial(
                x.data_ptr(), ptr(vec["ln1_w"]), ptr(vec["ln1_b"]),
                ptr(blk["wq"]), ptr(vec["bq"]), ptr(blk["wk"]),
                ptr(vec["bk"]), ptr(blk["wv"]), ptr(vec["bv"]),
                ptr(blk["wo"]), *pool, *tail, float(eps),
                float(scale * _LOG2E), stream)
        return lib.apex_fused_block_decode_partial(
            x.data_ptr(), cos.data_ptr(), sin.data_ptr(),
            blk["ln1_w"].data_ptr(), blk["wq"].data_ptr(),
            blk["wk"].data_ptr(), blk["wv"].data_ptr(), blk["wo"].data_ptr(),
            *pool, *tail, int(blk["ln1_w"].dtype == torch.float32),
            float(eps), float(scale * _LOG2E), stream)

    def launch(ws, ws_bytes):
        if partial_out:
            return launch_partial(ws, ws_bytes)
        if gpt:
            mv = (lambda n: ptr(vec.get(n)))
            mw = (lambda n: ptr(blk[n]) if fuse_mlp else None)
            return lib.apex_fused_block_decode_gpt(
                x.data_ptr(), mv("ln1_w"), mv("ln1_b"), ptr(blk["wq"]),
                mv("bq"), ptr(blk["wk"]), mv("bk"), ptr(blk["wv"]),
                mv("bv"), ptr(blk["wo"]), mv("bo"), mv("ln2_w"),
                mv("ln2_b"), mw("wu"), mv("bu"), mw("wd"), mv("bd"), *pool,
                ws, ws_bytes, ptr(clock), slots, hidden, h, kvh, d, ffn, ps,
                page_table.shape[1], k_pages.stride(0), int(fuse_mlp),
                float(eps), float(scale * _LOG2E), stream)
        ln2 = blk["ln2_w"] if fuse_mlp else None
        mlp = [blk[n] for n in ("wg", "wu", "wd")] if fuse_mlp \
            else [None] * 3
        return lib.apex_fused_block_decode(
            x.data_ptr(), cos.data_ptr(), sin.data_ptr(),
            blk["ln1_w"].data_ptr(), blk["wq"].data_ptr(),
            blk["wk"].data_ptr(), blk["wv"].data_ptr(),
            blk["wo"].data_ptr(), ptr(ln2), *map(ptr, mlp), *pool,
            ws, ws_bytes, ptr(clock), slots, hidden, h, kvh, d, ffn, ps,
            page_table.shape[1], k_pages.stride(0), int(fuse_mlp),
            int(blk["ln1_w"].dtype == torch.float32), float(eps),
            float(scale * _LOG2E), stream)

    key = (x.device, kind, slots, hidden, h, kvh, d, ffn, ps,
           page_table.shape[1], bool(fuse_mlp), bool(partial_out))
    if key not in _WS_BYTES:
        need = ctypes.c_longlong(0)
        _build.check(launch(None, ctypes.byref(need)), counter)
        _WS_BYTES[key] = need.value
    ws = torch.empty(_WS_BYTES[key], dtype=torch.uint8, device=x.device)
    _build.count(counter)
    _build.check(launch(ws.data_ptr(), None), counter)
    return y, kt, vt


def fused_block_decode(x, blk, k_pages, v_pages, page_table, lengths, *,
                       kind: str, eps: float, cos=None, sin=None,
                       sm_scale: Optional[float] = None,
                       fuse_mlp: bool = True, partial_out: bool = False):
    """One fused decoder-block step against the paged pool.

    * ``x``: ``[slots, hidden]``, the block's input (one token a slot).
    * ``blk``: the layer in the fused layout (:func:`apex_tpu_torch.
      inference.models.fused_layer_params`): ``[in, out]`` matrices
      ``wq [hidden, h*d]``, ``wk``/``wv [hidden, kv_heads*d]``, ``wo [h*d,
      hidden]`` and the MLP's; LLaMA: RMSNorm ``ln1_w``/``ln2_w [1,
      hidden]`` and the SwiGLU ``wg``/``wu [hidden, ffn]``, ``wd [ffn,
      hidden]``; GPT: LayerNorm ``ln1_w``/``ln1_b``/``ln2_w``/``ln2_b``,
      the biases ``bq``/``bk``/``bv``/``bo`` as ``[1, n]`` rows and the
      GELU MLP ``wu``/``bu``/``wd``/``bd``.
    * ``k_pages``/``v_pages``: one layer's ``[pages, kv_heads,
      page_size, d]`` view of the pool; ``page_table``/``lengths`` as in
      :func:`paged_decode_attention`, ``lengths`` BEFORE this token is
      appended (the kernel folds the current token in itself).
    * ``cos``/``sin``: ``[slots, d]`` RoPE rows at each slot's position
      (LLaMA only).

    Returns ``(y [slots, hidden], k_tok [slots, kv_heads, d], v_tok)``:
    the block output and the current token's k (after RoPE) and v for
    the caller's pool append.  ``fuse_mlp=False`` returns ``y = x +
    attention``.  ``partial_out=True`` (with ``fuse_mlp=False``; a
    tensor-parallel rank's shard, ``blk`` its column/row slices, so
    ``wq`` is ``[hidden, h_rank * d]`` and ``wo`` ``[h_rank * d,
    hidden]``) returns the rank-partial ``y = ctx @ wo``: no residual,
    no ``bo``; the caller all-reduces it and finishes the layer.  On
    CUDA one launch of ``csrc/fused_block_decode.cu`` (``partial_out``:
    ``csrc/fused_block_partial.cu``; bf16 x, weights and pool; LLaMA
    group 1/2/4/8, GPT group 1; head_dim 64/128; anything else raises);
    a CPU tensor takes :func:`fused_block_reference`."""
    kvh, ps, d, h = _fused_geometry(x, blk, k_pages, v_pages, page_table,
                                    lengths, kind, cos, sin, partial_out,
                                    fuse_mlp)
    scale = (d ** -0.5) if sm_scale is None else sm_scale
    if x.device.type == "cpu":
        return fused_block_reference(
            x, blk, k_pages, v_pages, page_table, lengths, kind=kind,
            eps=eps, cos=cos, sin=sin, sm_scale=sm_scale, fuse_mlp=fuse_mlp,
            partial_out=partial_out)
    if x.device.type != "cuda":
        raise ValueError(f"fused_block_decode runs on cuda or cpu, got "
                         f"{x.device}")
    return _fused_kernel_call(x, blk, k_pages, v_pages, page_table, lengths,
                              cos, sin, eps, scale, fuse_mlp, kvh, ps, d, h,
                              kind=kind, partial_out=partial_out)
