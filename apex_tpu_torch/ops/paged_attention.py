"""Ragged paged decode attention — one query token per slot against a
paged KV pool.

Port of ``apex_tpu/ops/paged_attention.py :: paged_decode_attention``::

    k_pages, v_pages : [pages, kv_heads, page_size, head_dim]
    page_table       : [slots, max_pages_per_slot]  int32
    lengths          : [slots]                      int32

virtual position ``t`` of a slot resolves to physical page
``page_table[slot, t // page_size]``, row ``t % page_size``.

On CUDA the call always runs ``csrc/paged_attention.cu`` (the
counterpart of the Pallas ``_paged_kernel``): the JAX package's
``paged_xla_max_pages`` crossover, which sends windows of 64 pages or
fewer to a gathered XLA path, has no counterpart here.  The k/v
operands are usually one layer's strided view of the engine's
``[pages, layers, kv_heads, page_size, head_dim]`` pool; the kernel
takes the page stride and reads the pool in place, so no call copies
the pool.  A CPU tensor takes the plain version, which gathers the
slots' windows and scores them in fp32.
"""
from __future__ import annotations

from typing import Optional

import torch

from apex_tpu_torch.ops import _build
from apex_tpu_torch.ops.attention import _LOG2E, _NEG_INF

__all__ = ["paged_decode_attention", "paged_decode_reference"]

#: query rows per kv head and head dims the kernel is instantiated for
_KERNEL_GROUPS = (1, 2, 4, 8)
_KERNEL_HEAD_DIMS = (64, 128)
#: virtual-window positions per block (a multiple of the kernel's
#: 64-token chunk): a 4096-token window runs as 16 splits
_SPLIT_TOKENS = 256


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


def paged_decode_reference(q3, k_pages, v_pages, page_table, lengths,
                           scale: float):
    """Plain version: gather each slot's virtual window and score it
    (fp32, base-2 softmax; p rounded to the value dtype for P·V, the
    normalizer from the fp32 p).  ``q3 [slots, h, d]``."""
    slots, h, d = q3.shape
    _, kvh, ps, _ = k_pages.shape
    mpps = page_table.shape[1]
    group = h // kvh
    idx = page_table.long()

    def window(pages):
        g = pages[idx]                            # [slots, mpps, kvh, ps, d]
        return g.permute(0, 2, 1, 3, 4).reshape(slots, kvh, mpps * ps, d)

    kw, vw = window(k_pages), window(v_pages)
    qg = q3.reshape(slots, kvh, group, d).float()
    s = torch.einsum("bkgd,bkwd->bkgw", qg, kw.float()) * (scale * _LOG2E)
    live = (torch.arange(mpps * ps, device=q3.device)[None, :]
            < lengths.long()[:, None])[:, None, None, :]
    s = torch.where(live, s, torch.full_like(s, _NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(live, torch.exp2(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgw,bkwd->bkgd", p.to(vw.dtype).float(),
                       vw.float())
    out = out / torch.where(l == 0, torch.ones_like(l), l)
    return out.reshape(slots, h, d).to(q3.dtype)


def _kernel_call(q3, k_pages, v_pages, page_table, lengths, scale):
    slots, h, d = q3.shape
    _, kvh, ps, _ = k_pages.shape
    mpps = page_table.shape[1]
    if q3.dtype != torch.bfloat16 or k_pages.dtype != torch.bfloat16 \
            or v_pages.dtype != torch.bfloat16:
        raise TypeError(f"paged attention kernel takes bfloat16 q/k/v, got "
                        f"{q3.dtype}/{k_pages.dtype}/{v_pages.dtype}")
    if page_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("page_table and lengths must be int32")
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages),
                    ("page_table", page_table), ("lengths", lengths)):
        if t.device != q3.device:
            raise ValueError(f"{name} is on {t.device}, q on {q3.device}")
    if not (q3.is_contiguous() and page_table.is_contiguous()
            and lengths.is_contiguous()):
        raise ValueError("q, page_table and lengths must be contiguous")
    # the pool view: heads and rows contiguous inside a page, any page
    # stride (one layer of the [pages, layers, ...] pool)
    inner = (ps * d, d, 1)
    if k_pages.stride()[1:] != inner or v_pages.stride() != k_pages.stride():
        raise ValueError(
            f"k/v pages must have inner strides {inner} and equal strides; "
            f"got k {k_pages.stride()} v {v_pages.stride()}")
    if slots > 65535:
        raise ValueError(f"{slots} slots exceed the kernel grid (65535)")
    if h // kvh not in _KERNEL_GROUPS or d not in _KERNEL_HEAD_DIMS:
        raise ValueError(
            f"paged attention kernel takes group (h / kv_heads) in "
            f"{_KERNEL_GROUPS} and head_dim in {_KERNEL_HEAD_DIMS}, got "
            f"group {h // kvh}, head_dim {d}")
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16 \
            or k_pages.stride(0) % 8:
        raise ValueError("k/v pages must be 16-byte aligned with a page "
                         "stride that is a multiple of 8 elements")
    # split the virtual window over blocks (flash-decoding); the splits'
    # partial softmax states merge in a second, small kernel
    nsplit = -(-(mpps * ps) // _SPLIT_TOKENS)
    out = torch.empty_like(q3)
    part_acc = part_ml = None
    if nsplit > 1:
        part_acc = torch.empty((slots * h, nsplit, d), dtype=torch.float32,
                               device=q3.device)
        part_ml = torch.empty((slots * h, nsplit, 2), dtype=torch.float32,
                              device=q3.device)
    lib = _build.library()
    _build.count("paged_attention")
    err = lib.apex_paged_decode_attention(
        q3.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        part_acc.data_ptr() if part_acc is not None else None,
        part_ml.data_ptr() if part_ml is not None else None, slots, h, kvh,
        ps, d, mpps, k_pages.stride(0), nsplit, _SPLIT_TOKENS,
        float(scale * _LOG2E), _build.stream_ptr(q3.device))
    _build.check(err, "paged_attention")
    return out


def paged_decode_attention(q, k_pages, v_pages, page_table, lengths, *,
                           sm_scale: Optional[float] = None):
    """Single-token attention against a paged KV pool.

    * ``q``: ``[slots, h, 1, d]`` (or ``[slots, h, d]``).
    * ``k_pages``/``v_pages``: ``[pages, kv_heads, page_size, d]`` —
      one layer's (possibly strided) slice of the pool, ``kv_heads``
      dividing ``h``.
    * ``page_table``: ``[slots, max_pages_per_slot]`` int32; dead
      entries may hold any valid page (the trash page by convention).
    * ``lengths``: ``[slots]`` int32 live tokens; length 0 emits zeros.
    """
    squeezed = q.dim() == 3
    q3 = q if squeezed else q[:, :, 0, :]
    if not squeezed and q.shape[2] != 1:
        raise ValueError(
            f"paged_decode_attention is the q_len == 1 path, got q_len "
            f"{q.shape[2]}; use flash_attention for prefill")
    _check_operands(q3, k_pages, v_pages, page_table, lengths)
    d = q3.shape[-1]
    scale = (d ** -0.5) if sm_scale is None else sm_scale
    if q3.device.type == "cpu":
        out = paged_decode_reference(q3, k_pages, v_pages, page_table,
                                     lengths, scale)
    elif q3.device.type == "cuda":
        out = _kernel_call(q3.contiguous(), k_pages, v_pages, page_table,
                           lengths, scale)
    else:
        raise ValueError(f"paged_decode_attention runs on cuda or cpu, got "
                         f"{q3.device}")
    return out if squeezed else out[:, :, None, :]
