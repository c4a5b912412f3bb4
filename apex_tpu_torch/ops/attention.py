"""Flash attention forward and backward (CUDA kernels) and the plain
attention functions the serving and training slices use.

Port of ``apex_tpu/ops/attention.py``, ``[b, h, s, d]`` layout:

* :func:`flash_attention` — the fused attention, differentiable through
  a ``torch.autograd.Function``.  It takes the JAX entry's routing
  arguments: ``use_kernel=False`` runs the plain chain of the JAX
  package's XLA route (:func:`_xla_attention`) on any device;
  ``use_kernel=True``, explicit ``block_q``/``block_k`` and
  ``use_kernel=None`` run the kernels on CUDA, as the JAX entry does on
  a non-TPU backend (its short-sequence crossover,
  :func:`xla_path_max_seq`, applies on TPUs only, so it is read and
  checked here but sends nothing to the plain chain).  On CUDA the
  forward runs ``csrc/flash_attention.cu`` (the counterpart of the
  Pallas ``_fwd_kernel``).  Causal attention honours the offset
  ``sk - sq``; the kernel's online softmax and the returned log-sum-exp
  are in BASE 2, exactly as ``_fwd`` returns them (:func:`_fwd`).  The
  backward (:func:`_bwd`) computes ``delta = rowsum(dO * O)`` in plain
  PyTorch, as the JAX ``_bwd_impl`` does outside its kernels, and takes
  the JAX package's route: while ``sq * d * 4 <= _FUSED_BWD_MAX_BYTES``
  (2 MiB: every sequence up to 4096 tokens at head_dim 128) the
  one-pass kernel of ``csrc/flash_attention_bwd.cu`` (the counterpart
  of ``_bwd_fused_kernel``), beyond it the split pair in the same
  source, the dq kernel and the dk/dv kernel (``_dq_kernel`` and
  ``_dkv_kernel``).  All consume the base-2 lse.  The one-pass kernel
  adds dq with fp32 bulk reductions in any order, so its dq's last bits
  vary from run to run; the split pair writes every output once, and
  repeats bit for bit.  A boolean ``mask`` (True = masked) becomes the
  JAX package's ``mask3`` operand, ``[mb, sq, sk]`` for a mask of one
  head or ``[b*h, sq, sk]`` per head, and the forward runs the masked
  instance of the same kernel (launch counter
  ``flash_attention_masked``), after a pre-pass that sorts the mask's
  tiles into dead, full and partial ones; a fully masked row emits 0.
  The backward takes the same ``mask3``.  ``dropout_rate > 0`` drops
  attention probabilities inside the kernels with the JAX package's
  keep mask (:func:`_keep_mask`: the murmur3 hash of the global
  ``(batch*head, row, col)``, bit for bit) from the seed operand
  ``[seed, row_off, col_off]`` (:func:`_seed_operand`, int32 on the
  operands' device, read by the kernels: no host sync).  The forward's
  row sums take the clean p and only the P·V product the dropped,
  rescaled one; the backward regenerates the bits.  Each such instance
  counts its launches apart from the plain ones:
  ``flash_attention_drop`` and ``flash_attention_masked_drop`` (the
  forward with dropout, without and with a mask),
  ``flash_attention_bwd_masked`` and ``flash_attention_bwd_drop`` (the
  one-pass backward with a mask, with or without dropout, and with
  dropout alone), ``flash_attention_bwd_dq_md`` and
  ``flash_attention_bwd_dkv_md`` (the split pair with a mask or
  dropout).  Those are the bf16 instances, at head dims 32, 64 and 128
  (64 and 128 with a mask in the backward or with dropout); a bf16 call
  between them is zero-padded to the next.  Every other call up to head
  dim 256 -- fp32 and fp16 operands, bf16 past 128 -- takes the wide
  kernels of ``csrc/flash_wide.cu``: the forward
  ``flash_attention_wide`` (#3w) and, for either JAX backward route,
  the pair ``flash_attention_wide_dq`` and ``flash_attention_wide_dkv``
  (#5w, #6w).  All three run on the tensor cores (16-bit at every head
  dim, fp32 up to 128 as three bf16 planes an operand, split once for
  the backward's pair, six bf16 products a product;
  :func:`_wide_on_tensor_cores`), fp32 past 128 on the CUDA cores.  One
  predicate names the route (:func:`_flash_route`).
* :func:`decode_attention` — single-token attention against the dense
  slot cache: the JAX package's plain grouped chain at or below its
  crossover (:func:`decode_xla_max_seq`, 4096 cached positions), the
  decode kernel above it (``flash_attention_masked``'s q_len-1 kernel:
  the query heads of a kv head scored together against the cache read
  in place, no k/v broadcast; :func:`_decode_kernel`).
  A cache layout the kernel cannot read in place (an unaligned base,
  strides that are not whole 16-byte rows and slots) runs on a
  contiguous copy of the layer (:func:`_decode_in_place`).
* :func:`slab_decode_attention` — the speculative verify step's
  attention: ``S`` drafted rows per slot against the slot's cache
  window, causal within the slab; plain XLA in the JAX package, plain
  PyTorch here on every device (the dense cache's verify path).
* :func:`mha_reference` — the natural-log oracle.
* :func:`prefix_window_attention` — the warm-prefill attention over a
  cached prefix window plus the causal suffix; plain XLA in the JAX
  package, plain PyTorch here.

A CPU tensor takes the plain version of each kernel; a CUDA tensor
launches the kernel or raises.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import torch

from apex_tpu_torch.ops import _build

__all__ = ["flash_attention", "xla_path_max_seq", "decode_attention",
           "decode_xla_max_seq", "mha_reference", "prefix_window_attention",
           "slab_decode_attention"]

_NEG_INF = -1e30          # finite "masked" score, as in the JAX package
_LOG2E = 1.4426950408889634
_MASKED_ROW_THRESH = _NEG_INF * 0.5
#: head dims the kernel is instantiated for
_KERNEL_HEAD_DIMS = (32, 64, 128)
#: the JAX package's one-pass backward gate (``attention.py``): the
#: one-pass kernel while its ``[sq, d]`` fp32 dq is at most this many
#: bytes, the split pair beyond.  Module-level so tests can force either
#: route.
_FUSED_BWD_MAX_BYTES = 2 * 1024 * 1024
#: the JAX package's decode crossover: a dense cache of at most this
#: many positions is scored by the plain grouped chain, a longer one by
#: the masked flash forward; ``APEX_TPU_DECODE_XLA_MAX_SEQ`` or
#: ``xla_max_seq=`` override it (0 forces the kernel branch)
_DECODE_XLA_MAX_SEQ = 4096
_DECODE_XLA_MAX_SEQ_ENV = "APEX_TPU_DECODE_XLA_MAX_SEQ"
#: the JAX entry's short-sequence crossover (TPU backends only): a
#: padded length at or under it takes the XLA chain there;
#: ``APEX_TPU_ATTN_XLA_MAX_SEQ`` or ``xla_max_seq=`` override it
_XLA_PATH_MAX_SEQ = 256
_XLA_MAX_SEQ_ENV = "APEX_TPU_ATTN_XLA_MAX_SEQ"
#: query rows per kv head and head dims the decode kernel is
#: instantiated for (csrc/kv_decode.cuh); other shapes take the masked
#: flash forward over k/v broadcast to the query heads
_DECODE_KERNEL_GROUPS = (1, 2, 4, 8)
_DECODE_KERNEL_HEAD_DIMS = (64, 128)
#: cache positions a ring stage of the decode kernel holds
_DECODE_TILE = 64
#: queries and keys of a tile of the masked forward's pre-pass (the
#: kernel's query block and key tile)
_MASK_TILE = 128
#: head dims the mask and dropout instances (the backward with a mask,
#: anything with dropout) are built for
_MD_HEAD_DIMS = (64, 128)
#: the widest head dim a flash kernel takes: the wide kernels' largest
#: bucket (ROADMAP V9 holds the head dims past it)
_WIDE_MAX_HEAD_DIM = 256
#: the wide kernels' operand types, by the code their C entries take
_WIDE_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
#: the code of fp32 operands handed to the wide forward and dq as three
#: bf16 planes each (:func:`_split_planes`), as the tensor cores take them
_WIDE_F32_PLANES = 3
#: the widest head dim the wide forward and dq take fp32 at on the tensor
#: cores (past it no tile of three planes fits in shared memory)
_WIDE_TC_F32_MAX_HEAD_DIM = 128
#: murmur3's fmix32 constants as unsigned 32-bit values (the JAX package
#: writes the same bits as signed int32 literals)
_H1 = 0x9E3779B9
_H2 = 0x85EBCA6B
_H3 = 0xC2B2AE35
_M32 = 0xFFFFFFFF
#: the rank fold's multiplier (:func:`fold_rank_seed`), murmur3's c1
_HF = 0xCC9E2D51


def _mul32(x, c: int):
    """``x * c mod 2^32`` for int64 ``x`` in ``[0, 2^32)`` and a 32-bit
    constant ``c``, in two 16-bit halves of ``c`` so no int64 product
    overflows (the JAX package's wrapping int32 multiply)."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _drop_threshold(rate: float) -> int:
    """The keep mask's cut on its 24-bit uniform, as JAX computes it."""
    return int(round(rate * (1 << 24)))


def _keep_mask(seed, bi, qi, ki, bq, bk, rate, row_off=0, col_off=0, *,
               device=None):
    """The JAX package's ``_keep_mask`` bit for bit: True where an
    element of the ``(qi, ki)`` block ``[bq, bk]`` of batch-head ``bi``
    survives dropout.  The bits are murmur3's finalizer over ``seed ^
    bi*H1 ^ row*H2 ^ col*H3`` at the GLOBAL row ``row_off + qi*bq + i``
    and column ``col_off + ki*bk + j`` (uint32 arithmetic, here in int64
    masked to 32 bits); the top 24 bits are the uniform, kept at or
    above ``round(rate * 2^24)``.  ``seed``, ``bi`` and the offsets are
    ints or int tensors (``bi`` may be ``[n, 1, 1]`` for ``n``
    batch-heads at once)."""
    as64 = (lambda x: torch.as_tensor(x, dtype=torch.int64, device=device)
            & _M32)
    rows = as64(row_off) + qi * bq + torch.arange(bq, device=device)[:, None]
    cols = as64(col_off) + ki * bk + torch.arange(bk, device=device)[None, :]
    h = (as64(seed) ^ _mul32(as64(bi), _H1) ^ _mul32(rows & _M32, _H2)
         ^ _mul32(cols & _M32, _H3))
    h = h ^ (h >> 16)
    h = _mul32(h, _H2)
    h = h ^ (h >> 13)
    h = _mul32(h, _H3)
    h = h ^ (h >> 16)
    return (h >> 8) >= _drop_threshold(rate)


def _seed_operand(seed, row_off=0, col_off=0, *, device=None):
    """The dropout operand ``[seed, row_off, col_off]``, int32 on
    ``device`` (the kernels read it there).  ``seed`` is an int or an
    int tensor of one element (drawn on the device, it stays there: no
    host sync); the offsets are 0 unless a caller shards the sequence
    (ring attention sets them per shard pair)."""
    if isinstance(seed, torch.Tensor):
        device = seed.device if device is None else device
        s = seed.reshape(1).to(device=device, dtype=torch.int32)
        return torch.cat([s] + [torch.full((1,), int(x), dtype=torch.int32,
                                           device=device)
                                for x in (row_off, col_off)])
    return torch.tensor([seed, row_off, col_off], dtype=torch.int32,
                        device=device)


def _int32(x: int) -> int:
    """``x`` wrapped to a signed 32-bit int (JAX's int32 arithmetic)."""
    x &= _M32
    return x - (1 << 32) if x >= 1 << 31 else x


def fold_rank_seed(seed, axis_name):
    """A per-rank dropout seed from one that every rank shares (the
    JAX package's ``fold_rank_seed``, Megatron's per-tensor-rank stream):
    ``seed ^ (rank * 0xCC9E2D51)`` in int32, the rank this process's in
    ``axis_name``'s process group (a mesh-axis name, resolved by
    ``parallel_state.resolve_group``, which raises ``RuntimeError``
    without a topology; or a ``ProcessGroup``).  Rank 0 keeps ``seed``.
    ``seed``: an int (an int comes back) or an int tensor of one element
    (an int32 tensor on its device comes back: no host sync).  Do not
    fold the context axis into ring attention's seed: its sharded result
    equals the dense one only with one seed on every cp rank."""
    import torch.distributed as dist
    from apex_tpu_torch.transformer import parallel_state
    rank = dist.get_rank(parallel_state.resolve_group(axis_name))
    mix = _int32(rank * _HF)
    if isinstance(seed, torch.Tensor):
        return seed.to(torch.int32) ^ torch.tensor(mix, dtype=torch.int32,
                                                   device=seed.device)
    return _int32(int(seed)) ^ mix


def _inv_keep(rate: float) -> float:
    return 1.0 / (1.0 - rate)


def _keep3(seed3, bh, sq, sk, rate, device, bh0=0):
    """The keep mask ``[bh, sq, sk]`` of batch-heads ``bh0 ..
    bh0 + bh`` (a slice of a larger call hashes its global batch-head
    indices) from the seed operand."""
    s = seed3.to(device=device, dtype=torch.int64)
    bi = torch.arange(bh0, bh0 + bh, device=device)[:, None, None]
    return _keep_mask(s[0], bi, 0, 0, sq, sk, rate, s[1], s[2],
                      device=device)


def _dropout_reference(p, *, rate, seed):
    """Oracle twin of the kernels' dropout on a full ``[b, h, sq, sk]``
    probability array (the JAX package's): the block-independent keep
    mask of each batch-head, survivors scaled by ``1 / (1 - rate)``."""
    b, h, sq, sk = p.shape
    keep = _keep3(_seed_operand(seed), b * h, sq, sk, rate,
                  p.device).reshape(b, h, sq, sk)
    return torch.where(keep, p, torch.zeros_like(p)) * _inv_keep(rate)


def mha_reference(q, k, v, *, causal: bool = False, mask=None,
                  sm_scale: Optional[float] = None,
                  dropout_rate: float = 0.0, dropout_seed=None):
    """Plain oracle: softmax(scale·QKᵀ + mask)·V with fp32 math.
    ``mask`` is boolean, True = masked, broadcastable to
    ``[b, h, sq, sk]``; fully masked rows emit 0.  With
    ``dropout_rate``, the softmax THEN the kernels' exact dropout."""
    sq, d = q.shape[-2], q.shape[-1]
    sk = k.shape[-2]
    scale = (d ** -0.5) if sm_scale is None else sm_scale
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        cm = torch.ones(sq, sk, dtype=torch.bool,
                        device=q.device).tril(diagonal=sk - sq)
        s = torch.where(cm, s, torch.full_like(s, _NEG_INF))
    if mask is not None:
        s = torch.where(mask, torch.full_like(s, _NEG_INF), s)
    p = torch.softmax(s, dim=-1)
    p = torch.where(s.amax(dim=-1, keepdim=True) <= _MASKED_ROW_THRESH,
                    torch.zeros_like(p), p)
    if dropout_rate:
        p = _dropout_reference(p, rate=dropout_rate, seed=dropout_seed)
    return torch.matmul(p, v.float()).to(q.dtype)


def _live3(bh, sq, sk, causal, off, valid, mask3, device):
    """The elements the kernels score: the causal and validity masks
    ``[sq, sk]``, and with ``mask3 [nmask, sq, sk]`` (True = masked,
    batch-head ``i`` reading mask ``i // (bh // nmask)``) ``[bh, sq,
    sk]``."""
    live = _live_mask(sq, sk, causal, off, valid, device)
    if mask3 is None:
        return live
    nmask = mask3.shape[0]
    return live & ~mask3[:, None].expand(
        nmask, bh // nmask, sq, sk).reshape(bh, sq, sk)


def _fwd_reference(q3, k3, v3, causal, scale, causal_off=None, valid=None,
                   mask3=None, rate=0.0, seed3=None, bh0=0, mm=torch.matmul,
                   out_dtype=None):
    """Plain version of the kernel: ``(out [bh, sq, d], lse [bh, sq])``
    with the base-2 log-sum-exp and the kernel's masks (``mask3 [nmask,
    sq, sk]`` bool, True = masked, batch-head ``i`` reading mask ``i //
    (bh // nmask)``) and dropout (``rate``, ``seed3``; ``bh0`` the first
    batch-head's global index when ``q3`` is a slice of a call).  ``mm``
    computes the two products (:func:`_matmul6`: as the fp32 tensor-core
    route does).  ``out`` is of ``out_dtype`` (default q's): fp32 keeps
    the accumulator's value, never rounded to q's type."""
    bh, sq, d = q3.shape
    sk = k3.shape[1]
    off = (sk - sq) if causal_off is None else causal_off
    s = mm(q3.float(), k3.float().transpose(1, 2)) * (scale * _LOG2E)
    live = _live3(bh, sq, sk, causal, off, valid, mask3, q3.device)
    s = torch.where(live, s, torch.full_like(s, _NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s - m)
    p = torch.where(m <= _MASKED_ROW_THRESH, torch.zeros_like(p), p)
    l = p.sum(dim=-1, keepdim=True)
    l1 = torch.where(l == 0, torch.ones_like(l), l)
    if rate:
        # the row sums above take the clean p; only P·V the dropped one
        keep = _keep3(seed3, bh, sq, sk, rate, q3.device, bh0)
        p = torch.where(keep, p, torch.zeros_like(p)) * _inv_keep(rate)
    # p rounds to the value dtype for the P·V product, as the kernel's
    # tensor-core feed does; the normalizer keeps the fp32 p
    out = mm(p.to(v3.dtype).float(), v3.float()) / l1
    lse = (m + torch.log2(l1))[..., 0]
    return out.to(out_dtype or q3.dtype), lse


def _split_planes(x):
    """Plain version of the split kernel (``apex_flash_wide_split``): fp32
    ``x [..., d]`` as three bf16 planes ``[3, ..., dp]`` (``dp`` = d
    rounded up to 8, the padding columns 0), ``x ~ x0 + x1 + x2`` with
    ``x0 = bf16(x)``, ``x1 = bf16(x - x0)``, ``x2 = bf16(x - x0 - x1)``
    (round to nearest; both differences are exact in fp32, and the sum is
    within 2^-24 |x| of x while every plane is a normal number)."""
    d = x.shape[-1]
    x = torch.nn.functional.pad(x.float(), (0, -d % 8))
    x0 = x.to(torch.bfloat16)
    r = x - x0.float()
    x1 = r.to(torch.bfloat16)
    return torch.stack((x0, x1, (r - x1.float()).to(torch.bfloat16)))


def _matmul6(a, b):
    """``a @ b`` of fp32 operands as the wide kernels' fp32 tensor-core
    route computes it: both split into three bf16 planes
    (:func:`_split_planes`, without the padding), the six products that
    keep every term down to ~2^-16 of the product -- a0 b0 + a0 b1 + a1 b0
    + a0 b2 + a1 b1 + a2 b0 -- each exact in fp32 and summed in fp32, the
    small ones first."""
    pa, pb = (_split_planes(x)[..., :x.shape[-1]].float() for x in (a, b))
    out = None
    for i, j in ((1, 1), (0, 2), (2, 0), (0, 1), (1, 0), (0, 0)):
        term = torch.matmul(pa[i], pb[j])
        out = term if out is None else out + term
    return out


def _check_kernel_operands(kernel, q3, k3, v3, extra=()):
    """What both flash kernels take: bf16 ``[bh, s, d]`` operands on one
    card, contiguous and 16-byte aligned, head_dim 32/64/128."""
    if q3.device.type != "cuda":
        raise ValueError(f"{kernel} runs on cuda or cpu, got {q3.device}")
    bh, sq, d = q3.shape
    sk = k3.shape[1]
    if k3.shape != (bh, sk, d) or v3.shape != k3.shape:
        raise ValueError(f"k/v must be [{bh}, sk, {d}] and equal-shaped, "
                         f"got k {tuple(k3.shape)} v {tuple(v3.shape)}")
    for name, t in (("q", q3), ("k", k3), ("v", v3), *extra):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{kernel} kernel takes bfloat16, got "
                            f"{name} {t.dtype}")
        if t.device != q3.device:
            raise ValueError(f"{name} is on {t.device}, q on {q3.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{kernel} kernel needs a contiguous, "
                             f"16-byte aligned {name}")
    if d not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"{kernel} kernel takes head_dim in "
                         f"{_KERNEL_HEAD_DIMS}, got {d}")
    if bh > 65535:
        raise ValueError(f"b*h = {bh} exceeds the kernel grid (65535)")


def _flash_route(dtype, d: int, masked: bool, rate: float):
    """The kernel family a flash call takes, stated once for the
    forward and the backward (either JAX route): ``("instance", dp)``
    for bf16 operands at head dim ``d <= 128`` -- the wgmma instances at
    ``dp``, the next head dim they are built for (:data:`_KERNEL_HEAD_DIMS`;
    :data:`_MD_HEAD_DIMS` with a mask or dropout, whose backward instances
    start at 64), the operands zero-padded to it by
    :func:`flash_attention` -- and ``("wide", d)`` for the rest up to head
    dim 256: fp32 and fp16 operands, and bf16 past 128 (#3w forward,
    #5w + #6w backward, ``csrc/flash_wide.cu``).  A head dim past 256
    raises (ROADMAP V9)."""
    if not 1 <= d <= _WIDE_MAX_HEAD_DIM:
        raise ValueError(
            f"flash attention kernels take head_dim 1..{_WIDE_MAX_HEAD_DIM}, "
            f"got {d}: head dims past {_WIDE_MAX_HEAD_DIM} are ROADMAP V9")
    if dtype == torch.bfloat16 and d <= _KERNEL_HEAD_DIMS[-1]:
        dims = _MD_HEAD_DIMS if masked or rate else _KERNEL_HEAD_DIMS
        return "instance", next(x for x in dims if x >= d)
    return "wide", d


def _window(sq, sk, causal_off, valid):
    """``(off, valid_q, valid_k)`` as the kernels take them."""
    off = (sk - sq) if causal_off is None else int(causal_off)
    vq, vk = (sq, sk) if valid is None else (int(valid[0]), int(valid[1]))
    return off, vq, vk


def _check_seed3(kernel, seed3, device):
    if seed3 is None or seed3.dtype != torch.int32 \
            or tuple(seed3.shape) != (3,) or seed3.device != device \
            or not seed3.is_contiguous():
        raise ValueError(f"{kernel} takes the dropout seed operand as a "
                         f"contiguous int32 [3] on {device}")


def _live_mask(sq, sk, causal, off, valid, device):
    rows = torch.arange(sq, device=device)[:, None]
    cols = torch.arange(sk, device=device)[None, :]
    live = torch.ones(sq, sk, dtype=torch.bool, device=device)
    if causal:
        live &= rows + off >= cols
    if valid is not None:
        live &= (rows < valid[0]) & (cols < valid[1])
    return live


def _recompute_p(q3, k3, lse, causal, scale, off, valid, mask3=None,
                 mm=torch.matmul):
    """``_recompute_p``'s plain version: ``p = exp2(s - lse)`` in fp32
    with the kernels' masks (``mask3`` as :func:`_fwd_reference`'s) and
    the fully-masked-row guard."""
    bh, sq, sk = q3.shape[0], q3.shape[1], k3.shape[1]
    s = mm(q3.float(), k3.float().transpose(1, 2)) * (scale * _LOG2E)
    s = torch.where(_live3(bh, sq, sk, causal, off, valid, mask3,
                           q3.device), s, torch.full_like(s, _NEG_INF))
    p = torch.exp2(s - lse[..., None])
    return torch.where(lse[..., None] <= _MASKED_ROW_THRESH,
                       torch.zeros_like(p), p)


def _ds(p, v3, do3, delta, dtype, keep=None, rate=0.0, mm=torch.matmul):
    """``ds = p (g - delta)`` with ``g = dO V^T`` (under dropout, the
    JAX ``_dropped_dp``: ``g = keep ? dp / (1 - rate) : 0``), rounded to
    ``dtype`` (the matrix units' feed) and returned in fp32."""
    dp = mm(do3.float(), v3.float().transpose(1, 2))
    if keep is not None:
        dp = torch.where(keep, dp * _inv_keep(rate), torch.zeros_like(dp))
    return (p * (dp - delta[..., None])).to(dtype).float()


def _recompute(q3, k3, lse, causal, scale, causal_off, valid, mask3, rate,
               seed3, bh0, mm=torch.matmul):
    """The split pair's common recompute: ``(p, keep)``, keep None
    without dropout."""
    bh, sq, sk = q3.shape[0], q3.shape[1], k3.shape[1]
    off = (sk - sq) if causal_off is None else causal_off
    p = _recompute_p(q3, k3, lse, causal, scale, off, valid, mask3, mm)
    keep = _keep3(seed3, bh, sq, sk, rate, q3.device, bh0) if rate else None
    return p, keep


def _dq_reference(q3, k3, v3, lse, delta, do3, causal, scale,
                  causal_off=None, valid=None, mask3=None, rate=0.0,
                  seed3=None, bh0=0, mm=torch.matmul, out_dtype=None):
    """Plain version of the split dq kernel: ``dq`` in ``out_dtype``
    (default q's) from the base-2 lse and ``delta = rowsum(dO * O)``,
    with ``mask3`` and dropout as :func:`_fwd_reference` takes them (and
    ``mm``)."""
    p, keep = _recompute(q3, k3, lse, causal, scale, causal_off, valid,
                         mask3, rate, seed3, bh0, mm)
    ds = _ds(p, v3, do3, delta, q3.dtype, keep, rate, mm)
    return (scale * mm(ds, k3.float())).to(out_dtype or q3.dtype)


def _dkv_reference(q3, k3, v3, lse, delta, do3, causal, scale,
                   causal_off=None, valid=None, mask3=None, rate=0.0,
                   seed3=None, bh0=0, mm=torch.matmul, out_dtype=None):
    """Plain version of the split dk/dv kernel: ``(dk, dv)`` in
    ``out_dtype`` (default the operands' dtypes); p (dropped and rescaled
    under dropout) and ds
    round to the operand dtype before their products, as the kernels
    feed their matrix units; every product through ``mm``
    (:func:`_matmul6`: the fp32 tensor-core route's six products)."""
    p, keep = _recompute(q3, k3, lse, causal, scale, causal_off, valid,
                         mask3, rate, seed3, bh0, mm)
    pv = p if keep is None else torch.where(
        keep, p, torch.zeros_like(p)) * _inv_keep(rate)
    dv = mm(pv.to(do3.dtype).float().transpose(1, 2), do3.float())
    del pv
    ds = _ds(p, v3, do3, delta, q3.dtype, keep, rate, mm)
    dk = scale * mm(ds.transpose(1, 2), q3.float())
    return dk.to(out_dtype or k3.dtype), dv.to(out_dtype or v3.dtype)


def _delta(o3, do3):
    """``rowsum(dO * O)`` in fp32, outside the kernels as in
    ``_bwd_impl`` (under dropout too: O is the dropped output)."""
    return (do3.float() * o3).sum(dim=-1)    # o3 promoted in the product


def _bwd_reference(q3, k3, v3, o3, lse, do3, causal, scale,
                   causal_off=None, valid=None, mask3=None, rate=0.0,
                   seed3=None, bh0=0, out_dtype=None):
    """Plain version of the backward: ``(dq, dk, dv)`` in ``out_dtype``
    (default the operands' dtype) from the base-2 lse, with
    ``_recompute_p``'s masks and fully-masked-row guard and the forward's
    dropout -- the composition of the split pair's plain versions (the
    one-pass kernel computes the same function)."""
    delta = _delta(o3, do3)
    args = (q3, k3, v3, lse, delta, do3, causal, scale, causal_off, valid,
            mask3, rate, seed3, bh0)
    return (_dq_reference(*args, out_dtype=out_dtype),
            *_dkv_reference(*args, out_dtype=out_dtype))


def _split_bwd(sq: int, d: int) -> bool:
    """The JAX ``_bwd_impl``'s route: the split pair when the one-pass
    kernel's ``[sq, d]`` fp32 dq would pass ``_FUSED_BWD_MAX_BYTES``."""
    return sq * d * 4 > _FUSED_BWD_MAX_BYTES


def _kernel_args(kernel, q3, k3, v3, lse, do3, causal, scale, causal_off,
                 valid, extra=()):
    """The backward kernels' checks; returns their shape and mask
    arguments ``(bh, sq, sk, d, causal, off, valid_q, valid_k,
    scale_log2, scale)``."""
    bh, sq, d = q3.shape
    sk = k3.shape[1]
    _check_kernel_operands(kernel, q3, k3, v3, (("dout", do3), *extra))
    if do3.shape != q3.shape:
        raise ValueError(f"dout must be {tuple(q3.shape)}")
    if lse.shape != (bh, sq) or lse.dtype != torch.float32 \
            or not lse.is_contiguous():
        raise ValueError(f"lse must be a contiguous fp32 [{bh}, {sq}]")
    off, vq, vk = _window(sq, sk, causal_off, valid)
    return (bh, sq, sk, d, int(causal), off, vq, vk, float(scale * _LOG2E),
            float(scale))


def _mask_scratch(nmask, sq, sk, device):
    """The mask pre-pass's scratch: a class a (mask, 128-query block,
    128-key tile) and the tile's mask bits in the product threads'
    order."""
    tiles = nmask * -(-sq // _MASK_TILE) * -(-sk // _MASK_TILE)
    return (torch.empty(tiles, dtype=torch.uint8, device=device),
            torch.empty(tiles * _MASK_TILE * 4, dtype=torch.int32,
                        device=device))


def _md_operands(kernel, q3, sk, mask3, rate, seed3, scratch=None):
    """The mask and dropout operands of the ``_md`` C entries: ``(ptrs,
    ints, floats, keep)`` -- the pointers ``(mask, cls, bits, seed3)``
    (null where absent), ``(mask_hper, mask_ld, threshold)``, ``(1 / (1
    - rate),)`` and the tensors they point into.  The scratch ``(cls,
    bits)`` is ``scratch`` where given (the split backward's, filled by
    :func:`_mask_tiles`), else allocated for the entry's own pre-pass.
    The mask's rows are ``sk`` bytes apart (the pre-pass reads any row
    length; no kernel reads the mask's bytes)."""
    bh, sq, d = q3.shape
    if d not in _MD_HEAD_DIMS:
        raise ValueError(f"{kernel} (a mask in the backward, or dropout) "
                         f"takes head_dim in {_MD_HEAD_DIMS}, got {d}")
    cls = bits = None
    hper = 1
    if mask3 is not None:
        if not mask3.is_contiguous():
            raise ValueError(f"{kernel} needs a contiguous mask3")
        cls, bits = scratch if scratch is not None else _mask_scratch(
            mask3.shape[0], sq, sk, q3.device)
        hper = bh // mask3.shape[0]
    if rate:
        _check_seed3(kernel, seed3, q3.device)
    ptr = (lambda t: None if t is None else t.data_ptr())
    return ((ptr(mask3), ptr(cls), ptr(bits), ptr(seed3) if rate else None),
            (hper, sk, _drop_threshold(rate) if rate else 0),
            (_inv_keep(rate) if rate else 1.0,), (mask3, cls, bits))


def _mask_tiles(q3, sk, mask3, causal, causal_off=None, valid=None):
    """The mask pre-pass alone (``apex_flash_mask_tiles``; uncounted, as
    inside the forward's masked entries): the scratch ``(cls, bits)``
    filled for ``mask3`` and the causal and validity masks, which the
    split backward hands to both of its kernels."""
    sq = q3.shape[1]
    if not mask3.is_contiguous():
        raise ValueError("the mask pre-pass needs a contiguous mask3")
    off, vq, vk = _window(sq, sk, causal_off, valid)
    cls, bits = _mask_scratch(mask3.shape[0], sq, sk, q3.device)
    err = _build.library().apex_flash_mask_tiles(
        mask3.data_ptr(), cls.data_ptr(), bits.data_ptr(), mask3.shape[0],
        sq, sk, sk, int(causal), off, vq, vk, _build.stream_ptr(q3.device))
    _build.check(err, "the mask pre-pass")
    return cls, bits


def _split_md(kernel, q3, k3, mask3, rate, seed3, causal, causal_off, valid,
              scratch):
    """The split kernels' mask and dropout operands ``(ptrs, ints,
    floats, keep)`` -- ``(cls, bits, seed3)``, ``(mask_hper, threshold)``,
    ``(1 / (1 - rate),)`` and the tensors they point into, which the
    caller holds until the launch -- with the pre-pass run first unless
    the filled ``scratch`` is given."""
    sk = k3.shape[1]
    if mask3 is not None and scratch is None:
        scratch = _mask_tiles(q3, sk, mask3, causal, causal_off, valid)
    ptrs, ints, floats, keep = _md_operands(kernel, q3, sk, mask3, rate,
                                            seed3, scratch)
    return ptrs[1:], (ints[0], ints[2]), floats, keep


def _dq_kernel(q3, k3, v3, lse, delta, do3, causal, scale, causal_off=None,
               valid=None, mask3=None, rate=0.0, seed3=None, scratch=None,
               f32=False):
    """The split backward's dq kernel (operands as
    :func:`_dq_reference`'s): ``dq`` bf16, written once, no atomics.
    With a mask or dropout, its ``_md`` instance, after the mask pre-pass
    unless ``scratch`` holds its filled result (:func:`_mask_tiles`).
    ``f32`` (no mask): the fp32-output instance, dq fp32 from the
    accumulator (``flash_attention_bwd_dq_f32out``, with dropout
    ``flash_attention_bwd_dq_drop_f32out``)."""
    if f32:
        if mask3 is not None:
            raise _no_f32_instance("the masked split backward")
        name = ("flash_attention_bwd_dq_drop_f32out" if rate
                else "flash_attention_bwd_dq_f32out")
    else:
        name = ("flash_attention_bwd_dq" if mask3 is None and not rate
                else "flash_attention_bwd_dq_md")
    dims = _kernel_args(name, q3, k3, v3, lse, do3, causal, scale,
                        causal_off, valid)
    dq = torch.empty(q3.shape, dtype=torch.float32 if f32 else q3.dtype,
                     device=q3.device)
    lib = _build.library()
    ops = (q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), do3.data_ptr(),
           lse.data_ptr(), delta.data_ptr())
    if f32:
        _build.count(name)
        if rate:
            _, ints, floats, _keep = _md_operands(name, q3, k3.shape[1],
                                                  None, rate, seed3)
            next_tile = torch.empty(1, dtype=torch.int32, device=q3.device)
            err = lib.apex_flash_attention_bwd_dq_drop_f32out(
                *ops, seed3.data_ptr(), next_tile.data_ptr(), dq.data_ptr(),
                *dims[:8], ints[2], floats[0], *dims[8:],
                _build.stream_ptr(q3.device))
        else:
            err = lib.apex_flash_attention_bwd_dq_f32out(
                *ops, dq.data_ptr(), *dims, _build.stream_ptr(q3.device))
    elif name == "flash_attention_bwd_dq":
        _build.count(name)
        err = lib.apex_flash_attention_bwd_dq(
            *ops, dq.data_ptr(), *dims, _build.stream_ptr(q3.device))
    else:
        ptrs, ints, floats, _keep = _split_md(name, q3, k3, mask3, rate,
                                              seed3, causal, causal_off,
                                              valid, scratch)
        # the persistent blocks' tile counter (zeroed by the C entry)
        next_tile = torch.empty(1, dtype=torch.int32, device=q3.device)
        _build.count(name)
        err = lib.apex_flash_attention_bwd_dq_md(
            *ops, *ptrs, next_tile.data_ptr(), dq.data_ptr(), *dims[:8],
            *ints, *floats, *dims[8:], _build.stream_ptr(q3.device))
    _build.check(err, name)
    return dq


def _dkv_kernel(q3, k3, v3, lse, delta, do3, causal, scale, causal_off=None,
                valid=None, mask3=None, rate=0.0, seed3=None, scratch=None,
                f32=False):
    """The split backward's dk/dv kernel (operands as
    :func:`_dkv_reference`'s): ``(dk, dv)`` bf16, each written once.
    With a mask or dropout, its ``_md`` instance, after the mask pre-pass
    unless ``scratch`` holds its filled result (:func:`_mask_tiles`).
    ``f32`` (no mask): the fp32-output instance, dk and dv fp32 from the
    accumulators (``flash_attention_bwd_dkv_f32out``, with dropout
    ``flash_attention_bwd_dkv_drop_f32out``)."""
    if f32:
        if mask3 is not None:
            raise _no_f32_instance("the masked split backward")
        name = ("flash_attention_bwd_dkv_drop_f32out" if rate
                else "flash_attention_bwd_dkv_f32out")
    else:
        name = ("flash_attention_bwd_dkv" if mask3 is None and not rate
                else "flash_attention_bwd_dkv_md")
    dims = _kernel_args(name, q3, k3, v3, lse, do3, causal, scale,
                        causal_off, valid)
    out_dtype = torch.float32 if f32 else k3.dtype
    dk = torch.empty(k3.shape, dtype=out_dtype, device=k3.device)
    dv = torch.empty(v3.shape, dtype=out_dtype, device=v3.device)
    lib = _build.library()
    ops = (q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), do3.data_ptr(),
           lse.data_ptr(), delta.data_ptr())
    if f32:
        _build.count(name)
        if rate:
            _, ints, floats, _keep = _md_operands(name, q3, k3.shape[1],
                                                  None, rate, seed3)
            err = lib.apex_flash_attention_bwd_dkv_drop_f32out(
                *ops, seed3.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                *dims[:8], ints[2], floats[0], *dims[8:],
                _build.stream_ptr(q3.device))
        else:
            err = lib.apex_flash_attention_bwd_dkv_f32out(
                *ops, dk.data_ptr(), dv.data_ptr(), *dims,
                _build.stream_ptr(q3.device))
    elif name == "flash_attention_bwd_dkv":
        _build.count(name)
        err = lib.apex_flash_attention_bwd_dkv(
            *ops, dk.data_ptr(), dv.data_ptr(), *dims,
            _build.stream_ptr(q3.device))
    else:
        ptrs, ints, floats, _keep = _split_md(name, q3, k3, mask3, rate,
                                              seed3, causal, causal_off,
                                              valid, scratch)
        _build.count(name)
        err = lib.apex_flash_attention_bwd_dkv_md(
            *ops, *ptrs, dk.data_ptr(), dv.data_ptr(), *dims[:8], *ints,
            *floats, *dims[8:], _build.stream_ptr(q3.device))
    _build.check(err, name)
    return dk, dv


def _bwd_kernel(q3, k3, v3, o3, lse, do3, causal, scale, causal_off=None,
                valid=None, mask3=None, rate=0.0, seed3=None):
    """The one-pass backward kernel: ``(dq, dk, dv)`` bf16, dq added
    with fp32 bulk reductions into a scratch buffer and then cast.  With
    a mask its masked instance (``flash_attention_bwd_masked``, with or
    without dropout), with dropout alone ``flash_attention_bwd_drop``."""
    name = ("flash_attention_bwd" if mask3 is None and not rate
            else "flash_attention_bwd_masked" if mask3 is not None
            else "flash_attention_bwd_drop")
    dims = _kernel_args(name, q3, k3, v3, lse, do3, causal, scale,
                        causal_off, valid, (("out", o3),))
    if o3.shape != q3.shape:
        raise ValueError(f"out must be {tuple(q3.shape)}")
    delta = _delta(o3, do3)
    dq_acc = torch.empty(q3.shape, dtype=torch.float32, device=q3.device)
    dq = torch.empty_like(q3)
    dk = torch.empty_like(k3)
    dv = torch.empty_like(v3)
    lib = _build.library()
    ops = (q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), do3.data_ptr(),
           lse.data_ptr(), delta.data_ptr())
    outs = (dq_acc.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr())
    if name == "flash_attention_bwd":
        _build.count(name)
        err = lib.apex_flash_attention_bwd(*ops, *outs, *dims,
                                           _build.stream_ptr(q3.device))
    else:
        ptrs, ints, floats, _keep = _md_operands(name, q3, k3.shape[1],
                                                 mask3, rate, seed3)
        entry = getattr(lib, "apex_" + name)
        _build.count(name)
        err = entry(*ops, *ptrs, *outs, *dims[:8], *ints, *floats,
                    *dims[8:], _build.stream_ptr(q3.device))
    _build.check(err, name)
    return dq, dk, dv


#: where the fp32 outputs that no instance is built for are listed
_V10 = ("ROADMAP queue 2, V10 (fp32 outputs of the masked instances and "
        "of the wide family's 16-bit operands)")


def _f32_out(out_dtype, dtype) -> bool:
    """Whether a call asks for fp32 outputs from operands of another
    type (``out_dtype`` None or the operands' type: no)."""
    if out_dtype is None or out_dtype == dtype:
        return False
    if out_dtype != torch.float32:
        raise ValueError(f"out_dtype is the operands' dtype or "
                         f"torch.float32, got {out_dtype}")
    return True


def _no_f32_instance(what: str):
    return NotImplementedError(
        f"fp32 outputs of {what} have no kernel instance yet ({_V10}); "
        "nothing rounds them through the operands' type or runs the plain "
        "version on CUDA")


def _fwd_f32_kernel(q3, k3, v3, causal, scale, causal_off=None, valid=None,
                    rate=0.0, seed3=None):
    """The forward's fp32-output instances on bf16 operands (no mask):
    ``(out fp32, lse)``, out never rounded to bf16 (ring attention's
    partials).  Without dropout ``flash_attention_f32out`` (#3's
    instance), with it ``flash_attention_drop_f32out`` (#3d's), both in
    ``csrc/flash_attention_f32out.cu``."""
    name = "flash_attention_drop_f32out" if rate else "flash_attention_f32out"
    _check_kernel_operands(name, q3, k3, v3)
    bh, sq, d = q3.shape
    sk = k3.shape[1]
    off, vq, vk = _window(sq, sk, causal_off, valid)
    out = torch.empty(q3.shape, dtype=torch.float32, device=q3.device)
    lse = torch.empty((bh, sq), dtype=torch.float32, device=q3.device)
    lib = _build.library()
    ops = (q3.data_ptr(), k3.data_ptr(), v3.data_ptr())
    dims = (bh, sq, sk, d, int(causal), off, vq, vk)
    if rate:
        ptrs, ints, floats, _keep = _md_operands(name, q3, sk, None, rate,
                                                 seed3)
        _build.count(name)
        err = lib.apex_flash_attention_fwd_drop_f32out(
            *ops, ptrs[3], out.data_ptr(), lse.data_ptr(), *dims, ints[2],
            floats[0], float(scale * _LOG2E), _build.stream_ptr(q3.device))
    else:
        _build.count(name)
        err = lib.apex_flash_attention_fwd_f32out(
            *ops, out.data_ptr(), lse.data_ptr(), *dims,
            float(scale * _LOG2E), _build.stream_ptr(q3.device))
    _build.check(err, name)
    return out, lse


def _bwd_f32_kernel(q3, k3, v3, o3, lse, do3, causal, scale, causal_off=None,
                    valid=None, rate=0.0, seed3=None):
    """The one-pass backward's fp32-output instances on bf16 operands
    (no mask): ``(dq, dk, dv)`` fp32, dq the kernel's fp32 accumulator
    itself (no cast).  Without dropout ``flash_attention_bwd_f32out``
    (#4's instance), with it ``flash_attention_bwd_drop_f32out`` (#4d's),
    both in ``csrc/flash_attention_bwd_f32out.cu``."""
    name = ("flash_attention_bwd_drop_f32out" if rate
            else "flash_attention_bwd_f32out")
    dims = _kernel_args(name, q3, k3, v3, lse, do3, causal, scale,
                        causal_off, valid, (("out", o3),))
    if o3.shape != q3.shape:
        raise ValueError(f"out must be {tuple(q3.shape)}")
    delta = _delta(o3, do3)
    f32 = dict(dtype=torch.float32, device=q3.device)
    dq, dk, dv = (torch.empty(t.shape, **f32) for t in (q3, k3, v3))
    lib = _build.library()
    ops = (q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), do3.data_ptr(),
           lse.data_ptr(), delta.data_ptr())
    outs = (dq.data_ptr(), dk.data_ptr(), dv.data_ptr())
    if rate:
        ptrs, ints, floats, _keep = _md_operands(name, q3, k3.shape[1], None,
                                                 rate, seed3)
        _build.count(name)
        err = lib.apex_flash_attention_bwd_drop_f32out(
            *ops, ptrs[3], *outs, *dims[:8], ints[2], floats[0], *dims[8:],
            _build.stream_ptr(q3.device))
    else:
        _build.count(name)
        err = lib.apex_flash_attention_bwd_f32out(
            *ops, *outs, *dims, _build.stream_ptr(q3.device))
    _build.check(err, name)
    return dq, dk, dv


def _wide_operands(kernel, q3, k3, v3, mask3, rate, seed3, extra=()):
    """The wide kernels' checks (fp32, bf16 or fp16 ``[bh, s, d]``
    operands of one type on one card, contiguous, head_dim 1..256);
    returns ``(mask3 pointer, seed3 pointer), (mask_hper, threshold),
    inv_keep, dtype code``."""
    if q3.device.type != "cuda":
        raise ValueError(f"{kernel} runs on cuda or cpu, got {q3.device}")
    bh, sq, d = q3.shape
    sk = k3.shape[1]
    if k3.shape != (bh, sk, d) or v3.shape != k3.shape:
        raise ValueError(f"k/v must be [{bh}, sk, {d}] and equal-shaped, "
                         f"got k {tuple(k3.shape)} v {tuple(v3.shape)}")
    if q3.dtype not in _WIDE_DTYPES:
        raise TypeError(f"{kernel} kernel takes float32, bfloat16 or "
                        f"float16, got q {q3.dtype}")
    for name, t in (("q", q3), ("k", k3), ("v", v3), *extra):
        if t.dtype != q3.dtype:
            raise TypeError(f"{kernel} kernel takes operands of one type, "
                            f"got {name} {t.dtype} beside q {q3.dtype}")
        if t.device != q3.device:
            raise ValueError(f"{name} is on {t.device}, q on {q3.device}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel} kernel needs a contiguous {name}")
    _flash_route(q3.dtype, d, mask3 is not None, rate)     # head_dim <= 256
    if bh > 65535:
        raise ValueError(f"b*h = {bh} exceeds the kernel grid (65535)")
    hper = 1
    if mask3 is not None:
        if not mask3.is_contiguous():
            raise ValueError(f"{kernel} needs a contiguous mask3")
        hper = bh // mask3.shape[0]
    if rate:
        _check_seed3(kernel, seed3, q3.device)
    ptr = (lambda t: None if t is None else t.data_ptr())
    return ((ptr(mask3), ptr(seed3) if rate else None),
            (hper, _drop_threshold(rate) if rate else 0),
            _inv_keep(rate) if rate else 1.0, _WIDE_DTYPES[q3.dtype])


def _wide_on_tensor_cores(dtype, d: int) -> bool:
    """Whether the wide kernels (#3w, #5w, #6w) run operands of ``dtype``
    at head dim ``d`` on the tensor cores, the one place that decides it
    (the C entries run what the operand code says): 16-bit at every head
    dim (rows TMA cannot read copied by threads), fp32 up to head dim 128
    (as three bf16 planes).  fp32 past 128, where no tile of three planes
    fits, runs the CUDA-core kernels."""
    return dtype != torch.float32 or d <= _WIDE_TC_F32_MAX_HEAD_DIM


def _split_kernel(x3):
    """fp32 ``x3 [bh, s, d]`` as its three bf16 planes ``[3, bh, s, dp]``
    (``apex_flash_wide_split``, uncounted: part of #3w's, #5w's and
    #6w's launches); the plain version :func:`_split_planes` on the
    CPU."""
    if x3.device.type == "cpu":
        return _split_planes(x3)
    bh, s, d = x3.shape
    planes = torch.empty((3, bh, s, d + (-d % 8)), dtype=torch.bfloat16,
                         device=x3.device)
    err = _build.library().apex_flash_wide_split(
        x3.data_ptr(), planes.data_ptr(), bh * s, d,
        _build.stream_ptr(x3.device))
    _build.check(err, "apex_flash_wide_split")
    return planes


def _wide_tc_operands(code, operands):
    """What the wide kernels' C entries take for ``operands`` (q, k, v
    and, for the backward, dout) of type ``code``: fp32 as planes where
    :func:`_wide_on_tensor_cores` says (:func:`_split_kernel`, code
    :data:`_WIDE_F32_PLANES`), else as they are (16-bit at any alignment).
    Returns ``(tensors, code)``; the tensors must outlive the launch's
    enqueue."""
    q3 = operands[0]
    if q3.dtype == torch.float32 and _wide_on_tensor_cores(q3.dtype,
                                                           q3.shape[2]):
        return [_split_kernel(t) for t in operands], _WIDE_F32_PLANES
    return operands, code


def _fwd_wide(q3, k3, v3, causal, scale, causal_off=None, valid=None,
              mask3=None, rate=0.0, seed3=None):
    """#3w, the wide forward (``apex_flash_wide_fwd``, counter
    ``flash_attention_wide``): ``(out, lse)`` as :func:`_fwd_reference`
    gives them, for fp32, bf16 and fp16 operands at head_dim 1..256, with
    ``mask3`` read in place and dropout; on the tensor cores where
    :func:`_wide_on_tensor_cores` says (fp32 split into planes first)."""
    bh, sq, d = q3.shape
    sk = k3.shape[1]
    ptrs, ints, inv_keep, code = _wide_operands(
        "flash_attention_wide", q3, k3, v3, mask3, rate, seed3)
    ops, code = _wide_tc_operands(code, (q3, k3, v3))
    out = torch.empty_like(q3)
    lse = torch.empty((bh, sq), dtype=torch.float32, device=q3.device)
    _build.count("flash_attention_wide")
    err = _build.library().apex_flash_wide_fwd(
        *(t.data_ptr() for t in ops), *ptrs, out.data_ptr(),
        lse.data_ptr(), bh, sq, sk, d, int(causal),
        *_window(sq, sk, causal_off, valid), *ints, inv_keep,
        float(scale * _LOG2E), code, _build.stream_ptr(q3.device))
    _build.check(err, "flash_attention_wide")
    return out, lse


def _wide_bwd_args(kernel, q3, k3, v3, lse, delta, do3):
    """The checks the wide backward kernels add: ``dout`` like q,
    ``lse`` and ``delta`` contiguous fp32 ``[bh, sq]``."""
    bh, sq = q3.shape[0], q3.shape[1]
    if do3.shape != q3.shape:
        raise ValueError(f"dout must be {tuple(q3.shape)}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (bh, sq) or t.dtype != torch.float32 \
                or not t.is_contiguous() or t.device != q3.device:
            raise ValueError(f"{kernel}: {name} must be a contiguous fp32 "
                             f"[{bh}, {sq}] on {q3.device}")


def _dq_wide(q3, k3, v3, lse, delta, do3, causal, scale, causal_off=None,
             valid=None, mask3=None, rate=0.0, seed3=None, tc=None):
    """#5w, the wide dq (``apex_flash_wide_dq``, counter
    ``flash_attention_wide_dq``; operands as :func:`_dq_reference`'s):
    ``dq`` in q's type, written once, no atomics; on the tensor cores as
    :func:`_fwd_wide`.  ``tc``: what :func:`_wide_tc_operands` gave for
    ``(q3, k3, v3, do3)``, where the caller has it (one split for the
    backward's pair); by default made here."""
    name = "flash_attention_wide_dq"
    bh, sq, d = q3.shape
    sk = k3.shape[1]
    ptrs, ints, inv_keep, code = _wide_operands(
        name, q3, k3, v3, mask3, rate, seed3, (("dout", do3),))
    _wide_bwd_args(name, q3, k3, v3, lse, delta, do3)
    ops, code = tc or _wide_tc_operands(code, (q3, k3, v3, do3))
    dq = torch.empty_like(q3)
    _build.count(name)
    err = _build.library().apex_flash_wide_dq(
        *(t.data_ptr() for t in ops),
        lse.data_ptr(), delta.data_ptr(), *ptrs, dq.data_ptr(), bh, sq, sk,
        d, int(causal), *_window(sq, sk, causal_off, valid), *ints, inv_keep,
        float(scale * _LOG2E), float(scale), code,
        _build.stream_ptr(q3.device))
    _build.check(err, name)
    return dq


def _dkv_wide(q3, k3, v3, lse, delta, do3, causal, scale, causal_off=None,
              valid=None, mask3=None, rate=0.0, seed3=None, tc=None):
    """#6w, the wide dk/dv (``apex_flash_wide_dkv``, counter
    ``flash_attention_wide_dkv``; operands as :func:`_dkv_reference`'s):
    ``(dk, dv)`` in the operands' type, each written once; on the tensor
    cores as :func:`_fwd_wide` (``tc`` as :func:`_dq_wide`'s)."""
    name = "flash_attention_wide_dkv"
    bh, sq, d = q3.shape
    sk = k3.shape[1]
    ptrs, ints, inv_keep, code = _wide_operands(
        name, q3, k3, v3, mask3, rate, seed3, (("dout", do3),))
    _wide_bwd_args(name, q3, k3, v3, lse, delta, do3)
    ops, code = tc or _wide_tc_operands(code, (q3, k3, v3, do3))
    dk = torch.empty_like(k3)
    dv = torch.empty_like(v3)
    _build.count(name)
    err = _build.library().apex_flash_wide_dkv(
        *(t.data_ptr() for t in ops),
        lse.data_ptr(), delta.data_ptr(), *ptrs, dk.data_ptr(),
        dv.data_ptr(), bh, sq, sk, d, int(causal),
        *_window(sq, sk, causal_off, valid), *ints, inv_keep,
        float(scale * _LOG2E), float(scale), code,
        _build.stream_ptr(q3.device))
    _build.check(err, name)
    return dk, dv


def _bwd_wide(q3, k3, v3, o3, lse, do3, causal, scale, causal_off=None,
              valid=None, mask3=None, rate=0.0, seed3=None):
    """The wide backward, #5w + #6w (:func:`_bwd`'s route for the
    operands the instances do not take): the operands' checks, then fp32
    split into planes once (:func:`_wide_tc_operands`) and the same
    planes handed to both kernels."""
    if o3.shape != q3.shape:
        raise ValueError(f"out must be {tuple(q3.shape)}")
    md = dict(mask3=mask3, rate=rate, seed3=seed3)
    code = _wide_operands("flash_attention_wide_dq", q3, k3, v3, mask3,
                          rate, seed3, (("dout", do3),))[3]
    tc = _wide_tc_operands(code, (q3, k3, v3, do3))
    args = (q3, k3, v3, lse, _delta(o3, do3), do3, causal, scale,
            causal_off, valid)
    return (_dq_wide(*args, **md, tc=tc), *_dkv_wide(*args, **md, tc=tc))


def _bwd(q3, k3, v3, o3, lse, do3, causal: bool, scale: float,
         causal_off: Optional[int] = None,
         valid: Optional[Tuple[int, int]] = None, mask3=None,
         rate: float = 0.0, seed3=None, head_dim: Optional[int] = None,
         out_dtype=None):
    """Backward over ``[b*h, s, d]`` operands from the forward's output
    and base-2 ``lse``: ``(dq, dk, dv)``, with the forward's ``mask3``
    and dropout (``rate``, ``seed3``).  On the route of
    :func:`_flash_route`: the wide pair #5w + #6w for the operands the
    instances do not take (both JAX routes compute one function;
    :func:`_bwd_wide`); else the one-pass kernel while ``sq * head_dim *
    4 <= _FUSED_BWD_MAX_BYTES``, and the split pair beyond, whose two
    kernels share one mask pre-pass; each kernel's plain version for CPU
    tensors.  ``head_dim`` is the call's real head dim where the operands
    were zero-padded to an instance's (the gate reads it, as the JAX gate
    reads the unpadded one); by default the operands'.  ``out_dtype``
    (JAX's argument; default the operands' type): ``torch.float32`` on
    bf16 operands takes the fp32-output instances without a mask, the
    one-pass kernel's (:func:`_bwd_f32_kernel`) or past the gate the
    split pair's (``f32`` of :func:`_dq_kernel` and :func:`_dkv_kernel`),
    whose dq, dk and dv are never rounded to bf16; the plain versions
    return fp32 likewise.  A CUDA route with no such instance (a mask,
    the wide family's 16-bit operands) raises ``NotImplementedError``
    (ROADMAP V10)."""
    cpu = q3.device.type == "cpu"
    f32 = _f32_out(out_dtype, q3.dtype)
    md = dict(mask3=mask3, rate=rate, seed3=seed3)
    if mask3 is not None:
        _check_mask3(mask3, q3, k3.shape[1])
    family, _ = _flash_route(q3.dtype, q3.shape[2], mask3 is not None, rate)
    if not cpu and family == "wide":
        if f32:
            raise _no_f32_instance(f"the wide family's {q3.dtype} backward")
        return _bwd_wide(q3, k3, v3, o3, lse, do3, causal, scale, causal_off,
                         valid, **md)
    if not _split_bwd(q3.shape[1], q3.shape[2] if head_dim is None
                      else head_dim):
        if cpu:
            return _bwd_reference(q3, k3, v3, o3, lse, do3, causal, scale,
                                  causal_off, valid, **md,
                                  out_dtype=out_dtype)
        if not f32:
            return _bwd_kernel(q3, k3, v3, o3, lse, do3, causal, scale,
                               causal_off, valid, **md)
        if mask3 is not None:
            raise _no_f32_instance("the masked one-pass backward")
        return _bwd_f32_kernel(q3, k3, v3, o3, lse, do3, causal, scale,
                               causal_off, valid, rate, seed3)
    if o3.shape != q3.shape:
        raise ValueError(f"out must be {tuple(q3.shape)}")
    args = (q3, k3, v3, lse, _delta(o3, do3), do3, causal, scale,
            causal_off, valid)
    if cpu:
        return (_dq_reference(*args, **md, out_dtype=out_dtype),
                *_dkv_reference(*args, **md, out_dtype=out_dtype))
    if f32:
        return (_dq_kernel(*args, **md, f32=True),
                *_dkv_kernel(*args, **md, f32=True))
    if mask3 is not None:
        md["scratch"] = _mask_tiles(q3, k3.shape[1], mask3, causal,
                                    causal_off, valid)
    return (_dq_kernel(*args, **md), *_dkv_kernel(*args, **md))


class _FlashAttention(torch.autograd.Function):
    """Counterpart of the JAX ``run`` custom VJP in ``flash_attention``:
    the forward saves ``(q3, k3, v3, mask3, seed3, out, lse)`` (the mask
    and the seed operand are carried as arguments, as ``run_fwd`` carries
    them), the backward is :func:`_bwd` with both and gives them no
    gradient."""

    @staticmethod
    def forward(ctx, q3, k3, v3, causal, scale, mask3, seed3, rate,
                head_dim):
        out, lse = _fwd(q3, k3, v3, causal, scale, mask3=mask3, rate=rate,
                        seed3=seed3)
        ctx.causal, ctx.scale, ctx.rate = causal, scale, rate
        # the real head dim, for the backward's gate, where q3 is padded
        ctx.pad_kw = {} if head_dim == q3.shape[2] else {
            "head_dim": head_dim}
        ctx.save_for_backward(q3, k3, v3, mask3, seed3, out, lse)
        return out

    @staticmethod
    def backward(ctx, do3):
        q3, k3, v3, mask3, seed3, out, lse = ctx.saved_tensors
        dq, dk, dv = _bwd(q3, k3, v3, out, lse, do3.contiguous(),
                          ctx.causal, ctx.scale, mask3=mask3,
                          rate=ctx.rate, seed3=seed3, **ctx.pad_kw)
        return dq, dk, dv, None, None, None, None, None, None


def _check_mask3(mask3, q3, sk):
    bh, sq = q3.shape[0], q3.shape[1]
    if mask3.dtype != torch.bool or mask3.dim() != 3 \
            or tuple(mask3.shape[1:]) != (sq, sk) or mask3.shape[0] < 1 \
            or bh % mask3.shape[0]:
        raise ValueError(
            f"mask3 must be bool [nmask, {sq}, {sk}] with nmask dividing "
            f"b*h = {bh}; got {mask3.dtype} {tuple(mask3.shape)}")
    if mask3.device != q3.device:
        raise ValueError(f"mask3 is on {mask3.device}, q on {q3.device}")


def _fwd(q3, k3, v3, causal: bool, scale: float,
         causal_off: Optional[int] = None,
         valid: Optional[Tuple[int, int]] = None, mask3=None,
         rate: float = 0.0, seed3=None, out_dtype=None):
    """Forward over ``[b*h, s, d]`` operands: ``(out, lse)`` with ``lse``
    the base-2 log-sum-exp ``[b*h, sq]`` (fp32).  ``causal_off``
    defaults to ``sk - sq``; ``valid = (vq, vk)`` masks rows ``>= vq``
    and columns ``>= vk`` (a padded bucket); ``mask3`` (bool ``[nmask,
    sq, sk]``, True = masked, contiguous) masks batch-head ``i`` by
    ``mask3[i // (b*h // nmask)]`` and takes the masked instance;
    ``rate > 0`` drops p for P·V with the keep mask of ``seed3``
    (:func:`_seed_operand`) and takes a dropout instance.  ``out_dtype``
    (JAX's argument; default q's type): ``torch.float32`` on bf16
    operands takes the fp32-output instances (:func:`_fwd_f32_kernel`,
    no mask), whose out is never rounded to bf16; the plain version
    returns fp32 likewise; a CUDA route with no such instance raises
    ``NotImplementedError`` (ROADMAP V10)."""
    bh, sq, d = q3.shape
    sk = k3.shape[1]
    f32 = _f32_out(out_dtype, q3.dtype)
    if mask3 is not None:
        _check_mask3(mask3, q3, sk)
    family, _ = _flash_route(q3.dtype, d, mask3 is not None, rate)
    if q3.device.type == "cpu":
        return _fwd_reference(q3, k3, v3, causal, scale, causal_off, valid,
                              mask3, rate, seed3, out_dtype=out_dtype)
    if f32:
        if family == "wide" or mask3 is not None:
            raise _no_f32_instance(
                "the masked forward" if mask3 is not None
                else f"the wide family's {q3.dtype} forward")
        return _fwd_f32_kernel(q3, k3, v3, causal, scale, causal_off, valid,
                               rate, seed3)
    if family == "wide":
        return _fwd_wide(q3, k3, v3, causal, scale, causal_off, valid,
                         mask3, rate, seed3)
    _check_kernel_operands("flash_attention", q3, k3, v3)
    off, vq, vk = _window(sq, sk, causal_off, valid)
    out = torch.empty_like(q3)
    lse = torch.empty((bh, sq), dtype=torch.float32, device=q3.device)
    lib = _build.library()
    if rate:
        name = ("flash_attention_drop" if mask3 is None
                else "flash_attention_masked_drop")
        ptrs, ints, floats, _keep = _md_operands(name, q3, sk, mask3, rate,
                                                 seed3)
        entry = (lib.apex_flash_attention_fwd_drop if mask3 is None
                 else lib.apex_flash_attention_fwd_masked_drop)
        _build.count(name)
        err = entry(
            q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), *ptrs,
            out.data_ptr(), lse.data_ptr(), bh, sq, sk, d, int(causal), off,
            vq, vk, *ints, *floats, float(scale * _LOG2E),
            _build.stream_ptr(q3.device))
        _build.check(err, name)
        return out, lse
    if mask3 is None:
        _build.count("flash_attention")
        err = lib.apex_flash_attention_fwd(
            q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), out.data_ptr(),
            lse.data_ptr(), bh, sq, sk, d, int(causal), off, vq, vk,
            float(scale * _LOG2E), _build.stream_ptr(q3.device))
        _build.check(err, "flash_attention")
        return out, lse
    if not mask3.is_contiguous():
        raise ValueError("the masked flash kernel needs a contiguous mask3")
    cls, bits = _mask_scratch(mask3.shape[0], sq, sk, q3.device)
    _build.count("flash_attention_masked")
    err = lib.apex_flash_attention_fwd_masked(
        q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), mask3.data_ptr(),
        cls.data_ptr(), bits.data_ptr(), out.data_ptr(), lse.data_ptr(), bh,
        sq, sk, d, int(causal), off, vq, vk, bh // mask3.shape[0],
        float(scale * _LOG2E), _build.stream_ptr(q3.device))
    _build.check(err, "flash_attention_masked")
    return out, lse


def _mask3(mask, b, h, sq, sk):
    """The JAX entry's ``mask3``: ``[mb, sq, sk]`` for a mask of one head,
    ``[b*h, sq, sk]`` for a per-head mask, bool and contiguous."""
    mask = mask.to(torch.bool)
    mb, mh = mask.shape[0], mask.shape[1]
    if mh == 1:
        return mask.expand(mb, 1, sq, sk).reshape(mb, sq, sk).contiguous()
    return mask.expand(b, h, sq, sk).reshape(b * h, sq, sk).contiguous()


def _int_knob(override, env_name: str, default: int) -> int:
    """An int knob as the JAX package reads its crossovers: explicit
    override > the environment variable (unset or empty: not set) >
    ``default``."""
    if override is not None:
        return int(override)
    env = os.environ.get(env_name)
    if env:
        try:
            return int(env)
        except ValueError as e:
            raise ValueError(f"{env_name} must be an int, got "
                             f"{env!r}") from e
    return default


def xla_path_max_seq(override=None) -> int:
    """The JAX entry's short-sequence crossover: explicit override >
    ``APEX_TPU_ATTN_XLA_MAX_SEQ`` > 256.  On a TPU the JAX entry sends a
    padded length at or under it to its XLA chain; on any other backend,
    and so here, ``use_kernel=None`` takes the kernel whatever it is."""
    return _int_knob(override, _XLA_MAX_SEQ_ENV, _XLA_PATH_MAX_SEQ)


def _xla_attention(q, k, v, *, causal, scale, mask, rate=0.0, seed=None):
    """The JAX entry's XLA route (``use_kernel=False``) in plain
    PyTorch: fp32 scores from the operands, the causal triangle at
    offset ``sk - sq``, the boolean mask (True = masked), an fp32
    natural-log softmax, fully masked rows 0 (with a causal triangle or
    a mask), the kernels' dropout (the same keep mask of the global
    coordinates), p rounded to the value dtype for P·V.  Differentiable
    by autograd, mask and dropout included."""
    b, h, sq = q.shape[0], q.shape[1], q.shape[2]
    sk = k.shape[2]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        rows = torch.arange(sq, device=q.device)[:, None]
        cols = torch.arange(sk, device=q.device)[None, :]
        s = torch.where(cols <= rows + (sk - sq), s,
                        torch.full_like(s, _NEG_INF))
    if mask is not None:
        s = torch.where(mask.to(torch.bool), torch.full_like(s, _NEG_INF), s)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    p = p / p.sum(dim=-1, keepdim=True)
    if causal or mask is not None:
        p = torch.where(m <= _MASKED_ROW_THRESH, torch.zeros_like(p), p)
    if rate:
        keep = _keep3(_seed_operand(seed, device=q.device), b * h, sq, sk,
                      rate, q.device).reshape(b, h, sq, sk)
        p = torch.where(keep, p, torch.zeros_like(p)) * _inv_keep(rate)
    return torch.matmul(p.to(v.dtype).float(), v.float()).to(q.dtype)


def _check_block(name, block):
    if block is not None and (isinstance(block, bool)
                              or not isinstance(block, int) or block < 1):
        raise ValueError(f"{name} must be a positive int, got {block!r}")


def flash_attention(q, k, v, *, causal: bool = False, mask=None,
                    sm_scale: Optional[float] = None,
                    block_q: Optional[int] = None,
                    block_k: Optional[int] = None,
                    dropout_rate: float = 0.0, dropout_seed=None,
                    use_kernel: Optional[bool] = None,
                    xla_max_seq: Optional[int] = None):
    """Blockwise attention, ``[b, h, s, d]`` layout, differentiable in
    q, k and v.

    The arguments are checked first, as the JAX entry checks them
    (``ValueError``: a ``dropout_rate`` outside [0, 1), a nonzero rate
    without ``dropout_seed``, a mask not ``[b|1, h|1, sq|1, sk|1]``).
    ``mask`` is boolean, True = masked.

    Routing, the JAX entry's arguments: ``use_kernel=False`` is the JAX
    package's XLA route, plain PyTorch on any device
    (:func:`_xla_attention`, differentiable with a mask too).
    ``use_kernel=True``, an explicit ``block_q`` or ``block_k``, and
    ``use_kernel=None`` take the kernel route: on CUDA the kernels, on
    the CPU their plain versions, on :func:`_flash_route`'s route (any
    sequence lengths): bf16 operands at head dim up to 128 run the wgmma
    instances, zero-padded here to the next head dim an instance takes
    (the scale from the real one); fp32 and fp16 operands, and bf16 past
    128, the wide kernels; a head dim past 256 raises.  The JAX entry's
    ``None`` applies the short-sequence crossover (``xla_max_seq`` >
    ``APEX_TPU_ATTN_XLA_MAX_SEQ`` > 256, :func:`xla_path_max_seq`) on
    TPU backends only and takes the kernel on every other backend, so
    here it takes the kernel whatever the crossover; the crossover is
    still read, and a bad ``APEX_TPU_ATTN_XLA_MAX_SEQ`` raises as in
    JAX.  The CUDA kernels' tiles are their own: ``block_q``/``block_k``
    must be positive ints, force the kernel route and are otherwise
    ignored.  On the kernel route a mask is expanded to the JAX
    package's ``mask3``, which the forward and the backward kernels
    take.

    ``dropout_rate`` > 0 drops attention probabilities on either route
    with the JAX package's keep mask, bit for bit (softmax THEN
    dropout, survivors scaled by ``1 / (1 - rate)``); ``dropout_seed``
    (an int, or an int tensor of one element, which may stay on the
    card) determines it, and the backward regenerates it.  Pass a fresh
    seed each step."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    scale = (d ** -0.5) if sm_scale is None else sm_scale
    # the JAX entry's argument checks, in its order
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"dropout_rate must be in [0, 1), got "
                         f"{dropout_rate}")
    if dropout_rate and dropout_seed is None:
        raise ValueError(
            "dropout_rate > 0 requires dropout_seed (reusing an implicit "
            "constant seed would repeat the same mask every training step)")
    if mask is not None and not (
            mask.dim() == 4 and mask.shape[0] in (1, b)
            and mask.shape[1] in (1, h) and mask.shape[2] in (1, sq)
            and mask.shape[3] in (1, sk)):
        raise ValueError(
            f"mask must be boolean [b|1, h|1, sq|1, sk|1] (broadcastable to "
            f"[{b}, {h}, {sq}, {sk}]); got {tuple(mask.shape)}")
    _check_block("block_q", block_q)
    _check_block("block_k", block_k)
    if use_kernel is None:
        # the JAX entry's rule on a non-TPU backend: the kernel, with
        # the crossover read (and a bad env value raising) unless a
        # block size forced the kernel first
        if block_q is None and block_k is None:
            xla_path_max_seq(xla_max_seq)
        use_kernel = True
    if not use_kernel:
        return _xla_attention(q, k, v, causal=causal, scale=scale,
                              mask=mask, rate=dropout_rate,
                              seed=dropout_seed)
    _, dp = _flash_route(q.dtype, d, mask is not None, dropout_rate)
    mask3 = None if mask is None else _mask3(mask, b, h, sq, sk)
    seed3 = (_seed_operand(dropout_seed, device=q.device) if dropout_rate
             else None)
    q3 = q.reshape(b * h, sq, d).contiguous()
    k3 = k.reshape(b * h, sk, d).contiguous()
    v3 = v.reshape(b * h, sk, d).contiguous()
    if dp != d:
        # the instance's head dim: zero columns add nothing to a score
        # and come out as zero columns of the output, sliced off
        q3, k3, v3 = (torch.nn.functional.pad(t, (0, dp - d))
                      for t in (q3, k3, v3))
    out = _FlashAttention.apply(q3, k3, v3, causal, scale, mask3, seed3,
                                float(dropout_rate), d)
    return out[..., :d].reshape(b, h, sq, d)


def decode_xla_max_seq(override=None) -> int:
    """Effective decode crossover: explicit override >
    ``APEX_TPU_DECODE_XLA_MAX_SEQ`` > 4096."""
    return _int_knob(override, _DECODE_XLA_MAX_SEQ_ENV, _DECODE_XLA_MAX_SEQ)


def decode_attention(q, k, v, lengths, *, sm_scale: Optional[float] = None,
                     use_kernel: Optional[bool] = None,
                     xla_max_seq: Optional[int] = None):
    """Single-token attention against a per-slot KV cache.

    * ``q``: ``[b, h, 1, d]`` (or ``[b, h, d]``), the current token's
      query heads per slot.
    * ``k``/``v``: ``[b, kv_heads, S, d]``, the cache, ``kv_heads``
      dividing ``h`` (GQA/MQA).
    * ``lengths``: ``[b]`` int32 live entries per slot; a slot of length
      0 emits zeros.

    ``use_kernel=None`` takes the JAX package's crossover: at or below
    :func:`decode_xla_max_seq` cached positions the plain grouped chain
    (fp32 scores from the operands, fp32 softmax, p rounded to the value
    dtype for P·V, no kv broadcast materialized); above it, as with
    ``use_kernel=True``, the kernel branch.  The JAX package's kernel
    branch broadcasts k/v to the query heads and runs the masked flash
    kernel with a length mask; here the ``h / kv_heads`` query heads of
    a kv head are the rows of one problem against that kv head's cache,
    read in place (any slot and head strides: one layer's view of the
    ``[slots, layers, kv_heads, S, d]`` cache), with the key-only mask
    taken from ``lengths``: the same function with no broadcast and no
    mask tensor (:func:`_decode_kernel` on CUDA, launch counter
    ``flash_attention_masked``; :func:`_decode_reference` on the CPU).
    A bf16 cache the kernel cannot read in place
    (:func:`_decode_in_place`) runs on a contiguous copy of k and v.
    Caches the decode kernel has no instance for (groups other than 1,
    2, 4, 8; head dims other than 64 and 128; fp32 and fp16) take the
    JAX package's branch, the broadcast and the masked flash forward on
    :func:`_flash_route`'s route (the wide forward #3w, or a padded bf16
    instance)."""
    squeezed = q.dim() == 3
    if squeezed:
        q = q[:, :, None, :]
    b, h, q_len, d = q.shape
    if q_len != 1:
        raise ValueError(
            f"decode_attention is the q_len == 1 path, got q_len {q_len}; "
            "use flash_attention for prefill")
    if k.shape != v.shape or k.dim() != 4 or k.shape[0] != b \
            or k.shape[3] != d:
        raise ValueError(
            f"k/v must be [b, kv_heads, S, d] = [{b}, *, *, {d}] and "
            f"equal-shaped; got k {tuple(k.shape)} v {tuple(v.shape)}")
    kvh, s_cache = k.shape[1], k.shape[2]
    if kvh == 0 or h % kvh:
        raise ValueError(f"kv_heads ({kvh}) must divide query heads ({h})")
    if tuple(lengths.shape) != (b,):
        raise ValueError(f"lengths must be [{b}], got "
                         f"{tuple(lengths.shape)}")
    scale = (d ** -0.5) if sm_scale is None else sm_scale
    lengths = lengths.to(torch.int32)
    if use_kernel is None:
        use_kernel = s_cache > decode_xla_max_seq(xla_max_seq)
    group = h // kvh
    cols = torch.arange(s_cache, dtype=torch.int32, device=q.device)
    if use_kernel:
        qg = q.reshape(b, kvh, group, d)
        if q.device.type == "cpu":
            out = _decode_reference(qg, k, v, lengths, scale)
        elif group in _DECODE_KERNEL_GROUPS \
                and d in _DECODE_KERNEL_HEAD_DIMS \
                and q.dtype == k.dtype == v.dtype == torch.bfloat16:
            if not _decode_in_place(k, v):
                # a layout the kernel cannot step through: a fresh
                # (aligned, contiguous) copy of the layer
                k, v = (t.clone(memory_format=torch.contiguous_format)
                        for t in (k, v))
            out = _decode_kernel(qg.contiguous(), k, v, lengths.contiguous(),
                                 scale)
        else:
            # the JAX package's branch: k/v broadcast to the query heads,
            # then the flash route (#3w, or a padded instance), the three
            # in their promoted type (the kernels take one type)
            dt = torch.promote_types(torch.promote_types(q.dtype, k.dtype),
                                     v.dtype)
            kb, vb = (t[:, :, None].expand(b, kvh, group, s_cache, d)
                      .reshape(b, h, s_cache, d).to(dt) for t in (k, v))
            mask = cols[None, None, None, :] >= lengths[:, None, None, None]
            out = flash_attention(q.to(dt), kb, vb, mask=mask,
                                  sm_scale=scale, use_kernel=True
                                  ).to(q.dtype)
        out = out.reshape(b, h, 1, d)
        return out[:, :, 0] if squeezed else out
    # the plain grouped chain: no kv broadcast materialized
    qg = q.reshape(b, kvh, group, d).float()
    s = torch.einsum("bkgd,bksd->bkgs", qg, k.float()) * scale
    live = cols[None, None, None, :] < lengths[:, None, None, None]
    s = torch.where(live, s, torch.full_like(s, _NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    p = p / p.sum(dim=-1, keepdim=True)
    # length-0 slots: every score is _NEG_INF -- emit 0, not uniform
    p = torch.where(m <= _MASKED_ROW_THRESH, torch.zeros_like(p), p)
    out = torch.einsum("bkgs,bksd->bkgd", p.to(v.dtype).float(), v.float())
    out = out.reshape(b, h, 1, d).to(q.dtype)
    return out[:, :, 0] if squeezed else out


def _decode_reference(qg, k, v, lengths, scale):
    """Plain version of the decode kernel, and the kernel branch's
    function (the masked flash forward's on a key-only length mask):
    ``qg [b, kvh, group, d]`` against ``k``/``v`` ``[b, kvh, S, d]``,
    positions ``>= lengths[slot]`` masked; a base-2 softmax in fp32, p
    rounded to the value dtype for P·V and the normalizer from the fp32
    p; a slot of length 0 emits 0.  Returns ``[b, kvh, group, d]`` in
    q's dtype."""
    s = torch.einsum("bkgd,bksd->bkgs", qg.float(), k.float()) * (
        scale * _LOG2E)
    live = (torch.arange(k.shape[2], device=qg.device)[None, :]
            < lengths.long()[:, None])[:, None, None, :]
    s = torch.where(live, s, torch.full_like(s, _NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(live, torch.exp2(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgs,bksd->bkgd", p.to(v.dtype).float(), v.float())
    return (out / torch.where(l == 0, torch.ones_like(l), l)).to(qg.dtype)


def _decode_in_place(k, v) -> bool:
    """Whether the decode kernel reads ``k``/``v`` ``[b, kv_heads, S,
    d]`` where they lie: equal strides, contiguous ``[S, d]`` rows, slot
    and head strides that are multiples of 8 elements (whole 16-byte
    rows) and 16-byte aligned bases.  ``decode_attention`` copies any
    other layout before the launch."""
    d = k.shape[3]
    return (k.stride() == v.stride() and k.stride(3) == 1
            and k.stride(2) == d and k.stride(1) % 8 == 0
            and k.stride(0) % 8 == 0 and k.data_ptr() % 16 == 0
            and v.data_ptr() % 16 == 0)


def _decode_kernel(qg, k, v, lengths, scale):
    """The decode kernel (``csrc/flash_attention.cu``,
    ``apex_flash_decode``): ``qg [b, kvh, group, d]`` contiguous bf16
    against the cache ``k``/``v`` ``[b, kvh, S, d]`` bf16 read in place
    (rows contiguous; slot and head strides multiples of 8 elements),
    ``lengths [b]`` int32.  The window runs as splits of whole
    64-position tiles by paged decode's plan (from the shapes and the
    SM count, never the lengths), merged inside the launch as paged
    decode merges them.  Counted as ``flash_attention_masked``."""
    from apex_tpu_torch.ops import paged_attention as pa
    b, kvh, group, d = qg.shape
    s_cache = k.shape[2]
    for name, t in (("q", qg), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"decode kernel takes bfloat16, got {name} "
                            f"{t.dtype}")
        if t.device != qg.device:
            raise ValueError(f"{name} is on {t.device}, q on {qg.device}")
    if lengths.device != qg.device:
        raise ValueError(f"lengths is on {lengths.device}, q on {qg.device}")
    if not _decode_in_place(k, v):
        raise ValueError(
            f"k/v must have equal strides, contiguous [S, {d}] rows, slot "
            f"and head strides that are multiples of 8 elements and "
            f"16-byte aligned bases; got k {k.stride()} v {v.stride()}")
    if b > 65535 or kvh > 65535 or s_cache < 1:
        raise ValueError(f"decode kernel takes up to 65535 slots and kv "
                         f"heads and a nonempty cache, got b {b}, kv_heads "
                         f"{kvh}, S {s_cache}")
    tiles = -(-s_cache // _DECODE_TILE)
    plan = pa._plan_splits(b, kvh, group, d, _DECODE_TILE, tiles,
                           pa._sm_count(qg.device))
    out = torch.empty_like(qg)
    f32 = dict(dtype=torch.float32, device=qg.device)
    part_acc = torch.empty(plan.part_acc, **f32) if plan.part_acc else None
    part_ml = torch.empty(plan.part_ml, **f32) if plan.part_ml else None
    stream = _build.stream_ptr(qg.device)
    counters = pa._counters(qg.device, stream, plan.counters) \
        if plan.counters else None
    lib = _build.library()
    _build.count("flash_attention_masked")
    err = lib.apex_flash_decode(
        qg.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), part_acc.data_ptr() if part_acc is not None
        else None, part_ml.data_ptr() if part_ml is not None else None,
        counters.data_ptr() if counters is not None else None, b, kvh,
        group, d, s_cache, k.stride(1), k.stride(0), plan.nsplit,
        plan.pages_per_split, float(scale * _LOG2E), stream)
    if err and counters is not None:
        counters.zero_()      # whatever a failed launch left behind
    _build.check(err, "flash_attention_masked")
    return out


def slab_decode_attention(q, win_k, win_v, lengths,
                          *, sm_scale: Optional[float] = None):
    """Verify-step attention: a slab of ``S`` drafted tokens per slot
    scores the slot's cache window, causally within the slab.

    The slab's own k/v have already been appended at positions
    ``[lengths, lengths + S)``, so query row ``r`` (position ``lengths +
    r``) sees window columns ``j <= lengths + r``; ``S = 1`` is
    :func:`decode_attention`'s masking.

    * ``q``: ``[slots, h, S, d]``.
    * ``win_k``/``win_v``: ``[slots, kv_heads, W, d]``, the slot's whole
      window (the dense cache's layer, or the paged pool's gathered
      window).
    * ``lengths``: ``[slots]`` int32, live tokens before the slab.

    A row past the window (``lengths + r >= W``: its append was
    dropped) is fully masked and emits 0.  Numerics are
    :func:`decode_attention`'s plain grouped chain: fp32 scores from
    the operands, an fp32 softmax, p rounded to the value type for
    P·V, no kv broadcast materialized.  The JAX package computes this in
    XLA with no Pallas kernel; here it is plain PyTorch on every
    device."""
    slots, h, sq, d = q.shape
    if win_k.shape != win_v.shape or win_k.dim() != 4 \
            or win_k.shape[0] != slots or win_k.shape[3] != d:
        raise ValueError(
            f"window k/v must be [{slots}, kv_heads, W, {d}] and "
            f"equal-shaped; got win_k {tuple(win_k.shape)} win_v "
            f"{tuple(win_v.shape)}")
    kvh, w = win_k.shape[1], win_k.shape[2]
    if kvh == 0 or h % kvh:
        raise ValueError(f"kv_heads ({kvh}) must divide query heads ({h})")
    if tuple(lengths.shape) != (slots,):
        raise ValueError(
            f"lengths must be [{slots}], got {tuple(lengths.shape)}")
    scale = (d ** -0.5) if sm_scale is None else sm_scale
    group = h // kvh
    qg = q.reshape(slots, kvh, group, sq, d).float()
    s = torch.einsum("bkgqd,bkwd->bkgqw", qg, win_k.float()) * scale
    col = torch.arange(w, device=q.device)[None, None, :]      # [1, 1, W]
    row = torch.arange(sq, device=q.device)[None, :, None]     # [1, S, 1]
    pos = lengths.long()[:, None, None] + row         # [slots, S, 1]
    # a row past the window masks fully: without the pos < w term it
    # would see the whole window and emit plausible garbage
    live = ((col <= pos) & (pos < w))[:, None, None]   # [slots, 1, 1, S, W]
    s = torch.where(live, s, torch.full_like(s, _NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    p = p / p.sum(dim=-1, keepdim=True)
    # fully masked rows emit 0, not the softmax of a constant
    p = torch.where(m <= _MASKED_ROW_THRESH, torch.zeros_like(p), p)
    out = torch.einsum("bkgqw,bkwd->bkgqd", p.to(win_v.dtype).float(),
                       win_v.float())
    return out.reshape(slots, h, sq, d).to(q.dtype)


def prefix_window_attention(q, k, v, win_k, win_v, start,
                            *, sm_scale: Optional[float] = None):
    """Suffix-prefill attention: each query row attends to a cached
    prefix WINDOW plus causally to the suffix itself.

    * ``q``: ``[b, h, s, d]`` — row ``i`` sits at absolute position
      ``start + i``.
    * ``k``/``v``: ``[b, kv_heads, s, d]`` — the suffix's own
      (pre-broadcast) keys/values.
    * ``win_k``/``win_v``: ``[b, kv_heads, W, d]`` — the cached prefix
      window; only columns ``j < start`` are live.
    * ``start``: the prefix length (int).

    Plain PyTorch, fp32 softmax over the concatenated ``[W + s]`` key
    axis, probabilities rounded to the value dtype for the P·V product
    (the JAX package's XLA chain)."""
    b, h, sq, d = q.shape
    if k.shape != v.shape or k.dim() != 4 or k.shape[0] != b \
            or k.shape[2] != sq or k.shape[3] != d:
        raise ValueError(
            f"suffix k/v must be [b, kv_heads, {sq}, {d}], got "
            f"k {tuple(k.shape)} v {tuple(v.shape)}")
    if win_k.shape != win_v.shape or win_k.dim() != 4 \
            or win_k.shape[:2] != k.shape[:2] or win_k.shape[3] != d:
        raise ValueError(
            f"window k/v must be [b, kv_heads, W, {d}], got "
            f"win_k {tuple(win_k.shape)} win_v {tuple(win_v.shape)}")
    kvh, w = win_k.shape[1], win_k.shape[2]
    if kvh == 0 or h % kvh:
        raise ValueError(
            f"kv_heads ({kvh}) must divide query heads ({h})")
    scale = (d ** -0.5) if sm_scale is None else sm_scale
    group = h // kvh
    qg = q.reshape(b, kvh, group, sq, d).float()
    kk = torch.cat([win_k, k], dim=2).float()          # [b, kvh, W+s, d]
    vv = torch.cat([win_v, v], dim=2)
    s = torch.einsum("bkgqd,bkwd->bkgqw", qg, kk) * scale
    col = torch.arange(w + sq, device=q.device)[None, :]
    row = torch.arange(sq, device=q.device)[:, None]
    valid = torch.where(col < w, col < int(start), (col - w) <= row)
    s = torch.where(valid, s, torch.full_like(s, _NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    p = p / p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgqw,bkwd->bkgqd", p.to(vv.dtype).float(),
                       vv.float())
    return out.reshape(b, h, sq, d).to(q.dtype)
