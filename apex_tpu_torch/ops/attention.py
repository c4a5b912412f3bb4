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
  The kernels' backward with a mask, and dropout, are not ported yet
  (ROADMAP queue 1, "mask operand and dropout"): they raise
  ``NotImplementedError``.
* :func:`decode_attention` — single-token attention against the dense
  slot cache: the JAX package's plain grouped chain at or below its
  crossover (:func:`decode_xla_max_seq`, 4096 cached positions), the
  decode kernel above it (``flash_attention_masked``'s q_len-1 kernel:
  the query heads of a kv head scored together against the cache read
  in place, no k/v broadcast; :func:`_decode_kernel`).
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
           "decode_xla_max_seq", "mha_reference", "prefix_window_attention"]

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
_MASK_ITEM = "ROADMAP queue 1, 'mask operand and dropout'"


def mha_reference(q, k, v, *, causal: bool = False, mask=None,
                  sm_scale: Optional[float] = None):
    """Plain oracle: softmax(scale·QKᵀ + mask)·V with fp32 math.
    ``mask`` is boolean, True = masked, broadcastable to
    ``[b, h, sq, sk]``; fully masked rows emit 0."""
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
    return torch.matmul(p, v.float()).to(q.dtype)


def _fwd_reference(q3, k3, v3, causal, scale, causal_off=None, valid=None,
                   mask3=None):
    """Plain version of the kernel: ``(out [bh, sq, d], lse [bh, sq])``
    with the base-2 log-sum-exp and the kernel's masks (``mask3 [nmask,
    sq, sk]`` bool, True = masked, batch-head ``i`` reading mask ``i //
    (bh // nmask)``)."""
    bh, sq, d = q3.shape
    sk = k3.shape[1]
    off = (sk - sq) if causal_off is None else causal_off
    s = torch.matmul(q3.float(), k3.float().transpose(1, 2)) * (
        scale * _LOG2E)
    live = _live_mask(sq, sk, causal, off, valid, q3.device)
    if mask3 is not None:
        nmask = mask3.shape[0]
        live = live & ~mask3[:, None].expand(
            nmask, bh // nmask, sq, sk).reshape(bh, sq, sk)
    s = torch.where(live, s, torch.full_like(s, _NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s - m)
    p = torch.where(m <= _MASKED_ROW_THRESH, torch.zeros_like(p), p)
    l = p.sum(dim=-1, keepdim=True)
    l1 = torch.where(l == 0, torch.ones_like(l), l)
    # p rounds to the value dtype for the P·V product, as the kernel's
    # tensor-core feed does; the normalizer keeps the fp32 p
    out = torch.matmul(p.to(v3.dtype).float(), v3.float()) / l1
    lse = (m + torch.log2(l1))[..., 0]
    return out.to(q3.dtype), lse


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


def _live_mask(sq, sk, causal, off, valid, device):
    rows = torch.arange(sq, device=device)[:, None]
    cols = torch.arange(sk, device=device)[None, :]
    live = torch.ones(sq, sk, dtype=torch.bool, device=device)
    if causal:
        live &= rows + off >= cols
    if valid is not None:
        live &= (rows < valid[0]) & (cols < valid[1])
    return live


def _recompute_p(q3, k3, lse, causal, scale, off, valid):
    """``_recompute_p``'s plain version: ``p = exp2(s - lse)`` in fp32
    with the kernels' masks and the fully-masked-row guard."""
    sq, sk = q3.shape[1], k3.shape[1]
    s = torch.matmul(q3.float(), k3.float().transpose(1, 2)) * (
        scale * _LOG2E)
    s = torch.where(_live_mask(sq, sk, causal, off, valid, q3.device), s,
                    torch.full_like(s, _NEG_INF))
    p = torch.exp2(s - lse[..., None])
    return torch.where(lse[..., None] <= _MASKED_ROW_THRESH,
                       torch.zeros_like(p), p)


def _ds(p, v3, do3, delta, dtype):
    """``ds = p (dp - delta)`` with ``dp = dO V^T``, rounded to ``dtype``
    (the matrix units' feed) and returned in fp32."""
    dp = torch.matmul(do3.float(), v3.float().transpose(1, 2))
    return (p * (dp - delta[..., None])).to(dtype).float()


def _dq_reference(q3, k3, v3, lse, delta, do3, causal, scale,
                  causal_off=None, valid=None):
    """Plain version of the split dq kernel: ``dq`` in q's dtype from
    the base-2 lse and ``delta = rowsum(dO * O)``."""
    sq, sk = q3.shape[1], k3.shape[1]
    off = (sk - sq) if causal_off is None else causal_off
    p = _recompute_p(q3, k3, lse, causal, scale, off, valid)
    ds = _ds(p, v3, do3, delta, q3.dtype)
    return (scale * torch.matmul(ds, k3.float())).to(q3.dtype)


def _dkv_reference(q3, k3, v3, lse, delta, do3, causal, scale,
                   causal_off=None, valid=None):
    """Plain version of the split dk/dv kernel: ``(dk, dv)`` in the
    operands' dtypes; p and ds round to the operand dtype before their
    products, as the kernels feed their matrix units."""
    sq, sk = q3.shape[1], k3.shape[1]
    off = (sk - sq) if causal_off is None else causal_off
    p = _recompute_p(q3, k3, lse, causal, scale, off, valid)
    dv = torch.matmul(p.to(do3.dtype).float().transpose(1, 2), do3.float())
    ds = _ds(p, v3, do3, delta, q3.dtype)
    dk = scale * torch.matmul(ds.transpose(1, 2), q3.float())
    return dk.to(k3.dtype), dv.to(v3.dtype)


def _delta(o3, do3):
    """``rowsum(dO * O)`` in fp32, outside the kernels as in
    ``_bwd_impl``."""
    return (do3.float() * o3).sum(dim=-1)    # o3 promoted in the product


def _bwd_reference(q3, k3, v3, o3, lse, do3, causal, scale,
                   causal_off=None, valid=None):
    """Plain version of the backward: ``(dq, dk, dv)`` in the operands'
    dtype from the base-2 lse, with ``_recompute_p``'s masks and
    fully-masked-row guard -- the composition of the split pair's plain
    versions (the one-pass kernel computes the same function)."""
    delta = _delta(o3, do3)
    args = (q3, k3, v3, lse, delta, do3, causal, scale, causal_off, valid)
    return (_dq_reference(*args), *_dkv_reference(*args))


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
    off = (sk - sq) if causal_off is None else int(causal_off)
    vq, vk = (sq, sk) if valid is None else (int(valid[0]), int(valid[1]))
    return (bh, sq, sk, d, int(causal), off, vq, vk, float(scale * _LOG2E),
            float(scale))


def _dq_kernel(q3, k3, v3, lse, delta, do3, causal, scale, causal_off=None,
               valid=None):
    """The split backward's dq kernel (operands as
    :func:`_dq_reference`'s): ``dq`` bf16, written once, no atomics."""
    dims = _kernel_args("flash_attention_bwd_dq", q3, k3, v3, lse, do3,
                        causal, scale, causal_off, valid)
    dq = torch.empty_like(q3)
    lib = _build.library()
    _build.count("flash_attention_bwd_dq")
    err = lib.apex_flash_attention_bwd_dq(
        q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), do3.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), *dims,
        _build.stream_ptr(q3.device))
    _build.check(err, "flash_attention_bwd_dq")
    return dq


def _dkv_kernel(q3, k3, v3, lse, delta, do3, causal, scale, causal_off=None,
                valid=None):
    """The split backward's dk/dv kernel (operands as
    :func:`_dkv_reference`'s): ``(dk, dv)`` bf16."""
    dims = _kernel_args("flash_attention_bwd_dkv", q3, k3, v3, lse, do3,
                        causal, scale, causal_off, valid)
    dk = torch.empty_like(k3)
    dv = torch.empty_like(v3)
    lib = _build.library()
    _build.count("flash_attention_bwd_dkv")
    err = lib.apex_flash_attention_bwd_dkv(
        q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), do3.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        *dims, _build.stream_ptr(q3.device))
    _build.check(err, "flash_attention_bwd_dkv")
    return dk, dv


def _bwd_kernel(q3, k3, v3, o3, lse, do3, causal, scale, causal_off=None,
                valid=None):
    """The one-pass backward kernel: ``(dq, dk, dv)`` bf16, dq added
    with fp32 bulk reductions into a scratch buffer and then cast."""
    dims = _kernel_args("flash_attention_bwd", q3, k3, v3, lse, do3, causal,
                        scale, causal_off, valid, (("out", o3),))
    if o3.shape != q3.shape:
        raise ValueError(f"out must be {tuple(q3.shape)}")
    delta = _delta(o3, do3)
    dq_acc = torch.empty(q3.shape, dtype=torch.float32, device=q3.device)
    dq = torch.empty_like(q3)
    dk = torch.empty_like(k3)
    dv = torch.empty_like(v3)
    lib = _build.library()
    _build.count("flash_attention_bwd")
    err = lib.apex_flash_attention_bwd(
        q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), do3.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq_acc.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), *dims, _build.stream_ptr(q3.device))
    _build.check(err, "flash_attention_bwd")
    return dq, dk, dv


def _bwd(q3, k3, v3, o3, lse, do3, causal: bool, scale: float,
         causal_off: Optional[int] = None,
         valid: Optional[Tuple[int, int]] = None):
    """Backward over ``[b*h, s, d]`` operands from the forward's output
    and base-2 ``lse``: ``(dq, dk, dv)``.  The one-pass kernel while
    ``sq * d * 4 <= _FUSED_BWD_MAX_BYTES``, else the split pair; each
    kernel's plain version for CPU tensors."""
    cpu = q3.device.type == "cpu"
    if not _split_bwd(q3.shape[1], q3.shape[2]):
        return (_bwd_reference if cpu else _bwd_kernel)(
            q3, k3, v3, o3, lse, do3, causal, scale, causal_off, valid)
    if o3.shape != q3.shape:
        raise ValueError(f"out must be {tuple(q3.shape)}")
    args = (q3, k3, v3, lse, _delta(o3, do3), do3, causal, scale,
            causal_off, valid)
    dq = (_dq_reference if cpu else _dq_kernel)(*args)
    dk, dv = (_dkv_reference if cpu else _dkv_kernel)(*args)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """Counterpart of the JAX ``run`` custom VJP in ``flash_attention``:
    the forward saves ``(q3, k3, v3, out, lse)``, the backward is
    :func:`_bwd` (with a mask it raises: not ported yet)."""

    @staticmethod
    def forward(ctx, q3, k3, v3, causal, scale, mask3):
        out, lse = _fwd(q3, k3, v3, causal, scale, mask3=mask3)
        ctx.causal, ctx.scale = causal, scale
        ctx.masked = mask3 is not None
        ctx.save_for_backward(q3, k3, v3, out, lse)
        return out

    @staticmethod
    def backward(ctx, do3):
        if ctx.masked:
            raise NotImplementedError(
                "the flash backward with a mask operand is not ported yet "
                f"({_MASK_ITEM})")
        q3, k3, v3, out, lse = ctx.saved_tensors
        dq, dk, dv = _bwd(q3, k3, v3, out, lse, do3.contiguous(),
                          ctx.causal, ctx.scale)
        return dq, dk, dv, None, None, None


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
         valid: Optional[Tuple[int, int]] = None, mask3=None):
    """Forward over ``[b*h, s, d]`` operands: ``(out, lse)`` with ``lse``
    the base-2 log-sum-exp ``[b*h, sq]`` (fp32).  ``causal_off``
    defaults to ``sk - sq``; ``valid = (vq, vk)`` masks rows ``>= vq``
    and columns ``>= vk`` (a padded bucket); ``mask3`` (bool ``[nmask,
    sq, sk]``, True = masked, contiguous) masks batch-head ``i`` by
    ``mask3[i // (b*h // nmask)]`` and takes the masked instance."""
    bh, sq, d = q3.shape
    sk = k3.shape[1]
    if mask3 is not None:
        _check_mask3(mask3, q3, sk)
    if q3.device.type == "cpu":
        return _fwd_reference(q3, k3, v3, causal, scale, causal_off, valid,
                              mask3)
    _check_kernel_operands("flash_attention", q3, k3, v3)
    off = (sk - sq) if causal_off is None else int(causal_off)
    vq, vk = (sq, sk) if valid is None else (int(valid[0]), int(valid[1]))
    out = torch.empty_like(q3)
    lse = torch.empty((bh, sq), dtype=torch.float32, device=q3.device)
    lib = _build.library()
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
    # the pre-pass's scratch: a class a (mask, 128-query block, 128-key
    # tile) and the tile's mask bits in the product threads' order
    tiles = mask3.shape[0] * -(-sq // _MASK_TILE) * -(-sk // _MASK_TILE)
    cls = torch.empty(tiles, dtype=torch.uint8, device=q3.device)
    bits = torch.empty(tiles * _MASK_TILE * 4, dtype=torch.int32,
                       device=q3.device)
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


def _xla_attention(q, k, v, *, causal, scale, mask):
    """The JAX entry's XLA route (``use_kernel=False``) in plain
    PyTorch: fp32 scores from the operands, the causal triangle at
    offset ``sk - sq``, the boolean mask (True = masked), an fp32
    natural-log softmax, fully masked rows 0 (with a causal triangle or
    a mask), p rounded to the value dtype for P·V.  Differentiable by
    autograd, mask included."""
    sq, sk = q.shape[2], k.shape[2]
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
    q, k and v (on the kernel route without a mask).

    The arguments are checked first, as the JAX entry checks them
    (``ValueError``: a ``dropout_rate`` outside [0, 1), a nonzero rate
    without ``dropout_seed``, a mask not ``[b|1, h|1, sq|1, sk|1]``).
    ``mask`` is boolean, True = masked.

    Routing, the JAX entry's arguments: ``use_kernel=False`` is the JAX
    package's XLA route, plain PyTorch on any device
    (:func:`_xla_attention`, differentiable with a mask too).
    ``use_kernel=True``, an explicit ``block_q`` or ``block_k``, and
    ``use_kernel=None`` take the kernel route: on CUDA the kernels
    (bf16 operands, head_dim 32/64/128, any sequence lengths), on the
    CPU their plain versions.  The JAX entry's ``None`` applies the
    short-sequence crossover (``xla_max_seq`` >
    ``APEX_TPU_ATTN_XLA_MAX_SEQ`` > 256, :func:`xla_path_max_seq`) on
    TPU backends only and takes the kernel on every other backend, so
    here it takes the kernel whatever the crossover; the crossover is
    still read, and a bad ``APEX_TPU_ATTN_XLA_MAX_SEQ`` raises as in
    JAX.  The CUDA kernels' tiles are their own: ``block_q``/``block_k``
    must be positive ints, force the kernel route and are otherwise
    ignored.  On the kernel route a mask is expanded to the JAX
    package's ``mask3`` and the forward takes the masked kernel, whose
    backward is not ported yet; ``dropout_rate > 0`` raises
    ``NotImplementedError`` on either route: the dropout mask must
    match the JAX package's murmur-hash bits (ROADMAP queue 1, "mask
    operand and dropout")."""
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
    if dropout_rate:
        raise NotImplementedError(
            "attention dropout (the murmur3 keep mask of apex_tpu's "
            f"_keep_mask) is not ported yet ({_MASK_ITEM})")
    if not use_kernel:
        return _xla_attention(q, k, v, causal=causal, scale=scale,
                              mask=mask)
    mask3 = None if mask is None else _mask3(mask, b, h, sq, sk)
    q3 = q.reshape(b * h, sq, d).contiguous()
    k3 = k.reshape(b * h, sk, d).contiguous()
    v3 = v.reshape(b * h, sk, d).contiguous()
    out = _FlashAttention.apply(q3, k3, v3, causal, scale, mask3)
    return out.reshape(b, h, sq, d)


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
    Query groups and head dims the decode kernel has no instance for
    (groups other than 1, 2, 4, 8; head_dim 32) take the JAX package's
    branch, the broadcast and the masked flash forward."""
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
                and d in _DECODE_KERNEL_HEAD_DIMS:
            out = _decode_kernel(qg.contiguous(), k, v, lengths.contiguous(),
                                 scale)
        else:
            # the JAX package's branch: k/v broadcast to the query heads
            kb, vb = (t[:, :, None].expand(b, kvh, group, s_cache, d)
                      .reshape(b, h, s_cache, d) for t in (k, v))
            mask = cols[None, None, None, :] >= lengths[:, None, None, None]
            out = flash_attention(q, kb, vb, mask=mask, sm_scale=scale,
                                  use_kernel=True)
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
    if k.stride() != v.stride() or k.stride(3) != 1 or k.stride(2) != d \
            or k.stride(1) % 8 or k.stride(0) % 8:
        raise ValueError(
            f"k/v must have equal strides, contiguous [S, {d}] rows and "
            f"slot and head strides that are multiples of 8 elements; got "
            f"k {k.stride()} v {v.stride()}")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("k/v must be 16-byte aligned")
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
