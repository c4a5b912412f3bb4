"""Flash attention forward and backward (CUDA kernels) and the plain
attention functions the serving and training slices use.

Port of ``apex_tpu/ops/attention.py``, ``[b, h, s, d]`` layout:

* :func:`flash_attention` — the fused attention, differentiable through
  a ``torch.autograd.Function``.  On CUDA the forward always runs
  ``csrc/flash_attention.cu`` (the counterpart of the Pallas
  ``_fwd_kernel``): there is no short-sequence crossover to a plain
  path, so a 64-token prefill bucket goes through the kernel too.
  Causal attention honours the offset ``sk - sq``; the kernel's online
  softmax and the returned log-sum-exp are in BASE 2, exactly as
  ``_fwd`` returns them (:func:`_fwd`).  The backward (:func:`_bwd`)
  computes ``delta = rowsum(dO * O)`` in plain PyTorch, as the JAX
  ``_bwd_impl`` does outside its kernels, and takes the JAX package's
  route: while ``sq * d * 4 <= _FUSED_BWD_MAX_BYTES`` (2 MiB: every
  sequence up to 4096 tokens at head_dim 128) the one-pass kernel of
  ``csrc/flash_attention_bwd.cu`` (the counterpart of
  ``_bwd_fused_kernel``), beyond it the split pair in the same source,
  the dq kernel and the dk/dv kernel (``_dq_kernel`` and
  ``_dkv_kernel``).  All consume the base-2 lse.  The one-pass kernel
  adds dq with fp32 bulk reductions in any order, so its dq's last bits
  vary from run to run; the split pair writes every output once, and
  repeats bit for bit.  The ``mask`` operand and dropout are not ported yet
  (ROADMAP queue 1, "mask operand and dropout"): on CUDA they raise
  ``NotImplementedError`` (the CPU plain version takes a mask).
* :func:`mha_reference` — the natural-log oracle.
* :func:`prefix_window_attention` — the warm-prefill attention over a
  cached prefix window plus the causal suffix; plain XLA in the JAX
  package, plain PyTorch here.

A CPU tensor takes the plain version of each kernel; a CUDA tensor
launches the kernel or raises.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from apex_tpu_torch.ops import _build

__all__ = ["flash_attention", "mha_reference", "prefix_window_attention"]

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


def _fwd_reference(q3, k3, v3, causal, scale, causal_off=None, valid=None):
    """Plain version of the kernel: ``(out [bh, sq, d], lse [bh, sq])``
    with the base-2 log-sum-exp and the kernel's masks."""
    bh, sq, d = q3.shape
    sk = k3.shape[1]
    off = (sk - sq) if causal_off is None else causal_off
    s = torch.matmul(q3.float(), k3.float().transpose(1, 2)) * (
        scale * _LOG2E)
    s = torch.where(_live_mask(sq, sk, causal, off, valid, q3.device), s,
                    torch.full_like(s, _NEG_INF))
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
    :func:`_bwd`."""

    @staticmethod
    def forward(ctx, q3, k3, v3, causal, scale):
        out, lse = _fwd(q3, k3, v3, causal, scale)
        ctx.causal, ctx.scale = causal, scale
        ctx.save_for_backward(q3, k3, v3, out, lse)
        return out

    @staticmethod
    def backward(ctx, do3):
        q3, k3, v3, out, lse = ctx.saved_tensors
        dq, dk, dv = _bwd(q3, k3, v3, out, lse, do3.contiguous(),
                          ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


def _fwd(q3, k3, v3, causal: bool, scale: float,
         causal_off: Optional[int] = None,
         valid: Optional[Tuple[int, int]] = None):
    """Forward over ``[b*h, s, d]`` operands: ``(out, lse)`` with ``lse``
    the base-2 log-sum-exp ``[b*h, sq]`` (fp32).  ``causal_off``
    defaults to ``sk - sq``; ``valid = (vq, vk)`` masks rows ``>= vq``
    and columns ``>= vk`` (a padded bucket)."""
    if q3.device.type == "cpu":
        return _fwd_reference(q3, k3, v3, causal, scale, causal_off, valid)
    bh, sq, d = q3.shape
    sk = k3.shape[1]
    _check_kernel_operands("flash_attention", q3, k3, v3)
    off = (sk - sq) if causal_off is None else int(causal_off)
    vq, vk = (sq, sk) if valid is None else (int(valid[0]), int(valid[1]))
    out = torch.empty_like(q3)
    lse = torch.empty((bh, sq), dtype=torch.float32, device=q3.device)
    lib = _build.library()
    _build.count("flash_attention")
    err = lib.apex_flash_attention_fwd(
        q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), out.data_ptr(),
        lse.data_ptr(), bh, sq, sk, d, int(causal), off, vq, vk,
        float(scale * _LOG2E), _build.stream_ptr(q3.device))
    _build.check(err, "flash_attention")
    return out, lse


def flash_attention(q, k, v, *, causal: bool = False, mask=None,
                    sm_scale: Optional[float] = None,
                    dropout_rate: float = 0.0, dropout_seed=None):
    """Blockwise attention, ``[b, h, s, d]`` layout, differentiable in
    q, k and v.

    On CUDA: bf16 operands, head_dim 32/64/128, any sequence lengths
    (the kernels mask the ragged edge themselves).  The arguments are
    checked first, as the JAX entry checks them (``ValueError``: a
    ``dropout_rate`` outside [0, 1), a nonzero rate without
    ``dropout_seed``, a mask not ``[b|1, h|1, sq|1, sk|1]``).  ``mask`` and
    ``dropout_rate > 0`` raise ``NotImplementedError`` on CUDA: the
    dropout mask must match the JAX package's murmur-hash bits, and the
    kernels take no mask operand yet (ROADMAP queue 1, "mask operand
    and dropout")."""
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
    if dropout_rate:
        raise NotImplementedError(
            "attention dropout (the murmur3 keep mask of apex_tpu's "
            "_keep_mask) is not ported yet (ROADMAP queue 1, 'mask "
            "operand and dropout')")
    if mask is not None:
        if q.device.type == "cpu":
            return mha_reference(q, k, v, causal=causal, mask=mask,
                                 sm_scale=scale)
        raise NotImplementedError(
            "the flash_attention kernels take no mask operand yet "
            "(ROADMAP queue 1, 'mask operand and dropout')")
    q3 = q.reshape(b * h, sq, d).contiguous()
    k3 = k.reshape(b * h, sk, d).contiguous()
    v3 = v.reshape(b * h, sk, d).contiguous()
    out = _FlashAttention.apply(q3, k3, v3, causal, scale)
    return out.reshape(b, h, sq, d)


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
