"""Flash-attention forward (CUDA kernel) and the plain attention
functions the serving slice uses.

Port of ``apex_tpu/ops/attention.py``, ``[b, h, s, d]`` layout:

* :func:`flash_attention` — the fused forward.  On CUDA it always runs
  ``csrc/flash_attention.cu`` (the counterpart of the Pallas
  ``_fwd_kernel``): there is no short-sequence crossover to a plain
  path, so a 64-token prefill bucket goes through the kernel too.
  Causal attention honours the offset ``sk - sq``; the kernel's online
  softmax and the returned log-sum-exp are in BASE 2, exactly as
  ``_fwd`` returns them (:func:`_fwd`).  The ``mask`` operand and
  dropout come with the training slice: on CUDA they raise
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
    rows = torch.arange(sq, device=q3.device)[:, None]
    cols = torch.arange(sk, device=q3.device)[None, :]
    live = torch.ones(sq, sk, dtype=torch.bool, device=q3.device)
    if causal:
        live &= rows + off >= cols
    if valid is not None:
        live &= (rows < valid[0]) & (cols < valid[1])
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


def _fwd(q3, k3, v3, causal: bool, scale: float,
         causal_off: Optional[int] = None,
         valid: Optional[Tuple[int, int]] = None):
    """Forward over ``[b*h, s, d]`` operands: ``(out, lse)`` with ``lse``
    the base-2 log-sum-exp ``[b*h, sq]`` (fp32).  ``causal_off``
    defaults to ``sk - sq``; ``valid = (vq, vk)`` masks rows ``>= vq``
    and columns ``>= vk`` (a padded bucket)."""
    if q3.device.type == "cpu":
        return _fwd_reference(q3, k3, v3, causal, scale, causal_off, valid)
    if q3.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, got "
                         f"{q3.device}")
    bh, sq, d = q3.shape
    sk = k3.shape[1]
    if k3.shape != (bh, sk, d) or v3.shape != k3.shape:
        raise ValueError(f"k/v must be [{bh}, sk, {d}] and equal-shaped, "
                         f"got k {tuple(k3.shape)} v {tuple(v3.shape)}")
    for name, t in (("q", q3), ("k", k3), ("v", v3)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"flash_attention kernel takes bfloat16, got "
                            f"{name} {t.dtype}")
        if t.device != q3.device:
            raise ValueError(f"{name} is on {t.device}, q on {q3.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_attention kernel needs a contiguous, "
                             f"16-byte aligned {name}")
    if d not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head_dim in "
                         f"{_KERNEL_HEAD_DIMS}, got {d}")
    if bh > 65535:
        raise ValueError(f"b*h = {bh} exceeds the kernel grid (65535)")
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
    """Blockwise attention forward, ``[b, h, s, d]`` layout.

    On CUDA: bf16 operands, head_dim 32/64/128, any sequence lengths
    (the kernel masks the ragged edge itself).  ``mask`` and
    ``dropout_rate > 0`` raise ``NotImplementedError`` on CUDA: the
    dropout mask must match the JAX package's murmur-hash bits, which
    comes with the training slice (ROADMAP queue 1)."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    scale = (d ** -0.5) if sm_scale is None else sm_scale
    if dropout_rate:
        raise NotImplementedError(
            "attention dropout (the murmur3 keep mask of apex_tpu's "
            "_keep_mask) comes with the training slice")
    if mask is not None:
        if q.device.type == "cpu":
            return mha_reference(q, k, v, causal=causal, mask=mask,
                                 sm_scale=scale)
        raise NotImplementedError(
            "the flash_attention kernel takes no mask operand yet "
            "(training slice)")
    q3 = q.reshape(b * h, sq, d).contiguous()
    k3 = k.reshape(b * h, sk, d).contiguous()
    v3 = v.reshape(b * h, sk, d).contiguous()
    out, _ = _fwd(q3, k3, v3, causal, scale)
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
