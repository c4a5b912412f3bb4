"""Fused LayerNorm / RMSNorm forward and backward — CUDA kernels with
plain PyTorch twins.

Port of ``apex_tpu/ops/layer_norm.py``.  The kernels are in
``csrc/layer_norm.cu``:

* the forward, counterpart of the Pallas ``_ln_fwd_kernel``: fp32 row
  statistics, ``rsqrt(stat + eps)``, the fp32 affine, output in the
  input dtype;
* the backward, counterpart of ``_ln_bwd_kernel``: the statistics are
  recomputed from the saved input (nothing but ``x`` and ``w`` is
  saved, as the JAX custom VJPs do), ``dx`` comes out in x's dtype and
  ``dw``/``db`` as fp32 sums over the rows (per-block partials, then a
  second reduction kernel), cast to the weight's dtype by the caller.

Unlike the TPU kernels they take any hidden size (the Pallas
``hidden % 128`` rule was a VMEM tiling rule).  :func:`layer_norm` and
:func:`rms_norm` are differentiable through ``torch.autograd.Function``s.

Dispatch is by the tensor's device only: a CPU tensor takes the plain
version (``*_reference``, the oracle the tests hold against JAX); a
CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from apex_tpu_torch.ops import _build

__all__ = ["layer_norm", "rms_norm", "layer_norm_reference",
           "rms_norm_reference"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: blocks of the backward kernel per SM (each block walks a strided set
#: of rows and writes one row of the dw/db partials)
_BWD_BLOCKS_PER_SM = 4


def layer_norm_reference(x, weight=None, bias=None, eps: float = 1e-5):
    """Plain LayerNorm over the last axis, fp32 statistics."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    xc = x32 - mean
    var = (xc * xc).mean(dim=-1, keepdim=True)
    y = xc * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def rms_norm_reference(x, weight=None, eps: float = 1e-5):
    """Plain RMSNorm over the last axis, fp32 statistics."""
    x32 = x.float()
    ms = (x32 * x32).mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(ms + eps)
    if weight is not None:
        y = y * weight.float()
    return y.to(x.dtype)


def _bwd_reference(x2, w, dy2, eps: float, rms: bool):
    """Plain version of the backward kernel: ``(dx, dw, db)`` with dx in
    x's dtype and dw/db fp32 sums over the rows (db is ``None`` for
    RMSNorm)."""
    x = x2.float()
    dy = dy2.float()
    wf = w.float()
    if rms:
        rstd = torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
        xhat = x * rstd
        wdy = dy * wf
        c2 = (wdy * xhat).mean(dim=-1, keepdim=True)
        dx = (wdy - xhat * c2) * rstd
    else:
        xc = x - x.mean(dim=-1, keepdim=True)
        rstd = torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + eps)
        xhat = xc * rstd
        wdy = dy * wf
        c1 = wdy.mean(dim=-1, keepdim=True)
        c2 = (wdy * xhat).mean(dim=-1, keepdim=True)
        dx = (wdy - c1 - xhat * c2) * rstd
    dw = (dy * xhat).sum(dim=0)
    db = None if rms else dy.sum(dim=0)
    return dx.to(x2.dtype), dw, db


def _check_operands(kernel, x2, w, others):
    if x2.device.type != "cuda":
        raise ValueError(f"{kernel} runs on cuda or cpu, got {x2.device}")
    if x2.dtype not in _DTYPE_CODE or w.dtype not in _DTYPE_CODE:
        raise TypeError(f"{kernel} kernel takes float32/bfloat16, got x "
                        f"{x2.dtype}, weight {w.dtype}")
    hidden = x2.shape[1]
    if w.shape != (hidden,):
        raise ValueError(f"weight must be [{hidden}]")
    for name, t in (("x", x2), ("weight", w), *others):
        if t is None:
            continue
        if t.device != x2.device:
            raise ValueError(f"{name} is on {t.device}, x on {x2.device}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel} kernel needs a contiguous {name}")


def _fwd_2d(x2, w, b: Optional[torch.Tensor], eps: float, rms: bool):
    """Row norm of ``x2 [rows, hidden]``: the kernel on CUDA, the plain
    version on the CPU."""
    if x2.device.type == "cpu":
        if rms:
            return rms_norm_reference(x2, w, eps)
        return layer_norm_reference(x2, w, b, eps)
    _check_operands("layer_norm", x2, w, (("bias", b),))
    rows, hidden = x2.shape
    if b is not None and (b.dtype != w.dtype or b.shape != (hidden,)):
        raise ValueError(f"bias must be [{hidden}] in the weight's dtype "
                         f"{w.dtype}, got {tuple(b.shape)} {b.dtype}")
    y = torch.empty_like(x2)
    lib = _build.library()
    _build.count("layer_norm")
    err = lib.apex_layer_norm_fwd(
        x2.data_ptr(), w.data_ptr(), b.data_ptr() if b is not None else None,
        y.data_ptr(), rows, hidden, float(eps), int(rms),
        _DTYPE_CODE[x2.dtype], _DTYPE_CODE[w.dtype],
        _build.stream_ptr(x2.device))
    _build.check(err, "layer_norm")
    return y


def _bwd_2d(x2, w, dy2, eps: float, rms: bool):
    """Backward of the row norm: ``(dx, dw, db)``, dx in x's dtype, dw
    and db fp32 (db ``None`` for RMSNorm).  The kernel on CUDA, the
    plain version on the CPU."""
    if x2.device.type == "cpu":
        return _bwd_reference(x2, w, dy2, eps, rms)
    _check_operands("layer_norm_bwd", x2, w, (("dy", dy2),))
    if dy2.shape != x2.shape or dy2.dtype != x2.dtype:
        raise ValueError(f"dy must match x: {tuple(x2.shape)} {x2.dtype}, "
                         f"got {tuple(dy2.shape)} {dy2.dtype}")
    rows, hidden = x2.shape
    n_acc = 1 if rms else 2
    if hidden * 4 * n_acc > 227 * 1024:
        raise ValueError(f"layer_norm_bwd kernel keeps {n_acc} fp32 column "
                         f"sums of hidden {hidden} in shared memory; at most "
                         f"{227 * 1024 // (4 * n_acc)} fit")
    sms = torch.cuda.get_device_properties(x2.device).multi_processor_count
    nblocks = max(1, min(rows, _BWD_BLOCKS_PER_SM * sms))
    dx = torch.empty_like(x2)
    f32 = dict(dtype=torch.float32, device=x2.device)
    dw_part = torch.empty((nblocks, hidden), **f32)
    dw = torch.empty((hidden,), **f32)
    db_part = None if rms else torch.empty((nblocks, hidden), **f32)
    db = None if rms else torch.empty((hidden,), **f32)
    lib = _build.library()
    _build.count("layer_norm_bwd")
    err = lib.apex_layer_norm_bwd(
        x2.data_ptr(), w.data_ptr(), dy2.data_ptr(), dx.data_ptr(),
        dw_part.data_ptr(), None if rms else db_part.data_ptr(),
        dw.data_ptr(), None if rms else db.data_ptr(), rows, hidden,
        nblocks, float(eps), int(rms), _DTYPE_CODE[x2.dtype],
        _DTYPE_CODE[w.dtype], _build.stream_ptr(x2.device))
    _build.check(err, "layer_norm_bwd")
    return dx, dw, db


class _LayerNormAffine(torch.autograd.Function):
    """Counterpart of the JAX ``_layer_norm_affine`` custom VJP: saves
    ``x`` and ``w`` only; dw and db come back in w's dtype."""

    @staticmethod
    def forward(ctx, x2, w, b, eps):
        ctx.eps = eps
        ctx.save_for_backward(x2, w)
        return _fwd_2d(x2, w, b, eps, rms=False)

    @staticmethod
    def backward(ctx, dy2):
        x2, w = ctx.saved_tensors
        dx, dw, db = _bwd_2d(x2, w, dy2.contiguous(), ctx.eps, rms=False)
        return dx, dw.to(w.dtype), db.to(w.dtype), None


class _RMSNormAffine(torch.autograd.Function):
    """Counterpart of the JAX ``_rms_norm_affine`` custom VJP."""

    @staticmethod
    def forward(ctx, x2, w, eps):
        ctx.eps = eps
        ctx.save_for_backward(x2, w)
        return _fwd_2d(x2, w, None, eps, rms=True)

    @staticmethod
    def backward(ctx, dy2):
        x2, w = ctx.saved_tensors
        dx, dw, _ = _bwd_2d(x2, w, dy2.contiguous(), ctx.eps, rms=True)
        return dx, dw.to(w.dtype), None


def _flatten_normalized(x, normalized_shape):
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    normalized_shape = tuple(normalized_shape)
    n_norm = 1
    for d in normalized_shape:
        n_norm *= d
    if tuple(x.shape[-len(normalized_shape):]) != normalized_shape:
        raise ValueError(
            f"normalized_shape {normalized_shape} does not match input "
            f"trailing dims {tuple(x.shape)}")
    lead = tuple(x.shape[: x.dim() - len(normalized_shape)])
    return x.reshape(-1, n_norm), lead, normalized_shape, n_norm


def layer_norm(x, weight=None, bias=None, *, normalized_shape=None,
               eps: float = 1e-5):
    """LayerNorm over ``normalized_shape`` (default: the last axis);
    differentiable in x, weight and bias."""
    if normalized_shape is None:
        normalized_shape = (x.shape[-1],)
    x2, lead, nshape, n = _flatten_normalized(x, normalized_shape)
    w = (weight.reshape(n) if weight is not None
         else torch.ones(n, dtype=torch.float32, device=x.device))
    b = (bias.reshape(n) if bias is not None
         else torch.zeros(n, dtype=w.dtype, device=x.device))
    if b.dtype != w.dtype:
        b = b.to(w.dtype)
    out = _LayerNormAffine.apply(x2.contiguous(), w, b, float(eps))
    return out.reshape(*lead, *nshape)


def rms_norm(x, weight=None, *, normalized_shape=None, eps: float = 1e-5):
    """RMSNorm over ``normalized_shape`` (default: the last axis);
    differentiable in x and weight."""
    if normalized_shape is None:
        normalized_shape = (x.shape[-1],)
    x2, lead, nshape, n = _flatten_normalized(x, normalized_shape)
    w = (weight.reshape(n) if weight is not None
         else torch.ones(n, dtype=torch.float32, device=x.device))
    out = _RMSNormAffine.apply(x2.contiguous(), w, float(eps))
    return out.reshape(*lead, *nshape)
