"""Fused LayerNorm / RMSNorm forward — a CUDA kernel with plain PyTorch
twins.

Port of ``apex_tpu/ops/layer_norm.py`` (forward only in this slice; the
backward kernel ``_ln_bwd_kernel`` comes with training).  The kernel is
``csrc/layer_norm.cu``, the counterpart of the Pallas
``_ln_fwd_kernel``: fp32 row statistics, ``rsqrt(stat + eps)``, the fp32
affine, output in the input dtype.  Unlike the TPU kernel it takes any
hidden size (the Pallas ``hidden % 128`` rule was a VMEM tiling rule).

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


def _fwd_2d(x2, w, b: Optional[torch.Tensor], eps: float, rms: bool):
    """Row norm of ``x2 [rows, hidden]``: the kernel on CUDA, the plain
    version on the CPU."""
    if x2.device.type == "cpu":
        if rms:
            return rms_norm_reference(x2, w, eps)
        return layer_norm_reference(x2, w, b, eps)
    if x2.device.type != "cuda":
        raise ValueError(f"layer_norm runs on cuda or cpu, got {x2.device}")
    rows, hidden = x2.shape
    if x2.dtype not in _DTYPE_CODE or w.dtype not in _DTYPE_CODE:
        raise TypeError(f"layer_norm kernel takes float32/bfloat16, got x "
                        f"{x2.dtype}, weight {w.dtype}")
    if b is not None and b.dtype != w.dtype:
        raise TypeError(f"bias dtype {b.dtype} != weight dtype {w.dtype}")
    for name, t in (("x", x2), ("weight", w), ("bias", b)):
        if t is None:
            continue
        if t.device != x2.device:
            raise ValueError(f"{name} is on {t.device}, x on {x2.device}")
        if not t.is_contiguous():
            raise ValueError(f"layer_norm kernel needs a contiguous {name}")
    if w.shape != (hidden,) or (b is not None and b.shape != (hidden,)):
        raise ValueError(f"weight/bias must be [{hidden}]")
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
    """LayerNorm over ``normalized_shape`` (default: the last axis)."""
    if normalized_shape is None:
        normalized_shape = (x.shape[-1],)
    x2, lead, nshape, n = _flatten_normalized(x, normalized_shape)
    w = (weight.reshape(n) if weight is not None
         else torch.ones(n, dtype=torch.float32, device=x.device))
    b = bias.reshape(n) if bias is not None else None
    if b is not None and b.dtype != w.dtype:
        b = b.to(w.dtype)
    out = _fwd_2d(x2, w, b, float(eps), rms=False)
    return out.reshape(*lead, *nshape)


def rms_norm(x, weight=None, *, normalized_shape=None, eps: float = 1e-5):
    """RMSNorm over ``normalized_shape`` (default: the last axis)."""
    if normalized_shape is None:
        normalized_shape = (x.shape[-1],)
    x2, lead, nshape, n = _flatten_normalized(x, normalized_shape)
    w = (weight.reshape(n) if weight is not None
         else torch.ones(n, dtype=torch.float32, device=x.device))
    out = _fwd_2d(x2, w, None, float(eps), rms=True)
    return out.reshape(*lead, *nshape)
