"""Flat-buffer optimizer kernels: the amp unscale and Adam(W).

Port of the training half of ``apex_tpu/ops/fused_update.py``:

* :func:`fused_scale` — ``flat * scale`` with a fused non-finite flag
  (counterpart of the Pallas ``_scale_kernel``);
* :func:`fused_adam_flat` — one Adam/AdamW step over flat fp32 state
  (counterpart of ``_adam_kernel``), with ``grad_scale`` and the
  ``noop_flag`` overflow skip.

Both kernels are in ``csrc/fused_update.cu``.  As in the JAX package the
hyperparameters, the bias corrections (computed from the step count)
and the noop flag travel to the Adam kernel as one small fp32 vector —
here a DEVICE tensor built with device ops, so a training step reads
nothing back to the host between its backward and its update.  Any of
them may be a Python number or a 0-d tensor.

Where JAX returns new arrays (and donates the old buffers), the port
updates in place: :func:`fused_adam_flat` writes p, m and v where they
are and returns them, and :func:`fused_scale` writes into ``out=``,
which may be the input itself.

The other kernels of the JAX module (axpby, the L2 norms, Adagrad, SGD,
LAMB) are not on the training slice's path and are not ported yet
(ROADMAP queue 2).  A CPU tensor takes the plain versions; a CUDA
tensor launches the kernel or raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from apex_tpu_torch.ops import _build

__all__ = ["fused_scale", "fused_adam_flat", "adam_reference",
           "ADAM_MODE_L2", "ADAM_MODE_ADAMW"]

ADAM_MODE_L2 = 0     # classic Adam: weight decay folded into the gradient
ADAM_MODE_ADAMW = 1  # decoupled weight decay

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _scalar(x, device) -> torch.Tensor:
    """``x`` as a 0-d fp32 tensor on ``device``, made there (a fill, not
    a host-to-device copy) when it is a Python number."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32).reshape(())
    return torch.full((), float(x), dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# scale with non-finite detection (the amp unscale)
# ---------------------------------------------------------------------------

def _scale_reference(flat, scale, out_dtype):
    """Plain version of the scale kernel: ``(out, flag)``."""
    y = flat.float() * scale
    flag = (~torch.isfinite(y)).any().to(torch.float32)
    return y.to(out_dtype), flag


def fused_scale(flat: torch.Tensor, scale, out_dtype=None, *,
                out: Optional[torch.Tensor] = None):
    """``out = flat * scale`` with fused non-finite detection; returns
    ``(out, found_inf)`` with ``found_inf`` a 0-d fp32 tensor (1.0 on any
    inf/nan) on the buffer's device.

    Parity: ``amp_C.multi_tensor_scale``.  ``out=`` (which may be
    ``flat`` itself) receives the result in place."""
    out_dtype = out.dtype if out is not None else (out_dtype or flat.dtype)
    if flat.dim() != 1:
        raise ValueError(f"fused_scale takes a flat buffer, got "
                         f"{tuple(flat.shape)}")
    if out is not None and (out.shape != flat.shape
                            or out.device != flat.device):
        raise ValueError(f"out must be {tuple(flat.shape)} on "
                         f"{flat.device}")
    dev = flat.device
    s = _scalar(scale, dev)
    if dev.type == "cpu":
        y, flag = _scale_reference(flat, s, out_dtype)
        if out is None:
            return y, flag
        out.copy_(y)
        return out, flag
    if dev.type != "cuda":
        raise ValueError(f"fused_scale runs on cuda or cpu, got {dev}")
    if flat.dtype not in _DTYPE_CODE or out_dtype not in _DTYPE_CODE:
        raise TypeError(f"fused_scale kernel takes float32/bfloat16, got "
                        f"{flat.dtype} -> {out_dtype}")
    if not flat.is_contiguous() or (out is not None
                                    and not out.is_contiguous()):
        raise ValueError("fused_scale kernel needs contiguous buffers")
    if out is None:
        out = torch.empty(flat.shape, dtype=out_dtype, device=dev)
    flag = torch.empty((), dtype=torch.float32, device=dev)
    lib = _build.library()
    _build.count("fused_scale")
    err = lib.apex_fused_scale(
        flat.data_ptr(), out.data_ptr(), s.data_ptr(), flag.data_ptr(),
        flat.numel(), _DTYPE_CODE[flat.dtype], _DTYPE_CODE[out_dtype],
        _build.stream_ptr(dev))
    _build.check(err, "fused_scale")
    return out, flag


# ---------------------------------------------------------------------------
# Adam / AdamW
# ---------------------------------------------------------------------------

def _adam_hparams(device, *, lr, beta1, beta2, eps, weight_decay, step,
                  bias_correction, noop_flag, grad_scale) -> torch.Tensor:
    """The kernel's nine-float device vector ``[lr, beta1, beta2, eps,
    weight_decay, 1/bc1, 1/sqrt(bc2), noop, grad_scale]``, the bias
    corrections computed in fp32 from ``step`` on the device, as
    ``fused_adam_flat`` computes them in JAX."""
    b1, b2 = _scalar(beta1, device), _scalar(beta2, device)
    if bias_correction:
        t = _scalar(step, device)
        inv_bc1 = 1.0 / (1.0 - torch.pow(b1, t))
        inv_sqrt_bc2 = torch.rsqrt(1.0 - torch.pow(b2, t))
    else:
        inv_bc1 = inv_sqrt_bc2 = _scalar(1.0, device)
    return torch.stack([
        _scalar(lr, device), b1, b2, _scalar(eps, device),
        _scalar(weight_decay, device), inv_bc1, inv_sqrt_bc2,
        _scalar(noop_flag, device), _scalar(grad_scale, device)])


def _adam_kernel_reference(p, g, m, v, hp, adam_w: bool):
    """Plain version of the Adam kernel, the same fp32 arithmetic over
    the hyperparameter vector: ``(p, m, v)`` new tensors."""
    lr, b1, b2, eps, wd, inv_bc1, inv_sqrt_bc2, noop, gscale = hp.unbind()
    g = g.float() * gscale
    if not adam_w:
        g = g + wd * p
    m_new = b1 * m + (1.0 - b1) * g
    v_new = b2 * v + (1.0 - b2) * g * g
    denom = torch.sqrt(v_new) * inv_sqrt_bc2 + eps
    update = (m_new * inv_bc1) / denom
    if adam_w:
        update = update + wd * p
    p_new = p - lr * update
    skip = noop > 0.0
    return (torch.where(skip, p, p_new), torch.where(skip, m, m_new),
            torch.where(skip, v, v_new))


def fused_adam_flat(p, g, m, v, *, lr, beta1, beta2, eps, weight_decay,
                    step, adam_w_mode=True, bias_correction=True,
                    noop_flag=0.0, grad_scale=1.0):
    """One fused Adam(W) step over flat fp32 state, IN PLACE: p, m and v
    are updated where they are and returned.

    Parity: ``amp_C.multi_tensor_adam`` as driven by ``FusedAdam``.
    ``noop_flag`` > 0 turns the step into a no-op that leaves p, m and
    v bit-identical (overflow skip); ``grad_scale`` folds unscaling into
    the same pass.  ``g`` may be fp32 or bf16."""
    for name, t in (("p", p), ("m", m), ("v", v)):
        if t.dtype != torch.float32 or t.dim() != 1:
            raise TypeError(f"{name} must be a flat fp32 buffer, got "
                            f"{t.dtype} {tuple(t.shape)}")
        if t.shape != p.shape or t.device != p.device:
            raise ValueError(f"{name} must match p: {tuple(p.shape)} on "
                             f"{p.device}")
    if g.shape != p.shape or g.device != p.device:
        raise ValueError(f"g must match p: {tuple(p.shape)} on {p.device}")
    dev = p.device
    hp = _adam_hparams(dev, lr=lr, beta1=beta1, beta2=beta2, eps=eps,
                       weight_decay=weight_decay, step=step,
                       bias_correction=bias_correction, noop_flag=noop_flag,
                       grad_scale=grad_scale)
    if dev.type == "cpu":
        for dst, src in zip((p, m, v), _adam_kernel_reference(
                p, g, m, v, hp, bool(adam_w_mode))):
            dst.copy_(src)
        return p, m, v
    if dev.type != "cuda":
        raise ValueError(f"fused_adam_flat runs on cuda or cpu, got {dev}")
    if g.dtype not in _DTYPE_CODE:
        raise TypeError(f"fused_adam kernel takes float32/bfloat16 grads, "
                        f"got {g.dtype}")
    if not all(t.is_contiguous() for t in (p, g, m, v)):
        raise ValueError("fused_adam kernel needs contiguous buffers")
    lib = _build.library()
    _build.count("fused_adam")
    err = lib.apex_fused_adam(
        p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
        hp.data_ptr(), p.numel(), _DTYPE_CODE[g.dtype],
        int(bool(adam_w_mode)), _build.stream_ptr(dev))
    _build.check(err, "fused_adam")
    return p, m, v


def adam_reference(p, g, m, v, *, lr, beta1, beta2, eps, weight_decay, step,
                   adam_w_mode=True, bias_correction=True, grad_scale=1.0):
    """Plain oracle for :func:`fused_adam_flat` (mirrors
    ``torch.optim.AdamW``); returns new ``(p, m, v)``."""
    p = p.float()
    g = g.float() * grad_scale
    if not adam_w_mode:
        g = g + weight_decay * p
    m = beta1 * m + (1 - beta1) * g
    v = beta2 * v + (1 - beta2) * g * g
    if bias_correction:
        bc1 = 1 - beta1 ** step
        bc2 = 1 - beta2 ** step
    else:
        bc1 = bc2 = 1.0
    update = (m / bc1) / (torch.sqrt(v / bc2) + eps)
    if adam_w_mode:
        update = update + weight_decay * p
    return p - lr * update, m, v
