"""Flat-buffer optimizer kernels: the amp unscale, the L2 norm and the
Adam(W), LAMB (phase 1), SGD and Adagrad updates.

Port of the training half of ``apex_tpu/ops/fused_update.py``:

* :func:`fused_scale` — ``flat * scale`` with a fused non-finite flag
  (counterpart of the Pallas ``_scale_kernel``);
* :func:`fused_l2norm` — the L2 norm of a flat buffer (``_l2norm_kernel``);
* :func:`fused_adam_flat` — one Adam/AdamW step over flat fp32 state
  (``_adam_kernel``), with ``grad_scale`` and the ``noop_flag``
  overflow skip;
* :func:`fused_lamb_phase1_flat` — LAMB's moments and raw direction
  (``_lamb1_kernel``);
* :func:`fused_sgd_flat` — torch-SGD with momentum (``_sgd_kernel``);
* :func:`fused_adagrad_flat` — Adagrad (``_adagrad_kernel``).

All kernels are in ``csrc/fused_update.cu``.  As in the JAX package the
hyperparameters, the bias corrections (computed from the step count)
and the noop flag travel to an update kernel as one small fp32 vector —
here a DEVICE tensor built with device ops, so a training step reads
nothing back to the host between its backward and its update.  Any of
them may be a Python number or a 0-d tensor.  Beside each kernel is its
plain version over the same vector (``_*_kernel_reference``).

Where JAX returns new arrays (and donates the old buffers), the port
updates in place: the update wrappers write p and their slots where
they are and return them, :func:`fused_scale` writes into ``out=``
(which may be the input itself) and :func:`fused_l2norm` may write its
norm into a caller's 0-d ``out=`` (one slot of a vector of norms).
Port-only: :func:`fused_lamb_phase1_flat` takes ``noop_flag=`` (on a
skipped step m and v stay bit-identical and u is zero) and writes u
into a caller's buffer ``u=``.

The remaining kernels of the JAX module (axpby and the fused
scale-and-norm, reached only by the ``multi_tensor_apply`` shim) are not
ported yet (ROADMAP queue 2).  A CPU tensor takes the plain versions; a
CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from apex_tpu_torch.ops import _build

__all__ = ["fused_scale", "fused_l2norm", "fused_adam_flat",
           "fused_lamb_phase1_flat", "fused_sgd_flat", "fused_adagrad_flat",
           "adam_reference", "ADAM_MODE_L2", "ADAM_MODE_ADAMW"]

ADAM_MODE_L2 = 0     # classic Adam: weight decay folded into the gradient
ADAM_MODE_ADAMW = 1  # decoupled weight decay

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: the plain update versions run over slices of this many elements, so
#: their temporaries stay small beside a 1.9e9-element buffer
_PLAIN_CHUNK = 1 << 26


def _scalar(x, device) -> torch.Tensor:
    """``x`` as a 0-d fp32 tensor on ``device``, made there (a fill, not
    a host-to-device copy) when it is a Python number."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32).reshape(())
    return torch.full((), float(x), dtype=torch.float32, device=device)


def _route(dev, name: str, plain, kernel):
    """The plain version for a CPU buffer, the kernel for a CUDA one."""
    if dev.type == "cpu":
        return plain
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, got {dev}")
    return kernel


def _check_flat_state(p, g, **slots) -> None:
    """p and every slot flat fp32 buffers of one shape and device, g of
    the same shape and device."""
    for name, t in (("p", p), *slots.items()):
        if t.dtype != torch.float32 or t.dim() != 1:
            raise TypeError(f"{name} must be a flat fp32 buffer, got "
                            f"{t.dtype} {tuple(t.shape)}")
        if t.shape != p.shape or t.device != p.device:
            raise ValueError(f"{name} must match p: {tuple(p.shape)} on "
                             f"{p.device}")
    if g.shape != p.shape or g.device != p.device:
        raise ValueError(f"g must match p: {tuple(p.shape)} on {p.device}")


def _check_kernel_operands(name: str, g, *bufs) -> None:
    if g.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name} kernel takes float32/bfloat16 grads, got "
                        f"{g.dtype}")
    if not all(t.is_contiguous() for t in (g, *bufs)):
        raise ValueError(f"{name} kernel needs contiguous buffers")


def _apply_plain(reference, outs, ins, *args) -> None:
    """``outs[k] <- reference(*ins, *args)[k]``, slice by slice."""
    n = ins[0].numel()
    for i in range(0, n, _PLAIN_CHUNK):
        sl = slice(i, min(i + _PLAIN_CHUNK, n))
        for dst, src in zip(outs, reference(*(t[sl] for t in ins), *args)):
            dst[sl].copy_(src)


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
# L2 norm (the grad clipper, LAMB's global and per-leaf norms)
# ---------------------------------------------------------------------------

#: the norm kernel's scratch: one fp32 partial sum per block of its grid,
#: which has at most this many blocks (16 per SM of an H100)
_L2NORM_PARTS = 132 * 16


def _sumsq(flat):
    x = flat.float()
    return torch.sum(x * x)


def _l2norm_reference(flat):
    """Plain version of the norm kernel: sqrt of the fp32 sum of
    squares."""
    return torch.sqrt(_sumsq(flat))


def _l2norm_plain(flat, out) -> None:
    # fp32 sums of squares of the slices, then their sum
    sq = torch.zeros((), dtype=torch.float32, device=flat.device)
    for i in range(0, flat.numel(), _PLAIN_CHUNK):
        sq = sq + _sumsq(flat[i:i + _PLAIN_CHUNK])
    out.copy_(torch.sqrt(sq))


def _l2norm_kernel(flat, out) -> None:
    if flat.dtype not in _DTYPE_CODE:
        raise TypeError(f"fused_l2norm kernel takes float32/bfloat16, got "
                        f"{flat.dtype}")
    if not flat.is_contiguous():
        raise ValueError("fused_l2norm kernel needs a contiguous buffer")
    parts = torch.empty(_L2NORM_PARTS, dtype=torch.float32,
                        device=flat.device)
    lib = _build.library()
    _build.count("fused_l2norm")
    err = lib.apex_fused_l2norm(
        flat.data_ptr(), parts.data_ptr(), out.data_ptr(), flat.numel(),
        _L2NORM_PARTS, _DTYPE_CODE[flat.dtype], _build.stream_ptr(flat.device))
    _build.check(err, "fused_l2norm")


def fused_l2norm(flat: torch.Tensor, *,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """L2 norm of a flat buffer in one fused pass: a 0-d fp32 tensor on
    the buffer's device (0 for an empty buffer).  ``out=``, a 0-d fp32
    tensor on that device (a view into a vector of norms, say), receives
    it instead of a new tensor.

    Parity: ``amp_C.multi_tensor_l2norm``.  On the card the sum runs in
    a fixed order, so the same buffer gives the same bits every run."""
    if flat.dim() != 1:
        raise ValueError(f"fused_l2norm takes a flat buffer, got "
                         f"{tuple(flat.shape)}")
    dev = flat.device
    if out is None:
        out = torch.empty((), dtype=torch.float32, device=dev)
    elif out.shape != () or out.dtype != torch.float32 or out.device != dev:
        raise ValueError(f"out must be a 0-d float32 tensor on {dev}")
    _route(dev, "fused_l2norm", _l2norm_plain, _l2norm_kernel)(flat, out)
    return out


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


def _adam_plain(p, g, m, v, hp, adam_w) -> None:
    _apply_plain(_adam_kernel_reference, (p, m, v), (p, g, m, v), hp, adam_w)


def _adam_kernel(p, g, m, v, hp, adam_w) -> None:
    _check_kernel_operands("fused_adam", g, p, m, v)
    lib = _build.library()
    _build.count("fused_adam")
    err = lib.apex_fused_adam(
        p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
        hp.data_ptr(), p.numel(), _DTYPE_CODE[g.dtype], int(adam_w),
        _build.stream_ptr(p.device))
    _build.check(err, "fused_adam")


def fused_adam_flat(p, g, m, v, *, lr, beta1, beta2, eps, weight_decay,
                    step, adam_w_mode=True, bias_correction=True,
                    noop_flag=0.0, grad_scale=1.0):
    """One fused Adam(W) step over flat fp32 state, IN PLACE: p, m and v
    are updated where they are and returned.

    Parity: ``amp_C.multi_tensor_adam`` as driven by ``FusedAdam``.
    ``noop_flag`` > 0 turns the step into a no-op that leaves p, m and
    v bit-identical (overflow skip); ``grad_scale`` folds unscaling into
    the same pass.  ``g`` may be fp32 or bf16."""
    _check_flat_state(p, g, m=m, v=v)
    dev = p.device
    hp = _adam_hparams(dev, lr=lr, beta1=beta1, beta2=beta2, eps=eps,
                       weight_decay=weight_decay, step=step,
                       bias_correction=bias_correction, noop_flag=noop_flag,
                       grad_scale=grad_scale)
    _route(dev, "fused_adam_flat", _adam_plain, _adam_kernel)(
        p, g, m, v, hp, bool(adam_w_mode))
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


# ---------------------------------------------------------------------------
# LAMB, phase 1 (moments and the raw direction; the trust ratios are
# applied per leaf by the optimizer, where the leaf boundaries are known)
# ---------------------------------------------------------------------------

def _lamb1_hparams(device, *, beta1, beta2, eps, weight_decay, step,
                   bias_correction, grad_scale, grad_averaging,
                   noop_flag) -> torch.Tensor:
    """The kernel's device vector ``[beta1, beta2, eps, weight_decay,
    1/bc1, 1/sqrt(bc2), grad_scale, beta3, noop]`` (``beta3`` = 1 - beta1,
    or 1 without grad averaging)."""
    b1, b2 = _scalar(beta1, device), _scalar(beta2, device)
    if bias_correction:
        t = _scalar(step, device)
        inv_bc1 = 1.0 / (1.0 - torch.pow(b1, t))
        inv_sqrt_bc2 = torch.rsqrt(1.0 - torch.pow(b2, t))
    else:
        inv_bc1 = inv_sqrt_bc2 = _scalar(1.0, device)
    beta3 = 1.0 - b1 if grad_averaging else _scalar(1.0, device)
    return torch.stack([
        b1, b2, _scalar(eps, device), _scalar(weight_decay, device),
        inv_bc1, inv_sqrt_bc2, _scalar(grad_scale, device), beta3,
        _scalar(noop_flag, device)])


def _lamb1_kernel_reference(p, g, m, v, hp):
    """Plain version of the LAMB phase-1 kernel: new ``(m, v, u)``; on a
    noop step the old m and v and a zero u."""
    b1, b2, eps, wd, inv_bc1, inv_sqrt_bc2, gscale, beta3, noop = \
        hp.unbind()
    g = g.float() * gscale
    m_new = b1 * m + beta3 * g
    v_new = b2 * v + (1.0 - b2) * g * g
    u = (m_new * inv_bc1) / (torch.sqrt(v_new) * inv_sqrt_bc2 + eps) \
        + wd * p
    skip = noop > 0.0
    return (torch.where(skip, m, m_new), torch.where(skip, v, v_new),
            torch.where(skip, torch.zeros_like(u), u))


def _lamb1_plain(p, g, m, v, u, hp) -> None:
    _apply_plain(_lamb1_kernel_reference, (m, v, u), (p, g, m, v), hp)


def _lamb1_kernel(p, g, m, v, u, hp) -> None:
    _check_kernel_operands("fused_lamb1", g, p, m, v, u)
    lib = _build.library()
    _build.count("fused_lamb1")
    err = lib.apex_fused_lamb1(
        p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
        u.data_ptr(), hp.data_ptr(), p.numel(), _DTYPE_CODE[g.dtype],
        _build.stream_ptr(p.device))
    _build.check(err, "fused_lamb1")


def fused_lamb_phase1_flat(p, g, m, v, *, beta1, beta2, eps, weight_decay,
                           step, bias_correction=True, grad_scale=1.0,
                           grad_averaging=True, noop_flag=0.0, u=None):
    """LAMB stage 1 over flat fp32 state: m and v updated IN PLACE and
    the raw update direction ``u`` written (into ``u=`` when given, a
    flat fp32 buffer like p); returns ``(m, v, u)``.

    Parity: ``amp_C.multi_tensor_lamb_stage_1``; stage 2 (the per-tensor
    trust ratios) happens at the optimizer level.  ``noop_flag`` > 0
    leaves m and v bit-identical and makes u zero (port-only: the JAX
    rule selects the old buffers afterwards instead).  ``g`` may be fp32
    or bf16."""
    _check_flat_state(p, g, m=m, v=v)
    if u is None:
        u = torch.empty_like(p)
    else:
        _check_flat_state(p, g, u=u)
    hp = _lamb1_hparams(p.device, beta1=beta1, beta2=beta2, eps=eps,
                        weight_decay=weight_decay, step=step,
                        bias_correction=bias_correction,
                        grad_scale=grad_scale,
                        grad_averaging=grad_averaging, noop_flag=noop_flag)
    _route(p.device, "fused_lamb_phase1_flat", _lamb1_plain,
           _lamb1_kernel)(p, g, m, v, u, hp)
    return m, v, u


# ---------------------------------------------------------------------------
# SGD (momentum, dampening, nesterov)
# ---------------------------------------------------------------------------

def _sgd_hparams(device, *, lr, momentum, dampening, weight_decay,
                 first_run, noop_flag, grad_scale) -> torch.Tensor:
    """The kernel's device vector ``[lr, momentum, dampening,
    weight_decay, first_run, noop, grad_scale]``."""
    return torch.stack([_scalar(x, device) for x in (
        lr, momentum, dampening, weight_decay, first_run, noop_flag,
        grad_scale)])


def _sgd_kernel_reference(p, g, buf, hp, nesterov: bool, wd_after: bool):
    """Plain version of the SGD kernel: new ``(p, buf)``."""
    lr, mom, damp, wd, first, noop, gscale = hp.unbind()
    g = g.float() * gscale
    d = g if wd_after else g + wd * p
    buf_new = torch.where(first > 0.0, d, mom * buf + (1.0 - damp) * d)
    step_dir = d + mom * buf_new if nesterov else buf_new
    step_dir = torch.where(mom == 0.0, d, step_dir)
    if wd_after:
        step_dir = step_dir + wd * p
    p_new = p - lr * step_dir
    skip = noop > 0.0
    return torch.where(skip, p, p_new), torch.where(skip, buf, buf_new)


def _sgd_plain(p, g, buf, hp, nesterov, wd_after) -> None:
    _apply_plain(_sgd_kernel_reference, (p, buf), (p, g, buf), hp,
                 nesterov, wd_after)


def _sgd_kernel(p, g, buf, hp, nesterov, wd_after) -> None:
    _check_kernel_operands("fused_sgd", g, p, buf)
    lib = _build.library()
    _build.count("fused_sgd")
    err = lib.apex_fused_sgd(
        p.data_ptr(), g.data_ptr(), buf.data_ptr(), hp.data_ptr(),
        p.numel(), _DTYPE_CODE[g.dtype], int(nesterov), int(wd_after),
        _build.stream_ptr(p.device))
    _build.check(err, "fused_sgd")


def fused_sgd_flat(p, g, buf, *, lr, momentum, dampening, weight_decay,
                   nesterov=False, wd_after_momentum=False,
                   first_run=False, noop_flag=0.0, grad_scale=1.0):
    """One fused SGD step, torch-SGD semantics, over flat fp32 p and
    momentum buffer, IN PLACE; returns ``(p, buf)``.

    Parity: ``amp_C.multi_tensor_sgd`` as driven by ``FusedSGD``,
    including the ``wd_after_momentum`` decay placement.  ``first_run``
    (a bool or a device flag) seeds the buffer with the step's
    direction; ``momentum == 0`` steps along the direction itself;
    ``noop_flag`` > 0 leaves p and buf bit-identical."""
    _check_flat_state(p, g, buf=buf)
    dev = p.device
    hp = _sgd_hparams(dev, lr=lr, momentum=momentum, dampening=dampening,
                      weight_decay=weight_decay, first_run=first_run,
                      noop_flag=noop_flag, grad_scale=grad_scale)
    _route(dev, "fused_sgd_flat", _sgd_plain, _sgd_kernel)(
        p, g, buf, hp, bool(nesterov), bool(wd_after_momentum))
    return p, buf


# ---------------------------------------------------------------------------
# Adagrad
# ---------------------------------------------------------------------------

def _adagrad_hparams(device, *, lr, eps, weight_decay, noop_flag,
                     grad_scale) -> torch.Tensor:
    """The kernel's device vector ``[lr, eps, weight_decay, noop,
    grad_scale]``."""
    return torch.stack([_scalar(x, device) for x in (
        lr, eps, weight_decay, noop_flag, grad_scale)])


def _adagrad_kernel_reference(p, g, h, hp, w_mode: bool):
    """Plain version of the Adagrad kernel: new ``(p, h)``."""
    lr, eps, wd, noop, gscale = hp.unbind()
    g = g.float() * gscale
    if not w_mode:
        g = g + wd * p
    h_new = h + g * g
    update = g / (torch.sqrt(h_new) + eps)
    if w_mode:
        update = update + wd * p
    p_new = p - lr * update
    skip = noop > 0.0
    return torch.where(skip, p, p_new), torch.where(skip, h, h_new)


def _adagrad_plain(p, g, h, hp, w_mode) -> None:
    _apply_plain(_adagrad_kernel_reference, (p, h), (p, g, h), hp, w_mode)


def _adagrad_kernel(p, g, h, hp, w_mode) -> None:
    _check_kernel_operands("fused_adagrad", g, p, h)
    lib = _build.library()
    _build.count("fused_adagrad")
    err = lib.apex_fused_adagrad(
        p.data_ptr(), g.data_ptr(), h.data_ptr(), hp.data_ptr(), p.numel(),
        _DTYPE_CODE[g.dtype], int(w_mode), _build.stream_ptr(p.device))
    _build.check(err, "fused_adagrad")


def fused_adagrad_flat(p, g, h, *, lr, eps, weight_decay, w_mode=False,
                       noop_flag=0.0, grad_scale=1.0):
    """One fused Adagrad step over flat fp32 p and sum of squares h, IN
    PLACE; returns ``(p, h)``.

    Parity: ``amp_C.multi_tensor_adagrad``; ``w_mode`` is the
    reference's ADAGRAD_MODE (decoupled weight decay).  ``noop_flag`` >
    0 leaves p and h bit-identical."""
    _check_flat_state(p, g, h=h)
    dev = p.device
    hp = _adagrad_hparams(dev, lr=lr, eps=eps, weight_decay=weight_decay,
                          noop_flag=noop_flag, grad_scale=grad_scale)
    _route(dev, "fused_adagrad_flat", _adagrad_plain, _adagrad_kernel)(
        p, g, h, hp, bool(w_mode))
    return p, h
