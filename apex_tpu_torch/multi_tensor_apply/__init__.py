"""MultiTensorApply parity shim (reference:
``apex/multi_tensor_apply/multi_tensor_apply.py :: MultiTensorApply``),
the counterpart of ``apex_tpu.multi_tensor_apply``.

Apex's applier hands a chunked tensor-list metadata struct to a CUDA
kernel.  Here, as in the JAX package, each tensor list is raveled into
one flat buffer (:func:`apex_tpu_torch.utils.tree_ravel`: index order,
the promoted dtype) and one fused kernel runs over it; ``chunk_size`` is
kept only for signature parity.  The appliers RETURN their outputs, as
the JAX shim does, instead of writing them in place as Apex does, and
the overflow buffer becomes a returned 0-d fp32 flag on the tensors'
device.  ``noop_flag`` is combined into that flag (``max(noop_flag,
flag)``) and does not skip the work, as in the JAX shim.

Kernels: :func:`multi_tensor_scale` runs the unscale kernel,
:func:`multi_tensor_axpby` the axpby kernel, :func:`multi_tensor_l2norm`
the L2 norm kernel and :func:`multi_tensor_l2norm_scale` the fused scale
and norm kernel (``csrc/fused_update.cu``) on CUDA tensors, their plain
versions on CPU tensors.  The per-tensor norms are plain PyTorch, as
``_per_tensor_norms`` is plain jnp.
"""
from __future__ import annotations

from typing import Sequence

import torch

from apex_tpu_torch.ops import fused_update as _fu
from apex_tpu_torch.utils import tree_ravel

__all__ = ["MultiTensorApply", "multi_tensor_applier",
           "multi_tensor_scale", "multi_tensor_axpby",
           "multi_tensor_l2norm", "multi_tensor_l2norm_scale"]


def _ravel_list(tensors: Sequence[torch.Tensor]):
    return tree_ravel(list(tensors))


def _found_inf(noop_flag, flag: torch.Tensor) -> torch.Tensor:
    return torch.maximum(_fu._scalar(noop_flag, flag.device), flag)


def multi_tensor_scale(noop_flag, tensor_lists, scale):
    """[inputs] -> ([outputs], found_inf).  Parity: amp_C.multi_tensor_scale."""
    flat, unravel = _ravel_list(tensor_lists[0])
    out, flag = _fu.fused_scale(flat, scale)
    return unravel(out), _found_inf(noop_flag, flag)


def multi_tensor_axpby(noop_flag, tensor_lists, a, b):
    """[xs, ys] -> ([outs], found_inf), outs = a * xs + b * ys in xs'
    dtypes.  Parity: amp_C.multi_tensor_axpby."""
    xf, unravel = _ravel_list(tensor_lists[0])
    yf, _ = _ravel_list(tensor_lists[1])
    out, flag = _fu.fused_axpby(a, xf, b, yf)
    return unravel(out), _found_inf(noop_flag, flag)


def _per_tensor_norms(tensors) -> torch.Tensor:
    return torch.stack([torch.sqrt(torch.sum(torch.square(t.float())))
                        for t in tensors])


def multi_tensor_l2norm(noop_flag, tensor_lists, per_tensor=False):
    """Global (and optionally per-tensor) L2 norm of a tensor list:
    ``(gnorm, per_tensor_norms or None)``.

    Parity: ``amp_C.multi_tensor_l2norm``."""
    tensors = tensor_lists[0]
    flat, _ = _ravel_list(tensors)
    gnorm = _fu.fused_l2norm(flat)
    if per_tensor:
        return gnorm, _per_tensor_norms(tensors)
    return gnorm, None


def multi_tensor_l2norm_scale(noop_flag, tensor_lists, scale,
                              per_tensor=False):
    """Scale the list AND return the L2 norm of the scaled values in one
    fused pass (parity: ``amp_C.multi_tensor_l2norm_scale``).  Returns
    ``(outs, gnorm, per_tensor_norms, found_inf)``: the global norm is
    the kernel's fp32 sum before the cast to each leaf's dtype, the
    per-tensor norms those of the returned (rounded) outputs, as in the
    JAX shim."""
    flat, unravel = _ravel_list(tensor_lists[0])
    out, gnorm, flag = _fu.fused_l2norm_scale(flat, scale)
    outs = unravel(out)
    found_inf = _found_inf(noop_flag, flag)
    if per_tensor:
        return outs, gnorm, _per_tensor_norms(outs), found_inf
    return outs, gnorm, None, found_inf


class MultiTensorApply:
    """Callable shim: ``applier(op, noop_flag, tensor_lists, *args)``."""

    available = True
    warned = False

    def __init__(self, chunk_size: int = 2048 * 32):
        self.chunk_size = chunk_size

    def __call__(self, op, noop_flag, tensor_lists, *args):
        return op(noop_flag, tensor_lists, *args)


multi_tensor_applier = MultiTensorApply()
