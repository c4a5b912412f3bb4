"""clip_grad_norm_ over the fused L2-norm kernel.

Port of ``apex_tpu/contrib/clip_grad.py`` (reference:
``apex/contrib/clip_grad/clip_grad.py :: clip_grad_norm_``, a drop-in
for ``torch.nn.utils.clip_grad_norm_`` over ``amp_C.multi_tensor_l2norm``
and ``multi_tensor_scale``).

The JAX package's functional contract is kept: it takes grads (a tree
of tensors, or one flat buffer as ``make_train_step``'s
``grad_transform`` hands it) and returns ``(clipped_grads,
total_norm)`` instead of mutating ``.grad`` in place.  Everything stays
on the device: the norm and the clip factor are 0-d tensors and
nothing is read back.
"""
from __future__ import annotations

import torch

from apex_tpu_torch.ops.fused_update import fused_l2norm, fused_scale
from apex_tpu_torch.utils import tree_ravel

__all__ = ["clip_grad_norm_"]


def clip_grad_norm_(grads, max_norm: float, norm_type: float = 2.0,
                    error_if_nonfinite: bool = False):
    """Clip the global grad norm (reference semantics, inf-norm
    included).

    Returns ``(clipped_grads, total_norm)``, the clipped grads in the
    form given (a new tree, or a new flat buffer for a flat one).  The
    total norm is computed by the fused kernel for ``norm_type == 2``
    (in fp32) and by torch reductions in the grads' dtype otherwise, as
    the JAX package's jnp reductions (the reference fuses only the L2
    case); the clip is the fused scale kernel.  ``error_if_nonfinite``
    cannot raise without a host sync: as in the JAX package, it makes a
    non-finite norm NaN instead, on the device."""
    flat_given = isinstance(grads, torch.Tensor)
    if flat_given:
        flat = grads.reshape(-1)
    else:
        flat, unravel = tree_ravel(grads)
    if norm_type == 2.0:
        total_norm = fused_l2norm(flat)
    elif norm_type == float("inf"):
        total_norm = flat.abs().max()
    else:
        total_norm = torch.sum(flat.abs() ** norm_type) ** (1.0 / norm_type)
    if error_if_nonfinite:
        total_norm = torch.where(torch.isfinite(total_norm), total_norm,
                                 torch.full_like(total_norm, float("nan")))
    coef = torch.clamp_max(max_norm / (total_norm + 1e-6), 1.0)
    clipped, _ = fused_scale(flat, coef)
    if flat_given:
        return clipped.view(grads.shape), total_norm
    return unravel(clipped), total_norm
