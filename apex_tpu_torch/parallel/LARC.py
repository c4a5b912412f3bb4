"""LARC — layer-wise adaptive rate clipping (reference:
``apex/parallel/LARC.py :: LARC``).

Port of ``apex_tpu/parallel/LARC.py``.  Wraps an optimizer of
:mod:`apex_tpu_torch.optimizers`; before delegating to its ``step`` it
rescales each parameter tensor's gradient by the local adaptive rate
``eta * ||p|| / (||g|| + wd * ||p|| + eps)``, clipped to the group lr
when ``clip=True``: the reference's algorithm, per leaf, as device
ops.  A tree class (``FusedSGD(params_tree)``) is stepped with the
grads, as in JAX; a ``torch.optim`` optimizer (the torch-mode twins,
``FusedSGD(model.parameters())``) has its parameters' ``.grad``
rescaled in place before its ``step()``, as the reference does.
"""
from __future__ import annotations

import torch

from apex_tpu_torch.utils import _rebuild, _skeleton, tree_leaves_with_path

__all__ = ["LARC"]


class LARC:
    def __init__(self, optimizer, trust_coefficient=0.02, clip=True,
                 eps=1e-8):
        self.optim = optimizer
        self.trust_coefficient = trust_coefficient
        self.clip = clip
        self.eps = eps

    @property
    def param_groups(self):
        return self.optim.param_groups

    @property
    def inner(self):
        return self.optim

    def state_dict(self):
        return self.optim.state_dict()

    def load_state_dict(self, sd):
        self.optim.load_state_dict(sd)

    def zero_grad(self, set_to_none=True):
        self.optim.zero_grad(set_to_none)

    def _adapt(self, p, g32, wd, lr):
        """``(g32 + wd * p) * rate`` where both norms are nonzero, else
        ``g32`` untouched (no scaling, no wd fold)."""
        pn = torch.linalg.vector_norm(p)
        gn = torch.linalg.vector_norm(g32)
        adaptive = self.trust_coefficient * pn / (gn + wd * pn + self.eps)
        if self.clip:
            adaptive = torch.clamp_max(adaptive / lr, 1.0)
        apply = (pn > 0) & (gn > 0)
        mult = torch.where(apply, adaptive, torch.ones_like(adaptive))
        return torch.where(apply, g32 + wd * p, g32) * mult

    def _scale_group(self, group, wd, grads, grad_scale):
        lr = group.options["lr"]
        leaves = tree_leaves_with_path(grads)
        scaled = []
        for (_, g), off, size in zip(leaves, group.offsets, group.sizes):
            p = group.master[off:off + size].reshape(g.shape)
            # unscale BEFORE the norm/fold so amp loss scaling doesn't
            # distort the trust ratio or the folded wd*p term
            g32 = g.float() / grad_scale
            scaled.append(self._adapt(p, g32, wd, lr).to(g.dtype))
        return _rebuild(_skeleton(grads), iter(scaled))

    def _scale_torch_grads(self, saved_wd):
        """The reference's loop over a ``torch.optim`` optimizer's
        parameters: each ``.grad`` rescaled in place."""
        with torch.no_grad():
            for group, wd in zip(self.optim.param_groups, saved_wd):
                for p in group["params"]:
                    if p.grad is None:
                        continue
                    g = self._adapt(p.float(), p.grad.float(), wd,
                                    group["lr"])
                    p.grad.copy_(g)

    def step(self, grads=None, grad_scale=None, **kw):
        """Scale grads by the per-param trust ratio, then delegate.

        As in the reference, each group's ``weight_decay`` is zeroed and
        ``wd * p`` folded into the grad before scaling, and restored
        afterwards, so ``state_dict`` still records the true wd.
        ``grad_scale`` (amp's loss scale) is consumed here: the grads are
        unscaled before the norms, and the inner step runs with scale 1.
        A ``torch.optim`` optimizer takes no ``grads``: its parameters'
        ``.grad`` are scaled."""
        groups = self.optim.param_groups
        torch_mode = isinstance(self.optim, torch.optim.Optimizer)
        options = [g if torch_mode else g.options for g in groups]
        saved_wd = [o.get("weight_decay", 0.0) for o in options]
        try:
            for o in options:
                o["weight_decay"] = 0.0
            if torch_mode:
                if grads is not None or grad_scale is not None:
                    raise TypeError("a torch.optim optimizer's LARC step "
                                    "scales the parameters' .grad: pass no "
                                    "grads or grad_scale")
                self._scale_torch_grads(saved_wd)
                return self.optim.step(**kw)
            grads_list = [grads] if len(groups) == 1 else list(grads)
            scale = 1.0 if grad_scale is None else grad_scale
            out = [self._scale_group(g, wd, gr, scale)
                   for g, wd, gr in zip(groups, saved_wd, grads_list)]
            return self.optim.step(out[0] if len(groups) == 1 else out, **kw)
        finally:
            for o, wd in zip(options, saved_wd):
                o["weight_decay"] = wd
