"""FusedSGD (parity: ``apex/optimizers/fused_sgd.py`` over
``amp_C.multi_tensor_sgd``).

The update math lives in the functional core
(:func:`apex_tpu_torch.optimizers.functional.fused_sgd`, the SGD
kernel); this class is the stateful torch-parity shell over it (see
``FusedOptimizerBase``).
"""
from __future__ import annotations

import torch

from apex_tpu_torch.optimizers import functional
from apex_tpu_torch.ops.fused_update import _scalar
from apex_tpu_torch.optimizers.base import FusedOptimizerBase

__all__ = ["FusedSGD"]


class FusedSGD(FusedOptimizerBase):
    #: nn.Parameters route to the torch-mode twin — see ``_torch_mode.py``
    _TORCH_IMPL = "FusedSGDTorch"

    def __init__(self, params, lr, momentum=0.0, dampening=0.0,
                 weight_decay=0.0, nesterov=False,
                 wd_after_momentum=False, materialize_master_grads=True,
                 set_grad_none=False):
        if nesterov and (momentum <= 0 or dampening != 0):
            raise ValueError(
                "Nesterov momentum requires a momentum and zero dampening")
        defaults = dict(lr=lr, momentum=momentum, dampening=dampening,
                        weight_decay=weight_decay, nesterov=nesterov,
                        wd_after_momentum=wd_after_momentum)
        super().__init__(params, defaults)

    def _make_tx(self, options):
        return functional.fused_sgd(
            lr=options["lr"], momentum=options["momentum"],
            dampening=options["dampening"],
            weight_decay=options["weight_decay"],
            nesterov=bool(options["nesterov"]),
            wd_after_momentum=bool(options["wd_after_momentum"]))

    def _traced_hyper(self, options, device):
        return {"lr": _scalar(options["lr"], device),
                "momentum": _scalar(options["momentum"], device),
                "dampening": _scalar(options["dampening"], device),
                "weight_decay": _scalar(options["weight_decay"], device)}

    def _step_group(self, group, gflat, step, noop_flag, grad_scale):
        # older checkpoints lack the "seeded" flag (torch clones the grad
        # into a FRESH buffer on the first EFFECTIVE step; a device flag,
        # so overflow skips need no host sync): any step already taken
        # seeded the buffer (their step 1 was never recorded as skipped)
        if "seeded" not in group.state:
            group.state["seeded"] = torch.full(
                (), 0.0 if step == 1 else 1.0, dtype=torch.float32,
                device=group.master.device)
        super()._step_group(group, gflat, step, noop_flag, grad_scale)
