"""FusedAdam — one kernel launch per step over a flat master buffer.

Parity: ``apex/optimizers/fused_adam.py :: FusedAdam`` (driving
``amp_C.multi_tensor_adam``).  ``adam_w_mode=True`` gives AdamW
(decoupled decay), matching the reference default.  CUDA-specific knobs
(``capturable``, ``master_weights``) are accepted and ignored: fp32
masters are always on here.

The update math lives in the functional core
(:func:`apex_tpu_torch.optimizers.functional.fused_adam`, the Adam
kernel); this class is the stateful torch-parity shell over it (see
``FusedOptimizerBase``).
"""
from __future__ import annotations

from apex_tpu_torch.optimizers import functional
from apex_tpu_torch.ops.fused_update import _scalar
from apex_tpu_torch.optimizers.base import FusedOptimizerBase

__all__ = ["FusedAdam"]


class FusedAdam(FusedOptimizerBase):
    #: nn.Parameters (reference scripts: ``FusedAdam(model.parameters())``)
    #: route to the torch-mode twin — see ``_torch_mode.py``
    _TORCH_IMPL = "FusedAdamTorch"

    def __init__(self, params, lr=1e-3, bias_correction=True,
                 betas=(0.9, 0.999), eps=1e-8, adam_w_mode=True,
                 weight_decay=0.0, amsgrad=False, set_grad_none=True,
                 capturable=False, master_weights=False):
        if amsgrad:
            raise RuntimeError("FusedAdam does not support the AMSGrad "
                               "variant.")  # same error as the reference
        defaults = dict(lr=lr, bias_correction=bias_correction, betas=betas,
                        eps=eps, weight_decay=weight_decay)
        self.adam_w_mode = bool(adam_w_mode)
        super().__init__(params, defaults)

    def _make_tx(self, options):
        return functional.fused_adam(
            lr=options["lr"], betas=options["betas"], eps=options["eps"],
            weight_decay=options["weight_decay"],
            adam_w_mode=self.adam_w_mode,
            bias_correction=bool(options["bias_correction"]))

    def _traced_hyper(self, options, device):
        beta1, beta2 = options["betas"]
        return {"lr": _scalar(options["lr"], device),
                "beta1": _scalar(beta1, device),
                "beta2": _scalar(beta2, device),
                "eps": _scalar(options["eps"], device),
                "weight_decay": _scalar(options["weight_decay"], device)}
