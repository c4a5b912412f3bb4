"""FusedAdagrad (parity: ``apex/optimizers/fused_adagrad.py`` over
``amp_C.multi_tensor_adagrad``).

The update math lives in the functional core
(:func:`apex_tpu_torch.optimizers.functional.fused_adagrad`, the Adagrad
kernel); this class is the stateful torch-parity shell over it (see
``FusedOptimizerBase``).
"""
from __future__ import annotations

from apex_tpu_torch.optimizers import functional
from apex_tpu_torch.ops.fused_update import _scalar
from apex_tpu_torch.optimizers.base import FusedOptimizerBase

__all__ = ["FusedAdagrad"]


class FusedAdagrad(FusedOptimizerBase):
    #: nn.Parameters route to the torch-mode twin — see ``_torch_mode.py``
    _TORCH_IMPL = "FusedAdagradTorch"

    def __init__(self, params, lr=1e-2, eps=1e-10, weight_decay=0.0,
                 set_grad_none=True, adagrad_w_mode=False):
        defaults = dict(lr=lr, eps=eps, weight_decay=weight_decay)
        self.adagrad_w_mode = bool(adagrad_w_mode)
        super().__init__(params, defaults)

    def _make_tx(self, options):
        return functional.fused_adagrad(
            lr=options["lr"], eps=options["eps"],
            weight_decay=options["weight_decay"],
            adagrad_w_mode=self.adagrad_w_mode)

    def _traced_hyper(self, options, device):
        return {"lr": _scalar(options["lr"], device),
                "eps": _scalar(options["eps"], device),
                "weight_decay": _scalar(options["weight_decay"], device)}
