"""FusedNovoGrad — NovoGrad with per-tensor second moments.

Parity: ``apex/optimizers/fused_novograd.py :: FusedNovoGrad`` over
``amp_C.multi_tensor_novograd``.  NovoGrad's second moment is one scalar
per tensor (an EMA of ||g||^2); its JAX rule reaches no Pallas kernel,
so the port's rule (:func:`apex_tpu_torch.optimizers.functional.
fused_novograd`) is plain PyTorch on every device and this class launches
no kernel of the port.  This class is the stateful torch-parity shell
over it (see ``FusedOptimizerBase``).
"""
from __future__ import annotations

from apex_tpu_torch.optimizers import functional
from apex_tpu_torch.ops.fused_update import _scalar
from apex_tpu_torch.optimizers.base import FusedOptimizerBase

__all__ = ["FusedNovoGrad"]


class FusedNovoGrad(FusedOptimizerBase):
    #: nn.Parameters route to the torch-mode twin — see ``_torch_mode.py``
    _TORCH_IMPL = "FusedNovoGradTorch"

    def __init__(self, params, lr=1e-3, bias_correction=True,
                 betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0,
                 amsgrad=False, reg_inside_moment=False, grad_averaging=True,
                 norm_type=2, init_zero=False, set_grad_none=True):
        if amsgrad:
            raise RuntimeError("FusedNovoGrad does not support the AMSGrad "
                               "variant.")
        if norm_type != 2:
            raise ValueError("FusedNovoGrad only supports norm_type=2")
        if reg_inside_moment:
            # the flag flips the kernel's decay placement (reference
            # MOMENT_MODE split); only the default placement is
            # implemented here — refusing beats silently running
            # different math
            raise NotImplementedError(
                "FusedNovoGrad: reg_inside_moment=True is not "
                "implemented (only the default decay placement, decay "
                "added to the normalized gradient, is)")
        defaults = dict(lr=lr, bias_correction=bias_correction, betas=betas,
                        eps=eps, weight_decay=weight_decay)
        self.grad_averaging = bool(grad_averaging)
        self.init_zero = bool(init_zero)
        super().__init__(params, defaults)

    def _make_tx(self, options):
        return functional.fused_novograd(
            lr=options["lr"], betas=options["betas"], eps=options["eps"],
            weight_decay=options["weight_decay"],
            bias_correction=bool(options["bias_correction"]),
            grad_averaging=self.grad_averaging, init_zero=self.init_zero)

    def _traced_hyper(self, options, device):
        beta1, beta2 = options["betas"]
        return {"lr": _scalar(options["lr"], device),
                "beta1": _scalar(beta1, device),
                "beta2": _scalar(beta2, device),
                "eps": _scalar(options["eps"], device),
                "weight_decay": _scalar(options["weight_decay"], device)}
