"""FusedMixedPrecisionLamb (reference:
``apex/optimizers/fused_mixed_precision_lamb.py``): LAMB whose params may
arrive in low precision while fp32 master weights, moments and the
update math live in full precision, with ``grad_scale`` and the
overflow flag as device tensors (no host sync).

Every ``FusedOptimizerBase`` subclass ALREADY keeps an fp32 flat master
and returns params in the construction dtypes, so this class is
``FusedLAMB`` plus the reference's extra constructor knobs
(``reduced_precision_dtype``, and ``step``, the step count to resume
from) accepted for API parity.
"""
from __future__ import annotations

from typing import Any, Optional

from apex_tpu_torch.optimizers.fused_lamb import FusedLAMB

__all__ = ["FusedMixedPrecisionLamb"]


class FusedMixedPrecisionLamb(FusedLAMB):
    #: nn.Parameters route to the torch-mode twin — see ``_torch_mode.py``
    _TORCH_IMPL = "FusedMixedPrecisionLambTorch"

    def __init__(self, params, lr=1e-3, step=0, bias_correction=True,
                 betas=(0.9, 0.999), eps=1e-6, weight_decay=0.01,
                 amsgrad=False, grad_averaging=True, max_grad_norm=1.0,
                 use_nvlamb=False,
                 reduced_precision_dtype: Optional[Any] = None):
        super().__init__(
            params, lr=lr, bias_correction=bias_correction, betas=betas,
            eps=eps, weight_decay=weight_decay, amsgrad=amsgrad,
            grad_averaging=grad_averaging, max_grad_norm=max_grad_norm,
            use_nvlamb=use_nvlamb)
        self.reduced_precision_dtype = reduced_precision_dtype
        self._step_count = int(step)
