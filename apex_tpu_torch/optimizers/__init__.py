"""Fused optimizers of the port (reference: ``apex/optimizers``).

Two entry points over the same math:

* the class API — ``FusedAdam``, ``FusedLAMB``, ``FusedSGD``,
  ``FusedAdagrad``, ``FusedNovoGrad``, ``FusedMixedPrecisionLamb``:
  constructed with a tree of tensors, stepped with ``step(grads)``,
  checkpointed with ``state_dict``/``load_state_dict``; constructed with
  ``nn.Parameter``s (``FusedAdam(model.parameters())``) they return the
  torch-mode twins (:mod:`._torch_mode`), ``torch.optim.Optimizer``s
  driven by ``loss.backward(); optimizer.step()``;
* :mod:`apex_tpu_torch.optimizers.functional` — the flat-native rules
  (``init``/``update`` over a flat fp32 master) that the classes, the
  twins and :func:`apex_tpu_torch.train_step.make_train_step` all run,
  on the kernels of :mod:`apex_tpu_torch.ops.fused_update`.
"""
from apex_tpu_torch.optimizers import functional
from apex_tpu_torch.optimizers.base import (FusedOptimizerBase,
                                            broadcast_leaf_scalars)
from apex_tpu_torch.optimizers.functional import (FlatState, export_params,
                                                  fused_adagrad, fused_adam,
                                                  fused_lamb, fused_novograd,
                                                  fused_sgd)
from apex_tpu_torch.optimizers.fused_adagrad import FusedAdagrad
from apex_tpu_torch.optimizers.fused_adam import FusedAdam
from apex_tpu_torch.optimizers.fused_lamb import FusedLAMB
from apex_tpu_torch.optimizers.fused_mixed_precision_lamb import (
    FusedMixedPrecisionLamb,
)
from apex_tpu_torch.optimizers.fused_novograd import FusedNovoGrad
from apex_tpu_torch.optimizers.fused_sgd import FusedSGD

__all__ = ["FusedOptimizerBase", "FusedAdam", "FusedSGD", "FusedLAMB",
           "FusedAdagrad", "FusedNovoGrad", "FusedMixedPrecisionLamb",
           "functional", "FlatState", "fused_adam", "fused_lamb",
           "fused_sgd", "fused_novograd", "fused_adagrad", "export_params",
           "broadcast_leaf_scalars"]
