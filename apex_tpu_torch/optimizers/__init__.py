"""Optimizers of the port: the flat-native functional core (Adam, LAMB,
SGD, NovoGrad, Adagrad) and the per-leaf helpers it shares."""
from apex_tpu_torch.optimizers.base import broadcast_leaf_scalars
from apex_tpu_torch.optimizers.functional import (FlatState, fused_adagrad,
                                                  fused_adam, fused_lamb,
                                                  fused_novograd, fused_sgd)

__all__ = ["FlatState", "fused_adam", "fused_lamb", "fused_sgd",
           "fused_novograd", "fused_adagrad", "broadcast_leaf_scalars"]
