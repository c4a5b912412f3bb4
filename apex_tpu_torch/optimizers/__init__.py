"""Optimizers of the port: the flat-native functional core (Adam)."""
from apex_tpu_torch.optimizers.functional import FlatState, fused_adam

__all__ = ["FlatState", "fused_adam"]
