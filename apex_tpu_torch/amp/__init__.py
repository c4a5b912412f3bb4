"""Mixed-precision helpers of the port: loss scaling."""
from apex_tpu_torch.amp.scaler import (LossScaler, LossScaleState,
                                       init_loss_scale, unscale_flat_grads,
                                       update_scale)

__all__ = ["LossScaler", "LossScaleState", "init_loss_scale",
           "unscale_flat_grads", "update_scale"]
