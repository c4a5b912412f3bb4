"""Pipeline-aware mixed precision (reference: ``apex/transformer/amp``)."""
from apex_tpu_torch.transformer.amp.grad_scaler import GradScaler

__all__ = ["GradScaler"]
