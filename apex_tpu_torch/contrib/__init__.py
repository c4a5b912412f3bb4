"""Ports of ``apex_tpu.contrib``: so far the fused-kernel grad clipper."""
from apex_tpu_torch.contrib.clip_grad import clip_grad_norm_

__all__ = ["clip_grad_norm_"]
