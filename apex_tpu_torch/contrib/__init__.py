"""Ports of ``apex_tpu.contrib``: the fused-kernel grad clipper and the
softmax cross entropy shim."""
from apex_tpu_torch.contrib.clip_grad import clip_grad_norm_
from apex_tpu_torch.contrib.xentropy import SoftmaxCrossEntropyLoss

__all__ = ["clip_grad_norm_", "SoftmaxCrossEntropyLoss"]
