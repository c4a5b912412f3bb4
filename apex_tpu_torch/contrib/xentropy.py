"""Apex's ``contrib.xentropy.SoftmaxCrossEntropyLoss``, port of
``apex_tpu/contrib/xentropy.py``: the class shim over
:func:`apex_tpu_torch.ops.xentropy.softmax_cross_entropy_loss`."""
from __future__ import annotations

from apex_tpu_torch.ops.xentropy import softmax_cross_entropy_loss

__all__ = ["SoftmaxCrossEntropyLoss", "softmax_cross_entropy_loss"]


class SoftmaxCrossEntropyLoss:
    """Apex exposes an autograd Function used as
    ``SoftmaxCrossEntropyLoss.apply(logits, labels, smoothing,
    padding_idx, half_to_float)``; here ``apply`` is the fused
    function."""

    @staticmethod
    def apply(logits, labels, smoothing=0.0, padding_idx=-100,
              half_to_float=False):
        return softmax_cross_entropy_loss(
            logits, labels, smoothing=smoothing, padding_idx=padding_idx,
            half_to_float=half_to_float)
