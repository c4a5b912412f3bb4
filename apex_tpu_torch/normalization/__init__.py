"""Fused normalization modules.

Port of ``apex_tpu/normalization``: ``FusedLayerNorm`` / ``FusedRMSNorm``
are ``nn.Module``s over the kernels of :mod:`apex_tpu_torch.ops.layer_norm`
(forward and backward), and ``fused_layer_norm`` / ``fused_rms_norm``
the functional forms.  As in the JAX package the affine parameters are
fp32 whatever the activations' dtype, and the output keeps the input's
dtype; ``MixedFusedLayerNorm`` / ``MixedFusedRMSNorm`` are therefore
aliases.  Parameter names (``weight``, ``bias``) match the flax tree.
"""
from __future__ import annotations

from typing import Sequence, Union

import torch
from torch import nn

from apex_tpu_torch.ops.layer_norm import layer_norm as _layer_norm_op
from apex_tpu_torch.ops.layer_norm import rms_norm as _rms_norm_op

__all__ = ["FusedLayerNorm", "FusedRMSNorm", "MixedFusedLayerNorm",
           "MixedFusedRMSNorm", "fused_layer_norm", "fused_rms_norm"]


def fused_layer_norm(input, normalized_shape, weight=None, bias=None,
                     eps: float = 1e-5, memory_efficient: bool = False):
    """Functional fused LayerNorm.  ``memory_efficient`` is accepted for
    parity; the backward always recomputes the statistics."""
    return _layer_norm_op(input, weight, bias,
                          normalized_shape=normalized_shape, eps=eps)


def fused_rms_norm(input, normalized_shape, weight=None, eps: float = 1e-5,
                   memory_efficient: bool = False):
    """Functional fused RMSNorm."""
    return _rms_norm_op(input, weight, normalized_shape=normalized_shape,
                        eps=eps)


def _norm_size(normalized_shape) -> tuple:
    if isinstance(normalized_shape, int):
        return (normalized_shape,)
    return tuple(normalized_shape)


class FusedLayerNorm(nn.Module):
    """LayerNorm over ``normalized_shape`` on the fused kernels."""

    def __init__(self, normalized_shape: Union[int, Sequence[int]],
                 eps: float = 1e-5, elementwise_affine: bool = True,
                 memory_efficient: bool = False, device=None):
        super().__init__()
        self.normalized_shape = _norm_size(normalized_shape)
        self.eps = eps
        self.memory_efficient = memory_efficient
        if elementwise_affine:
            f32 = dict(dtype=torch.float32, device=device)
            shape = self.normalized_shape
            self.weight = nn.Parameter(torch.ones(shape, **f32))
            self.bias = nn.Parameter(torch.zeros(shape, **f32))
        else:
            self.register_parameter("weight", None)
            self.register_parameter("bias", None)

    def forward(self, x):
        return _layer_norm_op(x, self.weight, self.bias,
                              normalized_shape=self.normalized_shape,
                              eps=self.eps)


class FusedRMSNorm(nn.Module):
    """RMSNorm over ``normalized_shape`` on the fused kernels."""

    def __init__(self, normalized_shape: Union[int, Sequence[int]],
                 eps: float = 1e-5, elementwise_affine: bool = True,
                 memory_efficient: bool = False, device=None):
        super().__init__()
        self.normalized_shape = _norm_size(normalized_shape)
        self.eps = eps
        self.memory_efficient = memory_efficient
        if elementwise_affine:
            self.weight = nn.Parameter(torch.ones(
                self.normalized_shape, dtype=torch.float32, device=device))
        else:
            self.register_parameter("weight", None)

    def forward(self, x):
        return _rms_norm_op(x, self.weight,
                            normalized_shape=self.normalized_shape,
                            eps=self.eps)


MixedFusedLayerNorm = FusedLayerNorm
MixedFusedRMSNorm = FusedRMSNorm
