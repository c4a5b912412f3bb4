"""Scale + mask + softmax (port of
``apex_tpu/transformer/functional/fused_softmax.py``).

The JAX module is plain XLA (no Pallas kernel: XLA fuses the scale, the
mask and the softmax into one loop), so this port is plain PyTorch with
the same semantics and the same interface as the reference's
``FusedScaleMaskSoftmax`` (``is_kernel_available``,
``forward_fused_softmax``, ``forward_torch_softmax``, the fp16/bf16
flags, the optional softmax in fp32 with the result cast back):

* a mask is True where attention is DISABLED;
* masked scores take ``torch.finfo(dtype).min``, so a fully masked row
  is uniform (not 0, unlike the flash kernels);
* the causal mask keeps ``tril(k = sk - sq)``;
* the scale multiplies before the mask.

Each step runs in the working dtype, as the JAX expression does.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from apex_tpu_torch.transformer.enums import AttnMaskType

__all__ = [
    "FusedScaleMaskSoftmax",
    "ScaledUpperTriangMaskedSoftmax",
    "ScaledMaskedSoftmax",
    "ScaledSoftmax",
    "GenericScaledMaskedSoftmax",
]


def _softmax(x):
    x = x - torch.amax(x, dim=-1, keepdim=True)
    e = torch.exp(x)
    return e / torch.sum(e, dim=-1, keepdim=True)


def _causal_keep(sq: int, sk: int, device):
    return torch.ones(sq, sk, dtype=torch.bool, device=device).tril(sk - sq)


def ScaledUpperTriangMaskedSoftmax(x, scale: Optional[float] = None):
    """Causal scale + mask + softmax over ``[..., sq, sk]`` score blocks
    (the reference's ``scaled_upper_triang_masked_softmax_cuda``)."""
    if scale is not None:
        x = x * scale
    keep = _causal_keep(x.shape[-2], x.shape[-1], x.device)
    x = torch.where(keep, x, torch.finfo(x.dtype).min)
    return _softmax(x)


def ScaledMaskedSoftmax(x, mask, scale: Optional[float] = None):
    """Arbitrary-mask variant: ``mask`` is True (or 1) where attention is
    DISABLED, as in the reference."""
    if scale is not None:
        x = x * scale
    if mask is not None:
        x = torch.where(mask.to(torch.bool), torch.finfo(x.dtype).min, x)
    return _softmax(x)


def ScaledSoftmax(x, scale: Optional[float] = None):
    if scale is not None:
        x = x * scale
    return _softmax(x)


GenericScaledMaskedSoftmax = ScaledMaskedSoftmax


class FusedScaleMaskSoftmax:
    """Reference-parity module.  The arguments mirror the reference's
    ``FusedScaleMaskSoftmax.__init__``: ``mask_func`` is the eager
    route's masking function, ``softmax_in_fp32`` upcasts a 16-bit input
    before the softmax and casts the result back."""

    def __init__(self, input_in_fp16: bool, input_in_bf16: bool,
                 attn_mask_type: AttnMaskType,
                 scaled_masked_softmax_fusion: bool,
                 mask_func: Optional[Callable],
                 softmax_in_fp32: bool,
                 scale: Optional[float]):
        self.input_in_fp16 = input_in_fp16
        self.input_in_bf16 = input_in_bf16
        if input_in_fp16 and input_in_bf16:
            raise RuntimeError(
                "both fp16 and bf16 flags cannot be active at the same "
                "time.")
        self.input_in_float16 = input_in_fp16 or input_in_bf16
        self.attn_mask_type = attn_mask_type
        self.scaled_masked_softmax_fusion = scaled_masked_softmax_fusion
        self.mask_func = mask_func
        self.softmax_in_fp32 = softmax_in_fp32
        self.scale = scale
        if not (scale is None or softmax_in_fp32):
            raise RuntimeError(
                "softmax should be in fp32 when scaled")

    def __call__(self, input, mask):
        if input.dim() != 4:        # [b, np, sq, sk]
            raise AssertionError(
                f"FusedScaleMaskSoftmax takes [b, np, sq, sk], got "
                f"{tuple(input.shape)}")
        if self.is_kernel_available(mask, *input.shape):
            return self.forward_fused_softmax(input, mask)
        return self.forward_torch_softmax(input, mask)

    def is_kernel_available(self, mask, b, np_, sq, sk) -> bool:
        """The reference gates its CUDA kernels on dtype and lengths; the
        fused expression here takes every shape, so this is the fusion
        flag (kept as a method for callers that probe it)."""
        return self.scaled_masked_softmax_fusion

    def forward_fused_softmax(self, input, mask):
        b, np_, sq, sk = input.shape
        x = input
        if self.input_in_float16 and self.softmax_in_fp32:
            x = x.float()
        if self.attn_mask_type == AttnMaskType.causal:
            probs = ScaledUpperTriangMaskedSoftmax(
                x.reshape(-1, sq, sk), self.scale).reshape(b, np_, sq, sk)
        elif mask is not None:
            probs = ScaledMaskedSoftmax(x, mask, self.scale)
        else:
            probs = ScaledSoftmax(x, self.scale)
        if self.input_in_float16 and self.softmax_in_fp32:
            probs = probs.to(input.dtype)
        return probs

    def forward_torch_softmax(self, input, mask):
        """The reference's eager route: ``mask_func`` + softmax (+ scale);
        the oracle the fused route is tested against."""
        x = input
        if self.input_in_float16 and self.softmax_in_fp32:
            x = x.float()
        if self.scale is not None:
            x = x * self.scale
        if self.attn_mask_type == AttnMaskType.causal and mask is None:
            sq, sk = x.shape[-2], x.shape[-1]
            mask = ~_causal_keep(sq, sk, x.device)[None, None]
        if mask is not None and self.mask_func is not None:
            x = self.mask_func(x, mask)
        elif mask is not None:
            x = torch.where(mask.to(torch.bool), torch.finfo(x.dtype).min, x)
        probs = _softmax(x)
        if self.input_in_float16 and self.softmax_in_fp32:
            probs = probs.to(input.dtype)
        return probs
