"""The port's kernels and the plain functions around them.

Each kernel wrapper launches its CUDA kernel for CUDA tensors and takes
its plain PyTorch version for CPU tensors; :mod:`._build` compiles the
sources under ``csrc/`` at first use and counts the launches.
"""
from apex_tpu_torch.ops.attention import (flash_attention, mha_reference,
                                          prefix_window_attention)
from apex_tpu_torch.ops.layer_norm import (layer_norm, layer_norm_reference,
                                           rms_norm, rms_norm_reference)
from apex_tpu_torch.ops.fused_update import (adam_reference,
                                             fused_adagrad_flat,
                                             fused_adam_flat, fused_axpby,
                                             fused_l2norm,
                                             fused_l2norm_scale,
                                             fused_lamb_phase1_flat,
                                             fused_scale, fused_sgd_flat)
from apex_tpu_torch.ops.paged_attention import paged_decode_attention
from apex_tpu_torch.ops.ring_attention import (ring_attention,
                                               ring_attention_reference)
from apex_tpu_torch.ops.ulysses_attention import ulysses_attention
from apex_tpu_torch.ops.xentropy import (softmax_cross_entropy_loss,
                                         xentropy_reference)
from apex_tpu_torch.ops.fused_lm_xent import (
    fused_lm_head_cross_entropy, fused_lm_head_vocab_parallel_cross_entropy,
    lm_head_xentropy_reference)

__all__ = ["ring_attention", "ring_attention_reference", "ulysses_attention",
           "layer_norm", "rms_norm", "layer_norm_reference",
           "rms_norm_reference", "flash_attention", "mha_reference",
           "prefix_window_attention", "paged_decode_attention",
           "fused_scale", "fused_axpby", "fused_adam_flat",
           "adam_reference", "fused_l2norm", "fused_l2norm_scale",
           "fused_lamb_phase1_flat", "fused_sgd_flat", "fused_adagrad_flat",
           "softmax_cross_entropy_loss", "xentropy_reference",
           "fused_lm_head_cross_entropy",
           "fused_lm_head_vocab_parallel_cross_entropy",
           "lm_head_xentropy_reference"]
