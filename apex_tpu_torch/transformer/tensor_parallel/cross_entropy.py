"""Vocab-parallel cross entropy at tp = 1.

Port of the ``_local_cross_entropy`` path of
``apex_tpu/transformer/tensor_parallel/cross_entropy.py``: plain
PyTorch over fp32 logits (a log-softmax, the target's log-probability,
optional label smoothing), differentiated by autograd as the JAX path
is by ``jax.grad``.  The sharded path and the bf16 softmax residual
(``half_residuals``) are not ported (ROADMAP queue 1, item 6).
"""
from __future__ import annotations

import torch

__all__ = ["vocab_parallel_cross_entropy"]


def vocab_parallel_cross_entropy(vocab_parallel_logits, target,
                                 label_smoothing: float = 0.0, *,
                                 half_residuals: bool = False,
                                 tensor_model_parallel_size: int = 1):
    """Per-token CE loss, the logits' leading shape; ``target`` holds
    int vocab ids."""
    if tensor_model_parallel_size != 1 or half_residuals:
        raise NotImplementedError(
            "vocab_parallel_cross_entropy ports the tp = 1 fp32 path only "
            "(ROADMAP queue 1, item 6)")
    vocab = vocab_parallel_logits.shape[-1]
    log_probs = torch.log_softmax(vocab_parallel_logits, dim=-1)
    nll = -torch.gather(log_probs, -1, target[..., None].long())[..., 0]
    if label_smoothing > 0.0:
        smooth = -log_probs.sum(dim=-1) / vocab
        return (1.0 - label_smoothing) * nll + label_smoothing * smooth
    return nll
