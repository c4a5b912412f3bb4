"""Vocab-parallel cross entropy at tp = 1.

Port of the ``_local_cross_entropy`` path of
``apex_tpu/transformer/tensor_parallel/cross_entropy.py``.  By default
plain PyTorch over the logits (a log-softmax, the target's
log-probability, optional label smoothing), differentiated by autograd
as the JAX path is by ``jax.grad``.  ``half_residuals`` is an autograd
Function instead whose only logits-sized residual is the softmax in
bf16 (Apex's xentropy kernel keeps its softmax in the half dtype): the
backward upcasts it and forms ``softmax - (1-s) at the target - s/V``,
scaled by the loss cotangent.  The sharded path (tp > 1) is not ported
(ROADMAP queue 1, item 6).
"""
from __future__ import annotations

import torch

from apex_tpu_torch.ops.xentropy import subtract_at_labels_

__all__ = ["vocab_parallel_cross_entropy"]


def _ce_grad_(softmax, target, smoothing: float, vocab: int, g):
    """``(softmax - (1-s)·onehot - s/V) * g`` in place over ``softmax
    [n, V]``; the label column is subtracted at its index (the same bits
    as the one-hot form)."""
    subtract_at_labels_(softmax, target, -(1.0 - smoothing))
    if smoothing > 0.0:
        softmax.sub_(smoothing / vocab)
    return softmax.mul_(g[:, None])


class _HalfResidualCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, target, smoothing: float):
        vocab = logits.shape[-1]
        shifted = logits - logits.amax(dim=-1, keepdim=True)
        e = torch.exp(shifted)
        sum_exp = e.sum(dim=-1)
        log_sum_exp = torch.log(sum_exp)
        loss = log_sum_exp - torch.gather(shifted, -1, target[..., None])[
            ..., 0]
        if smoothing > 0.0:
            smooth = -(shifted.sum(dim=-1) - vocab * log_sum_exp) / vocab
            loss = (1.0 - smoothing) * loss + smoothing * smooth
        del shifted
        softmax = e.div_(sum_exp[..., None]).to(torch.bfloat16)
        ctx.save_for_backward(softmax, target)
        ctx.smoothing, ctx.logits_dtype = smoothing, logits.dtype
        return loss

    @staticmethod
    def backward(ctx, g):
        softmax, target = ctx.saved_tensors
        vocab = softmax.shape[-1]
        grad = _ce_grad_(softmax.float().reshape(-1, vocab),
                         target.reshape(-1), ctx.smoothing, vocab,
                         g.float().reshape(-1))
        return grad.reshape(softmax.shape).to(ctx.logits_dtype), None, None


def vocab_parallel_cross_entropy(vocab_parallel_logits, target,
                                 label_smoothing: float = 0.0, *,
                                 half_residuals: bool = False,
                                 tensor_model_parallel_size: int = 1):
    """Per-token CE loss, the logits' leading shape; ``target`` holds
    int vocab ids.  ``half_residuals`` keeps the backward's softmax in
    bf16 instead of autograd's fp32 log-probabilities."""
    if tensor_model_parallel_size != 1:
        raise NotImplementedError(
            "vocab_parallel_cross_entropy ports the tp = 1 path only "
            "(ROADMAP queue 1, item 6)")
    vocab = vocab_parallel_logits.shape[-1]
    if half_residuals:
        return _HalfResidualCE.apply(vocab_parallel_logits, target.long(),
                                     float(label_smoothing))
    log_probs = torch.log_softmax(vocab_parallel_logits, dim=-1)
    nll = -torch.gather(log_probs, -1, target[..., None].long())[..., 0]
    if label_smoothing > 0.0:
        smooth = -log_probs.sum(dim=-1) / vocab
        return (1.0 - label_smoothing) * nll + label_smoothing * smooth
    return nll
