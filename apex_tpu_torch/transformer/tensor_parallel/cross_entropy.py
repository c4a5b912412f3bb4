"""Vocab-parallel cross entropy.

Port of ``apex_tpu/transformer/tensor_parallel/cross_entropy.py``
(reference: ``_VocabParallelCrossEntropy``).  At tp = 1 (the local
path) plain PyTorch over the logits (a log-softmax, the target's
log-probability, optional label smoothing), differentiated by autograd
as the JAX path is by ``jax.grad``; ``half_residuals`` is an autograd
Function instead whose only logits-sized residual is the softmax in
bf16 (Apex's xentropy kernel keeps its softmax in the half dtype).

At tp > 1 the logits are ``[..., vocab / tp]``, this rank's vocab
shard, and no full-vocab tensor is gathered: an autograd Function
all-reduces each row's max (MAX), the sum of exps (SUM), the target
logit from the one rank that holds it (a masked gather, SUM) and, with
smoothing, the logit sums (SUM).  Its backward is collective-free,
``(softmax - (1-s)·onehot - s/V) · g`` with the off-shard targets
masked.  As in JAX, this path has no padding support: a ``-100``
target clips into rank 0's shard.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from apex_tpu_torch.ops.xentropy import subtract_at_labels_
from apex_tpu_torch.parallel import _comm
from apex_tpu_torch.transformer import parallel_state
from apex_tpu_torch.transformer.parallel_state import TENSOR_AXIS
from apex_tpu_torch.transformer.tensor_parallel import mappings
from apex_tpu_torch.transformer.utils import VocabUtility

__all__ = ["vocab_parallel_cross_entropy"]


def _ce_grad_(softmax, target, smoothing: float, vocab: int, g,
              off_shard=None):
    """``(softmax - (1-s)·onehot - s/V) * g`` in place over ``softmax
    [n, V]``; the label column is subtracted at its index (the same bits
    as the one-hot form), except in the rows ``off_shard`` marks."""
    value = -(1.0 - smoothing)
    if off_shard is not None:
        value = torch.where(off_shard, 0.0, value).to(softmax.dtype)
    subtract_at_labels_(softmax, target, value)
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


class _VocabParallelCE(torch.autograd.Function):
    """The sharded loss over ``group`` (module docstring)."""

    @staticmethod
    def forward(ctx, logits, target, smoothing: float, half: bool, group):
        n, rank = dist.get_world_size(group), dist.get_rank(group)
        vp = logits.shape[-1]
        full = vp * n
        start, end = VocabUtility.vocab_range_from_per_partition_vocab_size(
            vp, rank, n)
        lmax = _comm.all_reduce(logits.amax(dim=-1).contiguous(), group,
                                dist.ReduceOp.MAX)
        shifted = logits - lmax[..., None]
        e = torch.exp(shifted)
        sum_exp = _comm.all_reduce(e.sum(dim=-1), group)
        off = (target < start) | (target >= end)
        local = (target - start).clamp(0, vp - 1)
        pred = torch.gather(shifted, -1, local[..., None])[..., 0]
        pred = _comm.all_reduce(torch.where(off, 0.0, pred), group)
        log_sum_exp = torch.log(sum_exp)
        loss = log_sum_exp - pred
        if smoothing > 0.0:
            sum_log = _comm.all_reduce(shifted.sum(dim=-1), group) \
                - full * log_sum_exp
            loss = (1.0 - smoothing) * loss + smoothing * (-sum_log / full)
        del shifted
        softmax = e.div_(sum_exp[..., None])
        if half:
            softmax = softmax.to(torch.bfloat16)
        ctx.save_for_backward(softmax, off, local)
        ctx.smoothing, ctx.full, ctx.logits_dtype = (smoothing, full,
                                                     logits.dtype)
        return loss

    @staticmethod
    def backward(ctx, g):
        softmax, off, local = ctx.saved_tensors
        vp = softmax.shape[-1]
        grad = _ce_grad_(softmax.float().reshape(-1, vp), local.reshape(-1),
                         ctx.smoothing, ctx.full, g.float().reshape(-1),
                         off_shard=off.reshape(-1))
        return (grad.reshape(softmax.shape).to(ctx.logits_dtype), None, None,
                None, None)


def vocab_parallel_cross_entropy(vocab_parallel_logits, target,
                                 label_smoothing: float = 0.0,
                                 axis_name=TENSOR_AXIS,
                                 half_residuals: bool = False, *,
                                 tensor_model_parallel_size=None):
    """Per-token CE loss over vocab-sharded logits, the logits' leading
    shape; ``target`` holds int GLOBAL vocab ids.  The tp size is the
    ``axis_name`` group's (a topology or a ``ProcessGroup``), else
    ``tensor_model_parallel_size`` (default 1, the local path; above 1
    without a group: ``RuntimeError``).  ``half_residuals`` keeps the
    backward's softmax in bf16 instead of fp32."""
    tp = mappings.axis_size(axis_name, tensor_model_parallel_size)
    if tp > 1:
        return _VocabParallelCE.apply(
            vocab_parallel_logits, target.long(), float(label_smoothing),
            bool(half_residuals), parallel_state.resolve_group(axis_name))
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
