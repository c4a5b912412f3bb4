"""Softmax cross entropy with label smoothing, per token.

Port of ``apex_tpu/ops/xentropy.py`` (Apex's
``contrib.xentropy.SoftmaxCrossEntropyLoss``).  The JAX package computes
it in XLA and keeps no Pallas kernel for it, so this is plain PyTorch on
any device: the forward is a logsumexp and a gather over fp32 logits,
and the backward is one pass over the logits' rows,
``(softmax - (1 - s) at the label - s / V) * dloss``, with the label
column subtracted in place (no one-hot tensor).  The residuals are the
logits themselves and the per-token fp32 logsumexp.

Oracle: :func:`xentropy_reference`.
"""
from __future__ import annotations

import torch

__all__ = ["softmax_cross_entropy_loss", "xentropy_reference"]


def xentropy_reference(logits, labels, smoothing: float = 0.0):
    """``loss = lse - (1-s)*logit[y] - s * mean(logits)`` over fp32
    logits."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    if smoothing == 0.0:
        return lse - picked
    mean_all = logits.mean(dim=-1)
    return lse - (1.0 - smoothing) * picked - smoothing * mean_all


def _fwd(x, labels, smoothing: float):
    """Per-row ``(loss, lse)`` of fp32 logits ``x [n, V]``."""
    v = x.shape[-1]
    lse = torch.logsumexp(x, dim=-1)
    pick = torch.gather(x, 1, labels[:, None])[:, 0]
    loss = lse - pick
    if smoothing != 0.0:
        loss = loss + smoothing * (pick - x.sum(dim=-1) / v)
    return loss, lse


def subtract_at_labels_(p, labels, value: float):
    """``p[i, labels[i]] += value`` in place: the label column of the
    softmax grad without a one-hot tensor (``p + (-b)`` is IEEE
    ``p - b``, and every other column keeps ``p`` exactly)."""
    rows = torch.arange(p.shape[0], device=p.device)
    if not torch.is_tensor(value):
        value = torch.full((p.shape[0],), value, dtype=p.dtype,
                           device=p.device)
    return p.index_put_((rows, labels), value, accumulate=True)


class _SoftmaxCrossEntropy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits2, safe_labels, pad_mask, smoothing):
        loss, lse = _fwd(logits2.float(), safe_labels, smoothing)
        ctx.save_for_backward(logits2, lse, safe_labels, pad_mask)
        ctx.smoothing = smoothing
        return loss

    @staticmethod
    def backward(ctx, dloss):
        logits2, lse, safe_labels, pad_mask = ctx.saved_tensors
        s = ctx.smoothing
        p = torch.exp(logits2.float() - lse[:, None])
        subtract_at_labels_(p, safe_labels, -(1.0 - s))
        if s != 0.0:
            p.sub_(s / p.shape[1])
        p.mul_(torch.where(pad_mask, 0.0, dloss)[:, None])
        return p.to(logits2.dtype), None, None, None


def softmax_cross_entropy_loss(logits, labels, smoothing: float = 0.0,
                               padding_idx: int = -100,
                               half_to_float: bool = False):
    """Per-token fp32 CE loss, ``labels``' shape (Apex's
    ``SoftmaxCrossEntropyLoss.apply``); ``labels == padding_idx`` rows
    give 0 loss and 0 grad.  ``half_to_float`` is accepted for parity
    (the loss is always fp32)."""
    orig_shape = labels.shape
    v = logits.shape[-1]
    logits2 = logits.reshape(-1, v)
    labels1 = labels.reshape(-1)
    pad_mask = labels1 == padding_idx
    safe_labels = torch.where(pad_mask, 0, labels1).long()
    loss = _SoftmaxCrossEntropy.apply(logits2, safe_labels, pad_mask,
                                      float(smoothing))
    return torch.where(pad_mask, 0.0, loss).reshape(orig_shape)
