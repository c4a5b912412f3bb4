"""Chunked fused LM head + softmax cross entropy: the ``[tokens, vocab]``
logits tensor exists only one token chunk at a time.

Port of ``apex_tpu/ops/fused_lm_xent.py`` (the technique of Liger
Kernel's ``FusedLinearCrossEntropy``).  A ``torch.autograd.Function``
whose forward loops over token chunks: each chunk projects
``hidden @ head_w.T`` (the GEMM in the operands' promoted dtype, then
fp32, so a row equals the unfused head's logits), reduces to per-token
``(loss, lse)`` and frees its slice.  The saved tensors are the op's
inputs and the ``[tokens]`` lse, nothing of size tokens x vocab.  The
backward re-projects each chunk, forms the softmax grad from the saved
lse (the label column subtracted in place, no one-hot tensor) and runs
the two GEMMs, accumulating ``dhead_w`` in fp32 across chunks as the
JAX scan carry does: on CUDA the bf16 GEMM writes fp32 straight from
its accumulator (``torch.addmm(..., out_dtype=torch.float32)``); the CPU
has no such kernel, so there the operands are upcast, which computes
the same products.  ``vocab_chunk`` > 0 also walks the vocab in slices
with the online max / sum-exp, shrinking the transient to
``[token_chunk, vocab_chunk]``.

The JAX package computes all of this in XLA, outside any Pallas kernel,
so the port's products are ``torch.matmul`` / ``torch.addmm`` and the
rest plain PyTorch on any device.

:func:`fused_lm_head_vocab_parallel_cross_entropy` over a tensor group
of more than one rank takes this rank's ``[vocab / tp, hidden]`` head
rows: per token chunk the per-token max (MAX), sum of exps, target logit
and, with smoothing, logit sum (SUM) are all-reduced over the group, the
algebra of the sharded ``vocab_parallel_cross_entropy``.  Its backward
is collective-free by default (each rank's ``dhidden`` is its partial);
``grad_input_psum=True`` all-reduces ``dhidden``, the contract of an
untied ``ColumnParallelLinear`` head.

Loss (:func:`apex_tpu_torch.ops.xentropy.softmax_cross_entropy_loss`)::

    loss = lse - (1-s) * logit[y] - s * sum(logits) / V
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

from apex_tpu_torch.ops.xentropy import (softmax_cross_entropy_loss,
                                         subtract_at_labels_)
from apex_tpu_torch.parallel import _comm

__all__ = ["fused_lm_head_cross_entropy",
           "fused_lm_head_vocab_parallel_cross_entropy",
           "lm_head_xentropy_reference",
           "xent_chunk_default", "xent_vocab_chunk_default"]

def xent_chunk_default() -> int:
    """``APEX_TPU_XENT_CHUNK``: the token chunk the loss heads use when
    ``fused_head_xent=`` / ``token_chunk=`` is not passed (0 = the
    unfused head)."""
    return int(os.environ.get("APEX_TPU_XENT_CHUNK", "0"))


def xent_vocab_chunk_default() -> int:
    """``APEX_TPU_XENT_VOCAB_CHUNK``: the vocab slice of the fused head's
    online logsumexp when ``vocab_chunk=`` is not passed (0 = the whole
    vocab a token chunk)."""
    return int(os.environ.get("APEX_TPU_XENT_VOCAB_CHUNK", "0"))


def lm_head_xentropy_reference(hidden, head_w, labels,
                               smoothing: float = 0.0,
                               padding_idx: int = -100):
    """The unfused head: the full ``[tokens, vocab]`` logits, then the
    softmax cross entropy.  It is the ``token_chunk <= 0`` path."""
    logits = torch.matmul(hidden, head_w.T)
    return softmax_cross_entropy_loss(logits, labels, smoothing=smoothing,
                                      padding_idx=padding_idx)


def _project_f32(hc, w):
    """One chunk's logits in fp32: the GEMM in the operands' promoted
    dtype, then the cast."""
    dt = torch.promote_types(hc.dtype, w.dtype)
    return torch.matmul(hc.to(dt), w.to(dt).T).float()


def _slices(v: int, vocab_chunk: int):
    """``(start, stop)`` of the vocab slices: one, or ``v / vocab_chunk``."""
    if vocab_chunk and 0 < vocab_chunk < v:
        return [(j, j + vocab_chunk) for j in range(0, v, vocab_chunk)]
    return [(0, v)]


def _chunk_loss_lse(hc, lc, w, smoothing: float, vocab_chunk: int):
    """Per-token ``(loss, lse)`` of one token chunk, the only place a
    logits slice lives in the forward."""
    v = w.shape[0]
    slices = _slices(v, vocab_chunk)
    if len(slices) == 1:
        x = _project_f32(hc, w)                            # [C, V]
        lse = torch.logsumexp(x, dim=-1)
        pick = torch.gather(x, 1, lc[:, None])[:, 0]
        sumx = x.sum(dim=-1)
    else:
        c = hc.shape[0]
        m = torch.full((c,), -torch.inf, device=hc.device)
        s = torch.zeros(c, device=hc.device)
        pick = torch.zeros(c, device=hc.device)
        sumx = torch.zeros(c, device=hc.device)
        for start, stop in slices:
            x = _project_f32(hc, w[start:stop])            # [C, Vc]
            m_new = torch.maximum(m, x.amax(dim=-1))
            s = s * torch.exp(m - m_new) + torch.exp(
                x - m_new[:, None]).sum(dim=-1)
            idx = lc - start
            inb = (idx >= 0) & (idx < stop - start)
            val = torch.gather(x, 1, idx.clamp(0, stop - start - 1)[:, None])
            pick = pick + torch.where(inb, val[:, 0], 0.0)
            sumx = sumx + x.sum(dim=-1)
            m = m_new
        lse = m + torch.log(s)
    loss = lse - pick
    if smoothing != 0.0:
        loss = loss + smoothing * (pick - sumx / v)
    return loss, lse


def _wgrad_add_(dw, g, hc):
    """``dw += g^T hc`` with ``dw`` fp32: on CUDA the GEMM writes fp32
    from its accumulator whatever the operands' dtype; on the CPU the
    operands are upcast (the same products, summed in fp32)."""
    if g.dtype == torch.float32:
        return dw.addmm_(g.T, hc)
    if dw.device.type == "cuda":
        return torch.addmm(dw, g.T, hc, out_dtype=torch.float32, out=dw)
    return dw.addmm_(g.T.float(), hc.float())


def _slice_grads(hc, lc, lse_c, d_c, wj, start: int, smoothing: float,
                 v: int, dt, dw_j):
    """One ``[chunk, vocab slice]`` re-projection's grads: the softmax
    from the saved lse, ``-(1 - s)`` at the labels that land in this
    slice, ``- s / v`` over the full vocab, the (pad-masked) loss
    cotangent, then the two GEMMs.  Returns ``dhc`` in ``dt``; adds the
    slice's weight grad into the fp32 ``dw_j``."""
    p = _project_f32(hc, wj).sub_(lse_c[:, None]).exp_()
    idx = lc - start
    inb = (idx >= 0) & (idx < wj.shape[0])
    subtract_at_labels_(p, idx.clamp(0, wj.shape[0] - 1),
                        torch.where(inb, -(1.0 - smoothing), 0.0))
    if smoothing != 0.0:
        p.sub_(smoothing / v)
    g = p.mul_(d_c[:, None]).to(dt)
    del p                      # the fp32 slice goes before the two GEMMs
    hcd = hc.to(dt)
    dhc = torch.matmul(g, wj.to(dt))
    if dw_j is not None:
        _wgrad_add_(dw_j, g, hcd)
    return dhc


class _FusedLMHeadCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h2, head_w, labels, pad_mask, c: int,
                smoothing: float, vocab_chunk: int, n: int):
        losses, lses = [], []
        for i in range(0, h2.shape[0], c):
            loss, lse = _chunk_loss_lse(h2[i:i + c], labels[i:i + c], head_w,
                                        smoothing, vocab_chunk)
            losses.append(loss)
            lses.append(lse)
        # the residuals are the op's inputs and the O(tokens) lse
        ctx.save_for_backward(h2, head_w, labels, pad_mask, torch.cat(lses))
        ctx.c, ctx.smoothing, ctx.vocab_chunk, ctx.n = (c, smoothing,
                                                        vocab_chunk, n)
        return torch.cat(losses)[:n]

    @staticmethod
    def backward(ctx, dloss):
        h2, head_w, labels, pad_mask, lse = ctx.saved_tensors
        c, s, vocab_chunk, n = ctx.c, ctx.smoothing, ctx.vocab_chunk, ctx.n
        v, hdim = head_w.shape
        dt = torch.promote_types(h2.dtype, head_w.dtype)
        d = torch.zeros(h2.shape[0], dtype=torch.float32, device=h2.device)
        d[:n] = torch.where(pad_mask, 0.0, dloss.float())
        want_w = ctx.needs_input_grad[1]
        dw = (torch.zeros(v, hdim, dtype=torch.float32, device=h2.device)
              if want_w else None)
        slices = _slices(v, vocab_chunk)
        dh = []
        for i in range(0, h2.shape[0], c):
            hc, lc, lse_c, d_c = (t[i:i + c] for t in (h2, labels, lse, d))
            if len(slices) == 1:
                dhc = _slice_grads(hc, lc, lse_c, d_c, head_w, 0, s, v, dt,
                                   dw)
            else:
                dhc = torch.zeros(hc.shape[0], hdim, dtype=torch.float32,
                                  device=h2.device)
                for start, stop in slices:
                    dhc += _slice_grads(
                        hc, lc, lse_c, d_c, head_w[start:stop], start, s, v,
                        dt, None if dw is None else dw[start:stop]).float()
            dh.append(dhc.to(h2.dtype))
        # padded rows carry d == 0, so their dh rows are exact zeros
        return (torch.cat(dh), None if dw is None else dw.to(head_w.dtype),
                None, None, None, None, None, None)


def _token_rows(hidden, labels, padding_idx: int, token_chunk: int):
    """The heads' token rows: ``hidden`` as ``[n, hidden_size]`` and the
    labels (``padding_idx`` rows as label 0) zero-padded to a multiple of
    the chunk (the whole ``n`` for ``token_chunk <= 0``); returns those,
    the ``[n]`` padding mask and the chunk."""
    h2 = hidden.reshape(-1, hidden.shape[-1])
    lab = labels.reshape(-1).long()
    n = h2.shape[0]
    c = min(int(token_chunk), n) if token_chunk > 0 else n
    pad_mask = lab == padding_idx
    safe_labels = torch.where(pad_mask, 0, lab)
    n_pad = (-n) % c
    if n_pad:
        h2 = torch.cat([h2, h2.new_zeros(n_pad, h2.shape[1])])
        safe_labels = torch.cat([safe_labels, safe_labels.new_zeros(n_pad)])
    return h2, safe_labels, pad_mask, c


def fused_lm_head_cross_entropy(hidden, head_w, labels, *,
                                smoothing: float = 0.0,
                                padding_idx: int = -100,
                                token_chunk: int | None = None,
                                vocab_chunk: int | None = None):
    """Per-token CE loss of the LM head ``hidden @ head_w.T`` without the
    ``[tokens, vocab]`` logits.

    ``hidden [..., hidden_size]`` (leading dims flatten to the tokens);
    ``head_w [vocab, hidden_size]`` (a tied head passes the embedding
    table, an untied one its ``ColumnParallelLinear`` weight); ``labels``
    ``hidden.shape[:-1]`` int ids, ``padding_idx`` rows give 0 loss and
    0 grad.  ``token_chunk``: rows a chunk (``None`` reads
    ``APEX_TPU_XENT_CHUNK``; ``<= 0`` is :func:`lm_head_xentropy_reference`
    exactly); a token count it does not divide is padded.
    ``vocab_chunk``: the vocab slice of the online logsumexp (``None``
    reads ``APEX_TPU_XENT_VOCAB_CHUNK``; must divide the vocab).
    Differentiable in ``hidden`` and ``head_w``."""
    if token_chunk is None:
        token_chunk = xent_chunk_default()
    if vocab_chunk is None:
        vocab_chunk = xent_vocab_chunk_default()
    if token_chunk <= 0:
        return lm_head_xentropy_reference(hidden, head_w, labels,
                                          smoothing=smoothing,
                                          padding_idx=padding_idx)
    v, hdim = head_w.shape
    if vocab_chunk and vocab_chunk > 0 and v % vocab_chunk:
        raise ValueError(f"vocab_chunk {vocab_chunk} must divide "
                         f"vocab {v}")
    h2, safe_labels, pad_mask, c = _token_rows(hidden, labels, padding_idx,
                                               token_chunk)
    loss = _FusedLMHeadCE.apply(h2, head_w, safe_labels, pad_mask, c,
                                float(smoothing), int(vocab_chunk or 0),
                                pad_mask.numel())
    return torch.where(pad_mask, 0.0, loss).reshape(labels.shape)


class _FusedVocabParallelCE(torch.autograd.Function):
    """The vocab-parallel head over ``group`` (module docstring)."""

    @staticmethod
    def forward(ctx, h2, w, labels, pad_mask, c: int, smoothing: float,
                n: int, group, psum_dh: bool):
        tp, rank = dist.get_world_size(group), dist.get_rank(group)
        vp = w.shape[0]
        v, start = vp * tp, rank * vp
        losses, lses = [], []
        for i in range(0, h2.shape[0], c):
            hc, lc = h2[i:i + c], labels[i:i + c]
            x = _project_f32(hc, w)                        # [C, V/tp]
            m = _comm.all_reduce(x.amax(dim=-1), group, dist.ReduceOp.MAX)
            shifted = x.sub_(m[:, None])
            sum_exp = _comm.all_reduce(torch.exp(shifted).sum(dim=-1), group)
            idx = lc - start
            off = (idx < 0) | (idx >= vp)
            pred = torch.gather(shifted, 1, idx.clamp(0, vp - 1)[:, None])[
                :, 0]
            pred = _comm.all_reduce(torch.where(off, 0.0, pred), group)
            log_sum_exp = torch.log(sum_exp)
            loss = log_sum_exp - pred
            if smoothing > 0.0:
                sum_log = _comm.all_reduce(shifted.sum(dim=-1), group) \
                    - v * log_sum_exp
                loss = (1.0 - smoothing) * loss + smoothing * (-sum_log / v)
            losses.append(loss)
            lses.append(m + log_sum_exp)
            del x, shifted
        ctx.save_for_backward(h2, w, labels, pad_mask, torch.cat(lses))
        ctx.c, ctx.smoothing, ctx.n, ctx.v, ctx.start = (c, smoothing, n, v,
                                                         start)
        ctx.group, ctx.psum_dh = group, psum_dh
        return torch.cat(losses)[:n]

    @staticmethod
    def backward(ctx, dloss):
        h2, w, labels, pad_mask, lse = ctx.saved_tensors
        c, s, n = ctx.c, ctx.smoothing, ctx.n
        dt = torch.promote_types(h2.dtype, w.dtype)
        d = torch.zeros(h2.shape[0], dtype=torch.float32, device=h2.device)
        d[:n] = torch.where(pad_mask, 0.0, dloss.float())
        dw = torch.zeros(w.shape, dtype=torch.float32, device=h2.device)
        dh = []
        for i in range(0, h2.shape[0], c):
            hc, lc, lse_c, d_c = (t[i:i + c] for t in (h2, labels, lse, d))
            dh.append(_slice_grads(hc, lc, lse_c, d_c, w, ctx.start, s,
                                   ctx.v, dt, dw))
        dh2 = torch.cat(dh)
        if ctx.psum_dh:
            _comm.all_reduce(dh2, ctx.group)
        # padded rows carry d == 0, so their dh rows are exact zeros
        return (dh2.to(h2.dtype), dw.to(w.dtype), None, None, None, None,
                None, None, None)


def fused_lm_head_vocab_parallel_cross_entropy(
        hidden, head_w_shard, labels, *, smoothing: float = 0.0,
        padding_idx: int = -100, axis_name=None,
        token_chunk: int | None = None, grad_input_psum: bool = False,
        tensor_model_parallel_size=None):
    """The vocab-parallel head: ``head_w_shard`` is this rank's ``[vocab
    / tp, hidden]`` rows; ``labels`` global ids.  ``axis_name`` (default
    the tensor axis) or a ``ProcessGroup`` names the group; the tp size
    is its size where a topology or a group is at hand, else
    ``tensor_model_parallel_size`` (default 1; above 1 without a group:
    ``RuntimeError``).  At tp = 1 the local op with the whole vocab a
    chunk (``vocab_chunk=0``), as in the JAX package.  ``padding_idx``
    rows give 0 loss and 0 grad on every rank.  ``grad_input_psum=True``
    all-reduces ``dhidden`` over the group; by default each rank's is
    its partial."""
    from apex_tpu_torch.transformer import parallel_state
    from apex_tpu_torch.transformer.parallel_state import TENSOR_AXIS
    from apex_tpu_torch.transformer.tensor_parallel import mappings
    if axis_name is None:
        axis_name = TENSOR_AXIS
    tp = mappings.axis_size(axis_name, tensor_model_parallel_size)
    if tp == 1:
        return fused_lm_head_cross_entropy(
            hidden, head_w_shard, labels, smoothing=smoothing,
            padding_idx=padding_idx, token_chunk=token_chunk, vocab_chunk=0)
    if token_chunk is None:
        token_chunk = xent_chunk_default()
    h2, safe_labels, pad_mask, c = _token_rows(hidden, labels, padding_idx,
                                               token_chunk)
    loss = _FusedVocabParallelCE.apply(
        h2, head_w_shard, safe_labels, pad_mask, c, float(smoothing),
        pad_mask.numel(), parallel_state.resolve_group(axis_name),
        bool(grad_input_psum))
    return torch.where(pad_mask, 0.0, loss).reshape(labels.shape)
