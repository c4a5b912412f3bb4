"""Ring attention: exact attention over a sequence sharded across the
context-parallel ranks.

Port of ``apex_tpu/ops/ring_attention.py`` (RingAttention, Liu et al.
2023).  Rank ``i`` of the context group holds tokens ``[i * s, (i + 1) *
s)`` of q, k and v; K/V shards rotate around the ring (rank r -> r + 1,
:func:`apex_tpu_torch.parallel._comm.ring_hop`), and at each of the cp
steps the flash kernels compute the partial of this rank's queries
against the shard it holds, merged in log space:

    m   = max(lse_a, lse_b)
    out = (out_a 2^(lse_a - m) + out_b 2^(lse_b - m))
          / (2^(lse_a - m) + 2^(lse_b - m))

in base 2, the kernels' lse.  The partials stay fp32: on bf16 operands
each pair's forward and backward run the flash kernels' fp32-output
instances (``out_dtype=torch.float32``: ``flash_attention_f32out``,
``flash_attention_drop_f32out``, ``flash_attention_bwd_f32out``,
``flash_attention_bwd_drop_f32out``), so nothing rounds to bf16 at a
merge or an accumulation; on the CPU their plain versions.  The backward
runs each pair's one-pass backward with the GLOBAL out and lse (p =
exp2(s - lse) is the true softmax there); dq accumulates in fp32 on its
rank and the fp32 dk/dv accumulators travel with their K/V shard, cp
hops in all, so they come home.

Causal masking across shards: the shard held at step t came from rank
(my - t) mod cp, visible when my >= t, diagonal at t = 0.  Step 0 runs
the locally causal kernel, a visible later step the full one, and an
invisible pair is skipped (no kernel, no merge) while its rank still
joins every hop.  Dropout drops at GLOBAL coordinates (the seed operand's
row and column offsets, ``my * s`` and ``src * s``), so the sharded
result equals the dense one with the same seed: the seed must be the
same on every cp rank.

The context group comes from ``parallel_state`` (``axis_name``, default
``"context"``; without ``initialize_model_parallel`` a name raises its
``RuntimeError``) or is a ``ProcessGroup`` passed as ``axis_name``.  cp
= 1, or ``axis_name=None``, is :func:`flash_attention`.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from apex_tpu_torch.ops.attention import (_bwd, _flash_route, _fwd,
                                          _seed_operand, flash_attention,
                                          mha_reference)
from apex_tpu_torch.parallel import _comm
from apex_tpu_torch.transformer import parallel_state
from apex_tpu_torch.transformer.parallel_state import CONTEXT_AXIS

__all__ = ["ring_attention", "ring_attention_reference"]

_LANES = 128


def ring_attention_reference(q, k, v, *, causal=False,
                             sm_scale: Optional[float] = None,
                             dropout_rate: float = 0.0,
                             dropout_seed=None):
    """Oracle: plain attention on the FULL (already gathered) sequence,
    with dropout the same global-coordinate keep mask the ring draws."""
    return mha_reference(q, k, v, causal=causal, sm_scale=sm_scale,
                         dropout_rate=dropout_rate,
                         dropout_seed=dropout_seed)


def _fit_block(s: int, preferred: int):
    """The JAX package's block fit: the largest block <= ``preferred``
    that divides ``s`` and is a multiple of 128 (``s`` itself when ``s
    <= preferred``); None where none does."""
    if s <= preferred:
        return s
    for cand in range(preferred, _LANES - 1, -_LANES):
        if s % cand == 0:
            return cand
    return None


def _merge(out_a, lse_a, out_b, lse_b):
    """Log-space combine (base 2) of two attention partials over the
    same queries."""
    m = torch.maximum(lse_a, lse_b)
    wa = torch.exp2(lse_a - m)[..., None]
    wb = torch.exp2(lse_b - m)[..., None]
    out = (out_a * wa + out_b * wb) / (wa + wb)
    return out, m + torch.log2(wa[..., 0] + wb[..., 0])


class _Ring(torch.autograd.Function):
    """The ring's forward and its backward (the JAX ``run`` custom VJP):
    the forward saves q, k, v, the global out (q's dtype) and lse; the
    seed is carried as an argument and given no gradient."""

    @staticmethod
    def forward(ctx, q3, k3, v3, seed, causal, scale, rate, group, head_dim):
        ctx.causal, ctx.scale, ctx.rate, ctx.group = causal, scale, rate, group
        ctx.seed, ctx.head_dim = seed, head_dim
        out, lse = _ring_fwd(ctx, q3, k3, v3)
        ctx.save_for_backward(q3, k3, v3, out, lse)
        return out

    @staticmethod
    def backward(ctx, do3):
        q3, k3, v3, out, lse = ctx.saved_tensors
        dq, dk, dv = _ring_bwd(ctx, q3, k3, v3, out, lse, do3.contiguous())
        return dq, dk, dv, None, None, None, None, None, None


def _step(ctx, t: int):
    """Step ``t``'s pair: ``(visible, causal, seed3)``, the held shard
    from rank ``(my - t) mod cp``."""
    cp, my = dist.get_world_size(ctx.group), dist.get_rank(ctx.group)
    if ctx.causal and t > 0 and my < t:
        return False, False, None
    seed3 = None
    if ctx.rate:
        s = ctx.s_local
        seed3 = _seed_operand(ctx.seed, my * s, ((my - t) % cp) * s,
                              device=ctx.device)
    return True, ctx.causal and t == 0, seed3


def _ring_fwd(ctx, q3, k3, v3):
    cp = dist.get_world_size(ctx.group)
    ctx.s_local, ctx.device = q3.shape[1], q3.device
    out = torch.zeros(q3.shape, dtype=torch.float32, device=q3.device)
    lse = torch.full(q3.shape[:2], -1e30, dtype=torch.float32,
                     device=q3.device)
    kv = torch.stack((k3, v3))
    for t in range(cp):
        visible, causal, seed3 = _step(ctx, t)
        if visible:
            o_t, l_t = _fwd(q3, kv[0], kv[1], causal, ctx.scale,
                            rate=ctx.rate, seed3=seed3,
                            out_dtype=torch.float32)
            out, lse = _merge(out, lse, o_t, l_t)
            del o_t, l_t
        if t < cp - 1:
            kv = _comm.ring_hop(kv, ctx.group)
    return out.to(q3.dtype), lse


def _ring_bwd(ctx, q3, k3, v3, out, lse, do3):
    cp = dist.get_world_size(ctx.group)
    dq = torch.zeros(q3.shape, dtype=torch.float32, device=q3.device)
    kv = torch.stack((k3, v3))
    dkv = torch.zeros(kv.shape, dtype=torch.float32, device=q3.device)
    pad = {} if ctx.head_dim == q3.shape[2] else {"head_dim": ctx.head_dim}
    for t in range(cp):
        visible, causal, seed3 = _step(ctx, t)
        if visible:
            dq_t, dk_t, dv_t = _bwd(q3, kv[0], kv[1], out, lse, do3, causal,
                                    ctx.scale, rate=ctx.rate, seed3=seed3,
                                    out_dtype=torch.float32, **pad)
            dq += dq_t
            dkv[0] += dk_t
            dkv[1] += dv_t
            del dq_t, dk_t, dv_t
        # the accumulators travel with their shard: cp hops bring them
        # home; the shard itself is needed for cp - 1 more steps
        if t < cp - 1:
            kv = _comm.ring_hop(kv, ctx.group)
        dkv = _comm.ring_hop(dkv, ctx.group)
    return (dq.to(q3.dtype), dkv[0].to(k3.dtype), dkv[1].to(v3.dtype))


def ring_attention(q, k, v, *, causal: bool = False,
                   sm_scale: Optional[float] = None,
                   axis_name=CONTEXT_AXIS,
                   block_q: Optional[int] = None,
                   block_k: Optional[int] = None,
                   dropout_rate: float = 0.0,
                   dropout_seed=None):
    """Exact attention over a context-sharded sequence.

    ``q, k, v``: ``[b, h, s_local, d]``, this rank's sequence shard (rank
    i holds tokens ``[i * s_local, (i + 1) * s_local)``); returns the
    local output shard, differentiable in q, k and v.  ``axis_name``: the
    context axis's name (its group from ``parallel_state``) or a
    ``ProcessGroup``; every rank of the group calls this together.

    ``dropout_rate`` > 0 drops attention probabilities in the kernels at
    GLOBAL sequence coordinates, so the sharded result equals the
    unsharded :func:`flash_attention` / :func:`mha_reference` run with
    the same seed.  ``dropout_seed`` (an int, or an int tensor of one
    element) must be IDENTICAL on every cp rank.

    ``block_q``/``block_k`` are checked as the JAX entry checks them (a
    shard length that no 128-multiple block of at most that size, 1024
    by default, divides raises ``ValueError``); the CUDA kernels' tiles
    are their own."""
    b, h, s_local, d = q.shape
    scale = (d ** -0.5) if sm_scale is None else sm_scale
    group = (None if axis_name is None
             else parallel_state.resolve_group(axis_name))
    cp = 1 if group is None else dist.get_world_size(group)
    if cp == 1:
        return flash_attention(q, k, v, causal=causal, sm_scale=scale,
                               block_q=block_q, block_k=block_k,
                               dropout_rate=dropout_rate,
                               dropout_seed=dropout_seed)
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(
            f"dropout_rate must be in [0, 1), got {dropout_rate}")
    if dropout_rate and dropout_seed is None:
        raise ValueError("dropout_rate > 0 requires dropout_seed")
    default_block = 1024 if d <= 128 else 512
    bq = _fit_block(s_local, block_q or default_block)
    bk = _fit_block(s_local, block_k or default_block)
    if bq is None or bk is None:
        raise ValueError(
            f"ring_attention local shard length {s_local} must tile into "
            f"lane-multiple blocks")
    _, dp = _flash_route(q.dtype, d, False, dropout_rate)
    q3, k3, v3 = (t.reshape(b * h, s_local, d).contiguous()
                  for t in (q, k, v))
    if dp != d:
        # the instance's head dim, as flash_attention pads it
        q3, k3, v3 = (torch.nn.functional.pad(t, (0, dp - d))
                      for t in (q3, k3, v3))
    out = _Ring.apply(q3, k3, v3, dropout_seed if dropout_rate else None,
                      causal, scale, float(dropout_rate), group, d)
    return out[..., :d].reshape(b, h, s_local, d)
