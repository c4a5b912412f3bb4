"""Ulysses attention: exact attention over a context-sharded sequence by
two all-to-all reshards (DeepSpeed-Ulysses, Jacobs et al. 2023).

Port of ``apex_tpu/ops/ulysses_attention.py``:

* q, k and v arrive sequence-sharded ``[b, h, s/cp, d]`` on the context
  group;
* ONE all-to-all of the stacked q/k/v reshards them to head shards
  ``[b, h/cp, s, d]``: each rank holds the whole sequence for its heads;
* :func:`flash_attention` runs on them unchanged (heads are
  independent: no cross-rank softmax algebra);
* one all-to-all reshards the output back to ``[b, h, s/cp, d]``.

Each all-to-all is :func:`apex_tpu_torch.transformer.tensor_parallel.
mappings.all_to_all` (the reshard the MoE layer's token exchange runs on
too), whose backward is the inverse reshard (JAX's ``all_to_all``
transpose).  ``h % cp`` must be 0.
With dropout the seed is folded with the rank
(:func:`~apex_tpu_torch.ops.attention.fold_rank_seed`): each rank's heads
draw their own stream, a valid regularizer but not the unsharded run's
bits (:func:`ring_attention` keeps those).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from apex_tpu_torch.ops.attention import flash_attention, fold_rank_seed
from apex_tpu_torch.transformer import parallel_state
from apex_tpu_torch.transformer.parallel_state import CONTEXT_AXIS
from apex_tpu_torch.transformer.tensor_parallel.mappings import (  # noqa: F401
    _reshard, all_to_all)

__all__ = ["ulysses_attention"]


def _context_size(axis_name):
    """``(group, cp)``: the JAX rule for an axis the mesh does not bind
    -- only the canonical context axis with no topology (or a context
    axis of one rank) degrades to one rank; any other name without its
    group raises."""
    if axis_name is None:
        return None, 1
    if not isinstance(axis_name, dist.ProcessGroup) \
            and axis_name == CONTEXT_AXIS \
            and not parallel_state.model_parallel_is_initialized():
        return None, 1
    group = parallel_state.resolve_group(axis_name)
    return group, dist.get_world_size(group)


def ulysses_attention(q, k, v, *, causal: bool = False,
                      sm_scale: Optional[float] = None,
                      axis_name=CONTEXT_AXIS,
                      block_q: Optional[int] = None,
                      block_k: Optional[int] = None,
                      dropout_rate: float = 0.0,
                      dropout_seed=None):
    """Exact attention over a context-sharded sequence via head/sequence
    all-to-all reshards.

    ``q, k, v``: ``[b, h, s_local, d]``, this rank's sequence shard (the
    contract of :func:`ring_attention`); ``h % cp == 0``.  Returns the
    local output shard ``[b, h, s_local, d]``, differentiable in q, k and
    v.  ``axis_name``: the context axis's name or a ``ProcessGroup``.

    ``dropout_rate`` > 0 drops in the kernels with the seed folded with
    this rank's index (rank-decorrelated streams, not the unsharded run's
    bits)."""
    group, cp = _context_size(axis_name)
    if cp == 1:
        return flash_attention(q, k, v, causal=causal, sm_scale=sm_scale,
                               block_q=block_q, block_k=block_k,
                               dropout_rate=dropout_rate,
                               dropout_seed=dropout_seed)
    if dropout_rate and dropout_seed is None:
        raise ValueError("dropout_rate > 0 requires dropout_seed")
    b, h, s_local, d = q.shape
    if h % cp != 0:
        raise ValueError(
            f"ulysses_attention needs heads divisible by the context "
            f"axis size: {h} % {cp} != 0 (use ring_attention otherwise)")
    # one inbound all-to-all for the stacked q/k/v, one outbound
    qkv = all_to_all(torch.stack([q, k, v]), group, 2, 3)
    drop_kw = {}
    if dropout_rate:
        drop_kw = dict(dropout_rate=dropout_rate,
                       dropout_seed=fold_rank_seed(dropout_seed, group))
    o = flash_attention(qkv[0], qkv[1], qkv[2], causal=causal,
                        sm_scale=sm_scale, block_q=block_q, block_k=block_k,
                        **drop_kw)
    # [b, h/cp, s, d] -> [b, h, s/cp, d]
    return all_to_all(o, group, 2, 1)
