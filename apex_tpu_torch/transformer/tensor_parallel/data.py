"""Tensor-parallel data broadcast (port of
``apex_tpu/transformer/tensor_parallel/data.py``; reference:
``apex/transformer/tensor_parallel/data.py``).

Every rank of a tensor-parallel group must consume the same batch:
:func:`broadcast_data` sends tensor rank 0's arrays to the others.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from apex_tpu_torch.parallel import _comm
from apex_tpu_torch.transformer import parallel_state
from apex_tpu_torch.transformer.parallel_state import TENSOR_AXIS

__all__ = ["broadcast_data"]


def broadcast_data(keys, data, datatype=torch.int32, axis_name=TENSOR_AXIS):
    """``{k: tensor rank 0's data[k]}`` as ``datatype`` on every rank of
    the ``axis_name`` group (a mesh-axis name or a ``ProcessGroup``).
    Every rank passes arrays of the same shapes (as in JAX); one
    broadcast a key from the group's rank 0.  A group of one rank
    returns its own data cast."""
    group = parallel_state.resolve_group(axis_name)
    out = {}
    for k in keys:
        # a copy: the broadcast writes in place
        x = torch.as_tensor(data[k]).to(datatype, copy=True).contiguous()
        if dist.get_world_size(group) > 1:
            _comm.broadcast(x, dist.get_global_rank(group, 0), group)
        out[k] = x
    return out
