"""Shared machinery of the fused optimizers.

Port of the dense half of ``apex_tpu/optimizers/base.py``: the per-leaf
broadcast the flat rules use where a scalar per tensor meets the flat
buffer.  The ZeRO span helpers (``shard_leaf_spans`` and friends) come
with the sharded state (ROADMAP queue 1, item 6) and the class API
(``FusedOptimizerBase``) with the optimizer classes (queue 1, item 3).
"""
from __future__ import annotations

from typing import Sequence

import torch

__all__ = ["broadcast_leaf_scalars"]


def broadcast_leaf_scalars(scalars: torch.Tensor,
                           sizes: Sequence[int]) -> torch.Tensor:
    """Expand a ``(num_leaves,)`` vector to a flat per-element buffer:
    element ``j`` of leaf ``i`` holds ``scalars[i]``.  Built from static
    broadcasts and one concatenate, on the scalars' device, with no
    read back to the host."""
    if not sizes:
        return torch.zeros((0,), dtype=scalars.dtype, device=scalars.device)
    return torch.cat([scalars[i].expand(int(s))
                      for i, s in enumerate(sizes)])
