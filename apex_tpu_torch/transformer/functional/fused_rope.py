"""Rotary positional embedding with cached cos/sin.

Port of ``apex_tpu/transformer/functional/fused_rope.py ::
fused_apply_rotary_pos_emb_cached``: plain PyTorch elementwise work
(the JAX package leaves it to XLA's fusion too).  The rotation follows
the interleave-halves convention (``rotate_half``), applied to the
first ``cos_.shape[-1]`` channels with any remainder passed through;
cos/sin are cast to the input's dtype first, as in the JAX package.
"""
from __future__ import annotations

import torch

__all__ = ["fused_apply_rotary_pos_emb_cached"]


def _rotate_half(x):
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat((-x2, x1), dim=-1)


def _apply(t, cos_, sin_):
    rot_dim = cos_.shape[-1]
    t_rot, t_pass = t[..., :rot_dim], t[..., rot_dim:]
    t_rot = t_rot * cos_ + _rotate_half(t_rot) * sin_
    if t_pass.shape[-1] == 0:
        return t_rot
    return torch.cat((t_rot, t_pass), dim=-1)


def fused_apply_rotary_pos_emb_cached(t, cos_, sin_):
    """RoPE from cached cos/sin tables broadcastable against ``t``."""
    return _apply(t, cos_.to(t.dtype), sin_.to(t.dtype))
