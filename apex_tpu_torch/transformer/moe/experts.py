"""Expert FFNs evaluated as one batched product.

Port of ``apex_tpu/transformer/moe/experts.py``: the local experts'
weights are expert-major stacked tensors ``w1 [E_local, h, f]`` and ``w2
[E_local, f, h]`` (biases ``b1 [E_local, 1, f]``, ``b2 [E_local, 1,
h]``), contracted with the capacity-padded token buffer ``[E_local, cap,
h]`` in one ``torch.bmm`` each (``einsum('ech,ehf->ecf')``): no loop over
experts.  The JAX package leaves these einsums to XLA (no Pallas
kernel), so they are plain PyTorch products here too.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["GroupedMLP", "expert_init"]

#: flax's truncated_normal divides the std by the std of a unit normal
#: truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def expert_init(w: torch.Tensor, generator=None) -> torch.Tensor:
    """flax's ``variance_scaling(1.0, "fan_avg", "truncated_normal",
    in_axis=-2, out_axis=-1, batch_axis=(0,))`` in place: each expert
    ``w[e]`` an independent 2-D xavier draw over its last two dims (the
    expert dim a batch dim, not folded into the fan), truncated at two
    standard deviations."""
    fan_in, fan_out = w.shape[-2], w.shape[-1]
    std = math.sqrt(1.0 / ((fan_in + fan_out) / 2.0)) / _TRUNC_STD
    with torch.no_grad():
        return nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                     generator=generator)


def gelu(x):
    """``jax.nn.gelu``: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


class GroupedMLP(nn.Module):
    """The local shard of experts: ``num_local_experts`` independent
    2-layer FFNs on an expert-major token buffer ``[num_local_experts,
    capacity, hidden]`` (the buffer the dispatch produces, see
    :mod:`apex_tpu_torch.transformer.moe.layer`).

    ``ffn_hidden_size`` is the LOCAL width: under tensor parallelism the
    caller passes ``ffn/tp`` and owns the output's sum, and ``use_bias``
    must then be False.  The weights are cast to the activation dtype
    for the products; ``init_method`` fills ``w1`` and ``w2`` in place
    (default :func:`expert_init`) from ``generator`` where given; the
    biases start at zero."""

    def __init__(self, num_local_experts: int, hidden_size: int,
                 ffn_hidden_size: int, activation: Callable = gelu,
                 use_bias: bool = True, params_dtype: Any = torch.float32,
                 init_method: Optional[Callable] = None, device=None,
                 generator=None):
        super().__init__()
        e, h, f = num_local_experts, hidden_size, ffn_hidden_size
        self.num_local_experts, self.hidden_size = e, h
        self.ffn_hidden_size, self.use_bias = f, use_bias
        self.activation = activation
        init = init_method or expert_init
        kw = dict(dtype=params_dtype, device=device)
        w1, w2 = torch.empty(e, h, f, **kw), torch.empty(e, f, h, **kw)
        init(w1, generator=generator)
        init(w2, generator=generator)
        self.w1, self.w2 = nn.Parameter(w1), nn.Parameter(w2)
        if use_bias:
            self.b1 = nn.Parameter(torch.zeros(e, 1, f, **kw))
            self.b2 = nn.Parameter(torch.zeros(e, 1, h, **kw))

    def forward(self, x):
        dt = x.dtype
        y = torch.bmm(x, self.w1.to(dt))
        if self.use_bias:
            y = y + self.b1.to(dt)
        y = self.activation(y)
        out = torch.bmm(y, self.w2.to(dt))
        if self.use_bias:
            out = out + self.b2.to(dt)
        return out
