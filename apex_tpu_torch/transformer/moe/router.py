"""Top-k router for MoE layers.

Port of ``apex_tpu/transformer/moe/router.py`` (the Switch/GShard recipe
with Megatron-core's knob names):

* router logits in **fp32** whatever the activation dtype (the weight is
  fp32 whatever ``params_dtype`` is),
* top-k selection and renormalized gates; on equal probabilities the
  lower expert index is taken first, as ``jax.lax.top_k`` takes it (a
  stable descending sort: ``torch.topk`` promises no order on ties),
* the Switch **load-balancing loss** ``E * sum_e f_e * P_e``,
* the ST-MoE **router z-loss** ``mean(logsumexp(logits)^2)``,
* ``sinkhorn`` routing (S-BASE): selection through the doubly-stochastic
  normalization of the row-max-shifted ``exp(logits)``, gates from the
  plain softmax, ``top_k == 1`` only.

The aux losses are returned, not added to the output: the caller scales
them and adds them to the task loss.  Input jitter (``jitter_eps``) is
drawn from the caller's ``torch.Generator`` in training mode only.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["TopKRouter", "load_balancing_loss", "router_z_loss",
           "sinkhorn"]

_LOAD_BALANCING_TYPES = ("aux_loss", "sinkhorn", "none")


def load_balancing_loss(router_probs, expert_index_one_hot) -> torch.Tensor:
    """Switch aux loss: ``E * sum_e f_e * P_e`` (Fedus et al. 2021 eq. 4).

    ``router_probs``: [tokens, E] fp32 softmax probabilities.
    ``expert_index_one_hot``: [tokens, E] 0/1, a token's chosen experts
    (the top-k union, normalized by k so that uniform routing gives 1)."""
    num_experts = router_probs.shape[-1]
    k = torch.clamp(expert_index_one_hot.sum()
                    / expert_index_one_hot.shape[0], min=1e-9)
    f = expert_index_one_hot.mean(dim=0) / k
    p = router_probs.mean(dim=0)
    return num_experts * torch.sum(f * p)


def router_z_loss(router_logits) -> torch.Tensor:
    """ST-MoE z-loss: ``mean(logsumexp(logits)^2)`` (Zoph et al. 2022)."""
    z = torch.logsumexp(router_logits, dim=-1)
    return torch.mean(z * z)


def sinkhorn(cost, n_iters: int = 8, eps: float = 1e-8) -> torch.Tensor:
    """Sinkhorn-Knopp normalization of a positive [tokens, E] matrix
    toward doubly stochastic, a fixed ``n_iters`` rounds (Megatron-core's
    ``sinkhorn``; the S-BASE router of Clark et al. 2022)."""
    cost = cost.float()
    d1 = torch.ones(cost.shape[1], dtype=torch.float32, device=cost.device)
    for _ in range(n_iters):
        d0 = 1.0 / torch.clamp(
            cost.shape[0] * torch.sum(cost * d1[None, :], dim=1), min=eps)
        d1 = 1.0 / torch.clamp(
            cost.shape[1] * torch.sum(cost * d0[:, None], dim=0), min=eps)
    return cost * d0[:, None] * d1[None, :]


def top_k(x, k: int):
    """``jax.lax.top_k`` over the last dim: ``(values, indices)`` in
    descending order, equal values in ascending index order."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def router_init(w: torch.Tensor, generator=None) -> torch.Tensor:
    """The JAX router's ``normal(stddev=0.02)``, in place."""
    with torch.no_grad():
        return w.normal_(0.0, 0.02, generator=generator)


def check_routing(load_balancing_type: str, k: int) -> None:
    """The JAX router's two refusals (``ValueError``)."""
    if load_balancing_type not in _LOAD_BALANCING_TYPES:
        raise ValueError(
            f"unknown load_balancing_type {load_balancing_type!r}")
    if load_balancing_type == "sinkhorn" and k != 1:
        # a doubly-stochastic matrix balances only the argmax (Megatron-
        # core asserts the same)
        raise ValueError("sinkhorn routing requires top_k=1")


class TopKRouter(nn.Module):
    """Learned top-k gate (Megatron-core: ``TopKRouter``) with its fp32
    ``weight [num_experts, hidden_size]``.

    ``forward(x, deterministic=True, generator=None)`` returns ``(gates,
    expert_index, aux)``: ``gates`` [tokens, k] fp32 combine weights,
    ``expert_index`` [tokens, k] int64 expert ids, ``aux`` a dict with
    the ``load_balancing_loss`` and ``z_loss`` scalars.  ``init_method``
    fills the weight in place (default ``normal(0, 0.02)``), drawing from
    ``generator`` where given."""

    def __init__(self, num_experts: int, hidden_size: int, top_k: int = 2,
                 renormalize: bool = True, jitter_eps: float = 0.0,
                 load_balancing_type: str = "aux_loss",
                 init_method: Optional[Callable] = None, device=None,
                 generator=None):
        super().__init__()
        check_routing(load_balancing_type, top_k)
        self.num_experts, self.top_k = num_experts, top_k
        self.renormalize, self.jitter_eps = renormalize, jitter_eps
        self.load_balancing_type = load_balancing_type
        w = torch.empty(num_experts, hidden_size, dtype=torch.float32,
                        device=device)
        (init_method or router_init)(w, generator=generator)
        self.weight = nn.Parameter(w)

    def forward(self, x, *, deterministic: bool = True, generator=None
                ) -> Tuple[torch.Tensor, torch.Tensor, dict]:
        check_routing(self.load_balancing_type, self.top_k)
        if self.jitter_eps and not deterministic:
            if generator is None:
                raise ValueError("router jitter in training mode needs "
                                 "generator= (flax's 'jitter' rng)")
            u = torch.rand(x.shape, generator=generator, device=x.device,
                           dtype=torch.float32)
            x = x * (1.0 - self.jitter_eps
                     + 2.0 * self.jitter_eps * u).to(x.dtype)
        logits = torch.matmul(x.float(), self.weight.t())     # [tokens, E]
        probs = torch.softmax(logits, dim=-1)
        if self.load_balancing_type == "sinkhorn":
            # select through the balanced assignment, gate from the plain
            # softmax; the row max shifted out first (sinkhorn is
            # invariant to a row's scale, and exp overflows fp32 past ~88)
            stable = logits - logits.max(dim=-1, keepdim=True)[0].detach()
            balanced = sinkhorn(torch.exp(stable).detach())
            _, expert_index = top_k(balanced, self.top_k)
            gates = torch.gather(probs, -1, expert_index)
        else:
            gates, expert_index = top_k(probs, self.top_k)
        if self.renormalize and self.top_k > 1:
            gates = gates / torch.clamp(gates.sum(dim=-1, keepdim=True),
                                        min=1e-9)
        chosen = F.one_hot(expert_index, self.num_experts).float().sum(dim=1)
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        aux = {"load_balancing_loss":
               load_balancing_loss(probs, chosen)
               if self.load_balancing_type == "aux_loss" else zero,
               "z_loss": router_z_loss(logits)}
        return gates, expert_index, aux
