"""Mixture-of-Experts with expert parallelism.

Port of ``apex_tpu/transformer/moe`` (GShard / Switch, Megatron-core's
module names):

* :class:`~apex_tpu_torch.transformer.moe.router.TopKRouter` -- top-k
  softmax gating with the load-balancing aux loss and the router z-loss
  (or sinkhorn routing);
* :class:`~apex_tpu_torch.transformer.moe.experts.GroupedMLP` -- the local
  experts' FFNs as one batched product;
* :class:`~apex_tpu_torch.transformer.moe.layer.MoELayer` -- dense
  dispatch/combine (or gather indices) around an all-to-all over the
  expert group, and :func:`reduce_moe_grads`, the split grad reduction.

Everything is differentiable through PyTorch ops and the all-to-all's
autograd Function (whose backward is the inverse reshard); ep = 1 is a
single-rank MoE with no collectives.
"""
from apex_tpu_torch.transformer.moe.experts import GroupedMLP
from apex_tpu_torch.transformer.moe.layer import (MoELayer, reduce_moe_grads,
                                                  resolve_dispatch_mode)
from apex_tpu_torch.transformer.moe.router import (TopKRouter,
                                                   load_balancing_loss,
                                                   sinkhorn)

__all__ = ["TopKRouter", "GroupedMLP", "MoELayer", "load_balancing_loss",
           "reduce_moe_grads", "resolve_dispatch_mode", "sinkhorn"]
