"""Flat-native functional optimizer core: Adam(W) over one flat buffer.

Port of the dense, Adam half of ``apex_tpu/optimizers/functional.py``:
:class:`FlatState` (an fp32 flat master, a step count, the rule's slot
buffers, the leaf layout and an ``unravel``) and :func:`fused_adam`
(``_AdamTx``: ``init(params) -> FlatState``, ``update(state,
flat_grads, noop_flag=, grad_scale=) -> FlatState``) over
:func:`apex_tpu_torch.ops.fused_update.fused_adam_flat`.

The JAX ``update`` is pure and XLA donates the old buffers; here the
kernel updates master and slots IN PLACE and ``update`` returns a new
:class:`FlatState` over the same buffers with the advanced count (a
0-d device tensor: the bias corrections are computed from it on the
device).  As in JAX the count advances on a skipped (noop) step too.

Not ported yet: the ZeRO layouts (``shard=``, ``prefetch=``; ROADMAP
queue 1, item 6) and the LAMB, SGD, NovoGrad and Adagrad rules
(ROADMAP queue 2, kernels #10-#12 and #14-#16).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from apex_tpu_torch.ops.fused_update import fused_adam_flat
from apex_tpu_torch.utils import tree_leaves_with_path, tree_ravel

__all__ = ["FlatState", "fused_adam"]


@dataclasses.dataclass(frozen=True)
class FlatState:
    """Flat optimizer state: fp32 master + per-rule slot buffers.

    ``sizes`` (per-leaf element counts, in the flax tree's leaf order),
    ``flat_dtype`` (the leaves' promoted dtype, the buffer dtype of
    ``tree_ravel``) and ``unravel`` are static layout."""
    master: torch.Tensor            # fp32 flat master buffer
    count: torch.Tensor             # 0-d f32: completed update count
    slots: dict                     # rule buffers, keyed like state_dict
    sizes: tuple = ()
    flat_dtype: torch.dtype = torch.float32
    unravel: Optional[Callable] = None

    def replace(self, **kw) -> "FlatState":
        return dataclasses.replace(self, **kw)

    @property
    def global_numel(self) -> int:
        return sum(self.sizes)

    def params(self, dtype=None) -> dict:
        """Materialize the params tree (the checkpoint/eval boundary):
        new tensors in the construction dtypes, or floating leaves cast
        to ``dtype``."""
        if self.unravel is None:
            raise ValueError(
                "FlatState was initialized from a flat buffer (no "
                "unravel); read .master directly or init from a tree")
        tree = self.unravel(self.master.to(self.flat_dtype))
        return tree if dtype is None else _cast_floating(tree, dtype)


def _cast_floating(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast_floating(v, dtype) for k, v in tree.items()}
    return tree.to(dtype) if tree.is_floating_point() else tree


def _init_state(tx, params, shard=None, prefetch=None) -> FlatState:
    """Shared init: ravel a tree (an ``nn.Module`` or a nested dict of
    tensors), or take an already-flat buffer, into a fresh fp32 master
    plus the rule's zero slots, on the parameters' device."""
    if shard is not None or prefetch is not None:
        raise NotImplementedError(
            "ZeRO-sharded optimizer state (shard=, prefetch=) is not ported "
            "yet (ROADMAP queue 1, item 6)")
    if isinstance(params, torch.Tensor) and params.dim() == 1:
        flat, unravel = params.detach(), None
        sizes = (int(flat.numel()),)
    else:
        flat, unravel = tree_ravel(params)
        sizes = tuple(int(t.numel()) for _, t in
                      tree_leaves_with_path(params))
    master = flat.to(torch.float32, copy=True)
    return FlatState(
        master=master,
        count=torch.zeros((), dtype=torch.float32, device=master.device),
        slots=tx.init_slots(master, sizes=sizes),
        sizes=sizes, flat_dtype=flat.dtype, unravel=unravel)


@dataclasses.dataclass(frozen=True)
class _AdamTx:
    """Functional FusedAdam(W) (kernel: :func:`fused_adam_flat`)."""
    lr: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    adam_w_mode: bool = True
    bias_correction: bool = True

    def init(self, params, shard=None, prefetch=None) -> FlatState:
        return _init_state(self, params, shard=shard, prefetch=prefetch)

    def init_slots(self, master, *, sizes) -> dict:
        return {"exp_avg": torch.zeros_like(master),
                "exp_avg_sq": torch.zeros_like(master)}

    def update(self, state: FlatState, flat_grads, *, noop_flag=0.0,
               grad_scale=1.0, lr=None, beta1=None, beta2=None, eps=None,
               weight_decay=None) -> FlatState:
        t = state.count + 1.0
        fused_adam_flat(
            state.master, flat_grads,
            state.slots["exp_avg"], state.slots["exp_avg_sq"],
            lr=self.lr if lr is None else lr,
            beta1=self.beta1 if beta1 is None else beta1,
            beta2=self.beta2 if beta2 is None else beta2,
            eps=self.eps if eps is None else eps,
            weight_decay=(self.weight_decay if weight_decay is None
                          else weight_decay),
            step=t, adam_w_mode=self.adam_w_mode,
            bias_correction=self.bias_correction,
            noop_flag=noop_flag, grad_scale=grad_scale)
        return state.replace(count=t)


def fused_adam(lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0,
               adam_w_mode=True, bias_correction=True) -> _AdamTx:
    return _AdamTx(lr=float(lr), beta1=float(betas[0]),
                   beta2=float(betas[1]), eps=float(eps),
                   weight_decay=float(weight_decay),
                   adam_w_mode=bool(adam_w_mode),
                   bias_correction=bool(bias_correction))
