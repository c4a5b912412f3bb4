"""Model-parallel-aware gradient scaler.

Port of ``apex_tpu/transformer/amp/grad_scaler.py`` (reference:
``apex/transformer/amp/grad_scaler.py :: GradScaler`` — a
``torch.cuda.amp.GradScaler`` subclass whose only change is that
``found_inf`` is all-reduced across the model-parallel group, so every
pipeline and tensor stage skips, or takes, the same optimizer step).

The functional scaler of :mod:`apex_tpu_torch.amp.scaler` keeps its
state in device tensors; :meth:`GradScaler.unscale_` unscales a grad
tree with the fused kernel (:func:`~apex_tpu_torch.amp.scaler.unscale_grads`)
and all-reduces the overflow flag with ``MAX`` over the process group
of each axis of ``model_parallel_axes`` (default tensor and pipe), as a
device tensor.  An axis whose group has one rank, or no topology at all
(``parallel_state`` not initialised), keeps the local flag: the port's
form of JAX's unbound axis, whose ``pmax`` the JAX scaler skips.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist

from apex_tpu_torch.amp.scaler import (
    LossScaleState, init_loss_scale, scale_loss_value, unscale_grads,
    update_scale,
)
from apex_tpu_torch.parallel import _comm
from apex_tpu_torch.transformer import parallel_state
from apex_tpu_torch.transformer.parallel_state import PIPE_AXIS, TENSOR_AXIS

__all__ = ["GradScaler"]


class GradScaler:
    """Functional GradScaler whose overflow flag is reduced over the
    model-parallel axes (default: tensor + pipe).

    Usage on every rank of the step::

        scaler = GradScaler()
        state = scaler.init()
        scaled = scaler.scale(loss, state)
        grads, state = scaler.unscale_(grads, state)   # MAX of found_inf
        state = scaler.update(state)                   # skip shared

    ``device``: where :meth:`init` puts the state (CUDA unless ``"cpu"``
    is asked for).
    """

    def __init__(self, init_scale=2.0 ** 16, growth_factor=2.0,
                 backoff_factor=0.5, growth_interval=2000,
                 enabled: bool = True,
                 model_parallel_axes: Sequence[str] = (TENSOR_AXIS,
                                                      PIPE_AXIS),
                 device=None):
        self.init_scale = init_scale
        self.growth_factor = growth_factor
        self.backoff_factor = backoff_factor
        self.growth_interval = growth_interval
        self.enabled = enabled
        self.model_parallel_axes = tuple(model_parallel_axes)
        self.device = device

    def init(self) -> LossScaleState:
        state = init_loss_scale("dynamic", device=self.device)
        return state.replace(
            loss_scale=torch.full_like(state.loss_scale, self.init_scale))

    def scale(self, loss, state: LossScaleState):
        if not self.enabled:
            return loss
        return scale_loss_value(loss, state)

    def _reduce_found_inf(self, state: LossScaleState) -> LossScaleState:
        if not parallel_state.model_parallel_is_initialized():
            return state            # no topology: the local flag
        flag = state.found_inf
        for axis in self.model_parallel_axes:
            group = parallel_state.resolve_group(axis)
            if dist.get_world_size(group) > 1:
                flag = _comm.all_reduce(flag.reshape(1).clone(), group,
                                        op=dist.ReduceOp.MAX).reshape(())
        return state.replace(found_inf=flag)

    def unscale_(self, grads, state: LossScaleState):
        """``grads`` (a tree of tensors) times 1/scale, through the fused
        kernel, and the state with the overflow flag shared by every
        model-parallel rank.  Returns ``(unscaled grads, state)``."""
        if not self.enabled:
            return grads, state
        grads, state = unscale_grads(grads, state)
        return grads, self._reduce_found_inf(state)

    def update(self, state: LossScaleState) -> LossScaleState:
        if not self.enabled:
            return state
        return update_scale(
            state, growth_factor=self.growth_factor,
            backoff_factor=self.backoff_factor,
            growth_interval=self.growth_interval)
