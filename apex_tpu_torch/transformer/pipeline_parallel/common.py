"""Common pipeline-schedule machinery (reference:
``apex/transformer/pipeline_parallel/schedules/common.py`` —
``build_model``, ``forward_step``, ``backward_step``).

Port of ``apex_tpu/transformer/pipeline_parallel/common.py``.  The
executors in ``schedules.py`` run the same steps tick by tick; these are
exported standalone for code that composes its own schedule, or
tests that want one microbatch's forward and backward in isolation.
"""
from __future__ import annotations

from typing import Callable, List, Optional

import torch

from apex_tpu_torch.transformer.pipeline_parallel.utils import (
    tree_leaves, tree_unflatten_like)

__all__ = ["build_model", "forward_step", "backward_step"]


def build_model(model_provider_func: Callable,
                wrap_with_ddp: bool = True,
                virtual_pipeline_model_parallel_size: Optional[int] = None,
                *args, **kwargs) -> List:
    """This pipeline rank's model chunk(s) (reference: ``common.py ::
    build_model``).

    The provider is called as ``model_provider_func(*args,
    pre_process=..., post_process=..., **kwargs)``, once a chunk.  The
    flags are per CHUNK, as in JAX: chunk 0 gets ``pre_process`` (it
    holds virtual stage 0, on pipe rank 0) and chunk ``v - 1``
    ``post_process``; with one chunk, both.  ``wrap_with_ddp`` is
    accepted for parity: grads are reduced by the training step
    (``DistributedDataParallel``), not by a wrapper here.
    """
    v = virtual_pipeline_model_parallel_size
    if v is not None and v > 1:
        return [model_provider_func(
            *args, pre_process=(chunk == 0),
            post_process=(chunk == v - 1), **kwargs)
            for chunk in range(v)]
    return [model_provider_func(
        *args, pre_process=True, post_process=True, **kwargs)]


def forward_step(stage_fn: Callable, params, input_tensor, microbatch,
                 loss_fn: Optional[Callable] = None,
                 losses_reduced: Optional[list] = None):
    """One microbatch through one stage (reference: ``common.py ::
    forward_step``).  Returns the stage output; when ``loss_fn`` is given
    (the last stage), the loss, which is appended to ``losses_reduced``.
    """
    output = stage_fn(params, input_tensor, microbatch)
    if loss_fn is not None:
        loss = loss_fn(output, microbatch)
        if losses_reduced is not None:
            losses_reduced.append(loss)
        return loss
    return output


def _grad_leaves(tree) -> list:
    """Leaves of ``tree`` as new autograd leaves sharing its storage:
    floating tensors require grad, others are kept as they are."""
    return [t.detach().requires_grad_(t.is_floating_point())
            if isinstance(t, torch.Tensor) else t for t in tree_leaves(tree)]


def _grads(outputs: list, output_grads: list, inputs: list) -> list:
    """``torch.autograd.grad`` of ``outputs`` (those that require grad)
    seeded with the matching ``output_grads``, with respect to the
    inputs that require grad; zeros for such an input the outputs do not
    reach, ``None`` for the others."""
    pairs = [(y, g) for y, g in zip(outputs, output_grads)
             if isinstance(y, torch.Tensor) and y.requires_grad]
    want = [i for i, t in enumerate(inputs) if isinstance(t, torch.Tensor)
            and t.requires_grad]
    got = torch.autograd.grad([y for y, _ in pairs],
                              [inputs[i] for i in want],
                              [g for _, g in pairs], allow_unused=True)
    out: list = [None] * len(inputs)
    for i, g in zip(want, got):
        out[i] = torch.zeros_like(inputs[i]) if g is None else g
    return out


def backward_step(stage_fn: Callable, params, input_tensor, microbatch,
                  output_grad):
    """One microbatch's backward through one stage (reference:
    ``common.py :: backward_step``, which injects the received output
    grad into autograd).  Functional, as in JAX: returns ``(input_grad,
    param_grads)`` from ``torch.autograd.grad`` of the stage's output
    seeded with ``output_grad``; no ``.grad`` is touched.  A
    non-floating input leaf gets a zero grad."""
    p_leaves = _grad_leaves(params)
    x_leaves = _grad_leaves(input_tensor)
    with torch.enable_grad():
        y = stage_fn(tree_unflatten_like(params, p_leaves),
                     tree_unflatten_like(input_tensor, x_leaves), microbatch)
    g = _grads(tree_leaves(y), tree_leaves(output_grad),
               x_leaves + p_leaves)
    g = [torch.zeros_like(t) if d is None else d
         for t, d in zip(x_leaves + p_leaves, g)]
    dx = tree_unflatten_like(input_tensor, g[:len(x_leaves)])
    dparams = tree_unflatten_like(params, g[len(x_leaves):])
    return dx, dparams

