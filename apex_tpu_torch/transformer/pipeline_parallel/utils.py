"""Pipeline utilities (reference:
``apex/transformer/pipeline_parallel/utils.py``): the microbatch
calculator's globals, model listification, and the slicing of one
microbatch out of a batch.

Port of ``apex_tpu/transformer/pipeline_parallel/utils.py``.  A batch
is a tensor or a dict, list or tuple of them (nested); :func:`tree_map`,
:func:`tree_leaves` and :func:`tree_unflatten_like` walk such trees,
the leaves in the order ``jax.tree_util`` gives the matching pytree
(dict keys sorted).
"""
from __future__ import annotations

from typing import Callable, Optional

from apex_tpu_torch.transformer.microbatches import (
    build_num_microbatches_calculator,
)
from apex_tpu_torch.utils import _rebuild, tree_leaves_with_path

__all__ = [
    "setup_microbatch_calculator",
    "get_num_microbatches",
    "get_current_global_batch_size",
    "update_num_microbatches",
    "listify_model",
    "get_kth_microbatch",
    "_reconfigure_microbatch_calculator",
]

_GLOBAL_NUM_MICROBATCHES_CALCULATOR = None


def setup_microbatch_calculator(rank: int, rampup_batch_size,
                                global_batch_size: int,
                                micro_batch_size: int,
                                data_parallel_size: int) -> None:
    global _GLOBAL_NUM_MICROBATCHES_CALCULATOR
    assert _GLOBAL_NUM_MICROBATCHES_CALCULATOR is None, (
        "microbatch calculator is already initialized")
    _GLOBAL_NUM_MICROBATCHES_CALCULATOR = build_num_microbatches_calculator(
        rank, rampup_batch_size, global_batch_size, micro_batch_size,
        data_parallel_size)


def _reconfigure_microbatch_calculator(rank: int, rampup_batch_size,
                                       global_batch_size: int,
                                       micro_batch_size: int,
                                       data_parallel_size: int) -> None:
    global _GLOBAL_NUM_MICROBATCHES_CALCULATOR
    _GLOBAL_NUM_MICROBATCHES_CALCULATOR = build_num_microbatches_calculator(
        rank, rampup_batch_size, global_batch_size, micro_batch_size,
        data_parallel_size)


def get_num_microbatches() -> int:
    return _GLOBAL_NUM_MICROBATCHES_CALCULATOR.get()


def get_current_global_batch_size() -> Optional[int]:
    if _GLOBAL_NUM_MICROBATCHES_CALCULATOR is None:
        return None
    return _GLOBAL_NUM_MICROBATCHES_CALCULATOR.get_current_global_batch_size()


def update_num_microbatches(consumed_samples,
                            consistency_check: bool = True) -> None:
    _GLOBAL_NUM_MICROBATCHES_CALCULATOR.update(
        consumed_samples, consistency_check)


def listify_model(model):
    if isinstance(model, (list, tuple)):
        return list(model)
    return [model]


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` (nested dicts, lists and tuples) in JAX's
    order: dict keys sorted at every level."""
    return [leaf for _, leaf in tree_leaves_with_path(tree)]


def tree_unflatten_like(tree, leaves: list):
    """``tree``'s containers holding ``leaves``, given in
    :func:`tree_leaves` order (dicts come back with their keys sorted)."""
    return _rebuild(tree, iter(leaves))


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``), in ``tree``'s own containers."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def get_kth_microbatch(batch, k: int, micro_batch_size: int):
    """Slice microbatch ``k`` out of a global batch (a tensor or a dict,
    list or tuple of them; the leading dim is the batch)."""
    return tree_map(
        lambda x: x[k * micro_batch_size:(k + 1) * micro_batch_size], batch)
