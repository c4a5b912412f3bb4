"""Data-parallel gradient communication (reference:
``apex/parallel/distributed.py :: DistributedDataParallel,
flat_dist_call``).

Port of ``apex_tpu/parallel/distributed.py``.  Where the JAX step
``psum``s the grads over the ``data`` mesh axis inside one XLA program,
each rank here all-reduces over the axis's ``torch.distributed`` group
(:func:`apex_tpu_torch.transformer.parallel_state.resolve_group`: a
mesh-axis name, ``None`` for the dense data-parallel axes, or a
``ProcessGroup``).  The knobs and the arithmetic are JAX's:

* ``message_size`` — grads are bucketed along LEAF boundaries, greedy
  by bytes and split where the dtype changes (:meth:`_leaf_buckets`),
  one all-reduce a bucket;
* ``delay_allreduce=True`` — one all-reduce of the whole flat buffer;
* ``allreduce_always_fp32``, ``gradient_average``,
  ``gradient_predivide_factor`` — pre-divide, sum, post-scale by
  ``predivide / world``, cast back.

The all-reduces run after the backward, on the grads handed to
:meth:`DistributedDataParallel.reduce_gradients`: no hook launches a
bucket during the backward.  The flat-native step's grads are one
flat buffer, so one all-reduce; use
``make_train_step(grad_transform=ddp.reduce_gradients)``.
"""
from __future__ import annotations

import torch

from apex_tpu_torch.parallel import _comm
from apex_tpu_torch.utils import (_rebuild, _skeleton, tree_leaves_with_path,
                                  tree_ravel)

__all__ = ["DistributedDataParallel", "flat_allreduce"]

_DEFAULT_MESSAGE_SIZE = 10_000_000  # bytes, reference default ~10MB


def _resolve_data_axes(axis_name):
    """``None`` -> the dense params' data-parallel axes (``data``, with
    ``expert`` / ``context`` when those are active); anything else as
    given."""
    if axis_name is not None:
        return axis_name
    from apex_tpu_torch.transformer import parallel_state as ps
    if not ps.model_parallel_is_initialized():
        return ps.DATA_AXIS
    return ps.get_dense_param_grad_axes()


def _group(axis_name):
    from apex_tpu_torch.transformer.parallel_state import resolve_group
    return resolve_group(axis_name)


def flat_allreduce(tree, axis_name=None):
    """Flatten a tree, one all-reduce (sum), unflatten (reference:
    ``flat_dist_call`` over ``apex_C.flatten`` + ``dist.all_reduce``).
    Returns a new tree of the leaves' dtypes."""
    flat, unravel = tree_ravel(tree)
    return unravel(_comm.all_reduce(flat, _group(_resolve_data_axes(
        axis_name))))


class DistributedDataParallel:
    """Gradient-averaging data parallelism over a process group.

    As in JAX this does not wrap the module's forward: only the gradient
    reduction exists.  Call :meth:`reduce_gradients` on the grads (a
    tree, or the flat-native step's flat buffer) on every rank."""

    def __init__(self, module=None, message_size: int = _DEFAULT_MESSAGE_SIZE,
                 delay_allreduce: bool = False,
                 allreduce_always_fp32: bool = False,
                 gradient_average: bool = True,
                 gradient_predivide_factor: float = 1.0,
                 axis_name=None,
                 num_allreduce_streams: int = 1,
                 allreduce_communicators=None,
                 shared_param=None):
        self.module = module  # pass-through for API parity
        self.message_size = message_size
        self.delay_allreduce = delay_allreduce
        self.allreduce_always_fp32 = allreduce_always_fp32
        self.gradient_average = gradient_average
        self.gradient_predivide_factor = gradient_predivide_factor
        # resolved at reduce time: a DDP built before
        # initialize_model_parallel sees the axes built after it
        self._axis_name = axis_name

    @property
    def axis_name(self):
        return _resolve_data_axes(self._axis_name)

    @axis_name.setter
    def axis_name(self, value):
        self._axis_name = value

    def __call__(self, *args, **kw):
        if self.module is None:
            raise TypeError("DistributedDataParallel was constructed without "
                            "a module; call reduce_gradients on grads "
                            "instead.")
        return self.module(*args, **kw)

    def _reduce_flat(self, flat: torch.Tensor) -> torch.Tensor:
        """Reduce a flat buffer IN PLACE and return it: pre-divide, sum,
        post-scale by ``predivide / world``, cast back."""
        group = _group(self.axis_name)
        work = flat.float() if self.allreduce_always_fp32 \
            and flat.dtype != torch.float32 else flat
        if self.gradient_predivide_factor != 1.0:
            work.div_(self.gradient_predivide_factor)
        _comm.all_reduce(work, group)
        if self.gradient_average:
            post = self.gradient_predivide_factor / \
                torch.distributed.get_world_size(group)
            if post != 1.0:
                work.mul_(post)
        # gradient_average=False: no post-scaling (reference semantics)
        if work is not flat:
            flat.copy_(work)
        return flat

    def _leaf_buckets(self, leaves):
        """Greedy ~message_size buckets of LEAF INDICES, in leaf order,
        split at DTYPE boundaries; a leaf larger than the bucket size gets
        a bucket of its own."""
        buckets, cur, cur_bytes, cur_dtype = [], [], 0, None
        for i, leaf in enumerate(leaves):
            nbytes = leaf.numel() * leaf.element_size()
            if cur and (cur_bytes + nbytes > self.message_size
                        or leaf.dtype != cur_dtype):
                buckets.append(cur)
                cur, cur_bytes = [], 0
            cur.append(i)
            cur_bytes += nbytes
            cur_dtype = leaf.dtype
        if cur:
            buckets.append(cur)
        return buckets

    def reduce_gradients(self, grads):
        """Average ``grads`` over the data-parallel group, bucketed.

        A tensor (the flat-native step's flat grads) is one leaf: it is
        reduced in place, in one all-reduce, and returned.  A tree (a
        nested dict or list of tensors) returns a new tree of the leaves'
        dtypes: one all-reduce a bucket of :meth:`_leaf_buckets`, or one
        for the whole tree with ``delay_allreduce`` or when it fits in
        ``message_size``."""
        if isinstance(grads, torch.Tensor):
            self._reduce_flat(grads.view(-1))
            return grads
        leaves = [t for _, t in tree_leaves_with_path(grads)]
        total_bytes = sum(t.numel() * t.element_size() for t in leaves)
        if self.delay_allreduce or total_bytes <= self.message_size \
                or len(leaves) == 1:
            flat, unravel = tree_ravel(grads)
            return unravel(self._reduce_flat(flat))
        out = list(leaves)
        for bucket in self._leaf_buckets(leaves):
            flat, unravel = tree_ravel([leaves[i] for i in bucket])
            for i, leaf in zip(bucket, unravel(self._reduce_flat(flat))):
                out[i] = leaf
        return _rebuild(_skeleton(grads), iter(out))
