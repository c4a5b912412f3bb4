"""Stage-to-stage activation and grad exchange over the pipe group.

Port of ``apex_tpu/transformer/pipeline_parallel/p2p_communication.py``
(reference: ``apex/transformer/pipeline_parallel/p2p_communication.py ::
_communicate``).  The JAX functions rotate a payload one step around the
pipe axis with ``ppermute``; here each rotation is a ring hop of
:func:`apex_tpu_torch.parallel._comm.ring_hop` over the pipe group
(``batch_isend_irecv``: every rank sends and receives in one call; over
gloo on CUDA the hop is staged through host tensors).

Semantics of the ring, as in JAX: rank r's payload lands on r + 1
(forward) or r - 1 (backward), and the wrap-around edge (last -> first,
first -> last) is kept; callers ignore what they do not need (the
schedules do).  A payload is a tensor or a dict, list or tuple of them.
Every rank of the group must call the same functions in the same order.
``tensor_shape`` and the reference's other kwargs (``dtype_``,
``timers``, ...) are accepted and ignored: the payload carries its
shape.

``axis_name`` is a mesh-axis name resolved by
:func:`apex_tpu_torch.transformer.parallel_state.resolve_group` (without
the topology it raises ``RuntimeError`` naming
``initialize_model_parallel``: no rank quietly exchanges with itself),
or a ``torch.distributed`` ``ProcessGroup``.

The fused pairs (:func:`send_forward_recv_backward`,
:func:`send_backward_recv_forward`) run their two hops one after the
other, each with its own tag: at two stages both directions join the
same two ranks, and an activation must never arrive as a gradient.
"""
from __future__ import annotations

from apex_tpu_torch.parallel import _comm
from apex_tpu_torch.transformer import parallel_state
from apex_tpu_torch.transformer.parallel_state import PIPE_AXIS
from apex_tpu_torch.transformer.pipeline_parallel.utils import tree_map

__all__ = [
    "send_forward", "recv_forward", "send_backward", "recv_backward",
    "send_forward_recv_backward", "send_backward_recv_forward",
    "send_forward_recv_forward", "send_backward_recv_backward",
]


def _shift(x, direction: int, axis_name):
    group = parallel_state.resolve_group(axis_name)
    return tree_map(lambda a: _comm.ring_hop(a, group, direction), x)


def send_forward_recv_forward(output_tensor, *, axis_name=PIPE_AXIS,
                              **_ignored):
    """Rotate activations one stage forward: what I return is what the
    previous stage sent me (reference: fused send_forward + recv_forward)."""
    return _shift(output_tensor, +1, axis_name)


def send_backward_recv_backward(input_tensor_grad, *, axis_name=PIPE_AXIS,
                                **_ignored):
    """Rotate grads one stage backward (reference: fused send_backward +
    recv_backward)."""
    return _shift(input_tensor_grad, -1, axis_name)


# The individual halves: every rank sends and receives in one hop, so
# each half is the whole rotation (the unneeded side is unused).

def send_forward(output_tensor, *, axis_name=PIPE_AXIS, **_ignored):
    return _shift(output_tensor, +1, axis_name)


def recv_forward(payload, *, axis_name=PIPE_AXIS, **_ignored):
    """Receive from the previous stage.  ``payload`` is what this rank
    sends in the same rotation (every rank sends while it receives)."""
    return _shift(payload, +1, axis_name)


def send_backward(input_tensor_grad, *, axis_name=PIPE_AXIS, **_ignored):
    return _shift(input_tensor_grad, -1, axis_name)


def recv_backward(payload, *, axis_name=PIPE_AXIS, **_ignored):
    return _shift(payload, -1, axis_name)


def send_forward_recv_backward(output_tensor, input_tensor_grad=None, *,
                               axis_name=PIPE_AXIS, **_ignored):
    """The 1F1B steady-state pair: activations go forward, then grads
    come back (two hops, one after the other)."""
    fwd = _shift(output_tensor, +1, axis_name)
    if input_tensor_grad is None:
        return fwd
    return fwd, _shift(input_tensor_grad, -1, axis_name)


def send_backward_recv_forward(input_tensor_grad, output_tensor=None, *,
                               axis_name=PIPE_AXIS, **_ignored):
    bwd = _shift(input_tensor_grad, -1, axis_name)
    if output_tensor is None:
        return bwd
    return bwd, _shift(output_tensor, +1, axis_name)
