"""Collectives with a different forward and backward, as autograd
Functions over the tensor-parallel process group.

Port of ``apex_tpu/transformer/tensor_parallel/mappings.py`` (reference:
``apex/transformer/tensor_parallel/mappings.py``).  Where the JAX
package pairs a forward collective with a different backward one by
``jax.custom_vjp`` on a bound mesh axis, each op here is a
``torch.autograd.Function`` whose collectives go through
:mod:`apex_tpu_torch.parallel._comm`, one process a rank:

==============================================  =========  ===========
op                                              forward    backward
==============================================  =========  ===========
copy_to_tensor_model_parallel_region            identity   all-reduce
reduce_from_tensor_model_parallel_region        all-reduce identity
scatter_to_tensor_model_parallel_region         split(-1)  all-gather(-1)
gather_from_tensor_model_parallel_region        all-gather(-1)  split(-1)
scatter_to_sequence_parallel_region             split(0)   all-gather(0)
gather_from_sequence_parallel_region            all-gather(0)  reduce-scatter(0)
reduce_scatter_to_sequence_parallel_region      reduce-scatter(0)  all-gather(0)
all_to_all                                      all-to-all all-to-all (inverse)
==============================================  =========  ===========

:func:`all_to_all` is ``jax.lax.all_to_all`` over any axis (``tiled``:
``x`` cut into n blocks along ``split_axis``, block j sent to rank j, the
blocks received concatenated along ``concat_axis`` in rank order), whose
backward is the inverse reshard; Ulysses attention's reshards and the
MoE layer's token exchange over the expert axis both run on it.

``axis_name`` is a mesh-axis name (default ``"tensor"``), resolved by
:func:`~apex_tpu_torch.transformer.parallel_state.resolve_group` (which
raises ``RuntimeError`` without ``initialize_model_parallel``), or a
``ProcessGroup`` taken as it is.  A group of one rank makes every op the
identity (the reference's world_size == 1 early return).  Each rank
must reach the same ops in the same order: a Function's backward
collective runs in the backward pass.

:func:`ring_psum` is the all-reduce as ``n - 1`` point-to-point hops,
rank r -> r + 1, and an all-gather in rank order: JAX's hop order and
landing rank (chunk ``c`` starts on rank ``c + 1`` and lands reduced on
rank ``c``), so at n = 2 each element is the same sum of two terms as
the fused all-reduce's, bit for bit.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

from apex_tpu_torch.parallel import _comm
from apex_tpu_torch.transformer import parallel_state
from apex_tpu_torch.transformer.parallel_state import TENSOR_AXIS

__all__ = [
    "copy_to_tensor_model_parallel_region",
    "reduce_from_tensor_model_parallel_region",
    "scatter_to_tensor_model_parallel_region",
    "gather_from_tensor_model_parallel_region",
    "scatter_to_sequence_parallel_region",
    "gather_from_sequence_parallel_region",
    "reduce_scatter_to_sequence_parallel_region",
    "all_to_all",
    "ring_psum",
    "tp_overlap_chunks",
]


def tp_overlap_chunks(value=None) -> int:
    """Effective TP overlap-chunk count: an explicit per-layer value
    wins; ``None`` reads ``APEX_TPU_TP_OVERLAP_CHUNKS`` (default 1, the
    fused all-reduce).  The layers resolve it once, at construction."""
    if value is not None:
        return int(value)
    return int(os.environ.get("APEX_TPU_TP_OVERLAP_CHUNKS", "1"))


def axis_size(axis_name=TENSOR_AXIS, size=None) -> int:
    """The tensor-parallel size a layer or loss runs at: the group's
    size where ``axis_name`` is a ``ProcessGroup`` or the topology is
    initialised (JAX's ``_tp_world()``), else the explicit ``size``
    (default 1).  An explicit size the group contradicts raises
    ``ValueError``; one above 1 without a group raises ``RuntimeError``
    (``parallel_state.resolve_group``'s)."""
    if isinstance(axis_name, dist.ProcessGroup) or \
            parallel_state.model_parallel_is_initialized():
        n = dist.get_world_size(parallel_state.resolve_group(axis_name))
        if size is not None and int(size) != n:
            raise ValueError(f"tensor_model_parallel_size {size} disagrees "
                             f"with the {axis_name!r} group's {n} ranks")
        return n
    n = 1 if size is None else int(size)
    if n > 1:
        parallel_state.resolve_group(axis_name)   # raises: no topology
    return n


def _ring_geometry(axis_name, n: int, chunks: int, lead: int, knob: str):
    """Validate and derive the chunk schedule shared by :func:`ring_psum`
    and ``layers._RingRowMatmul``: ``chunks`` must be a multiple of the
    axis size and divide the leading (token) dim.  Returns ``(m, gsz,
    csz)``: chunk groups, elements a group, elements a chunk."""
    if chunks % n:
        raise ValueError(
            f"{knob}={chunks} must be a multiple of the "
            f"{axis_name!r} axis size {n}")
    if lead % chunks:
        raise ValueError(
            f"{knob}={chunks} does not divide the leading "
            f"(token/sequence) dim {lead}")
    m = chunks // n
    gsz = lead // m
    return m, gsz, gsz // n


def _ring_reduce(piece, group, n: int, m: int):
    """The ring shared by :func:`ring_psum` and the row-parallel ring
    matmul: within each of the ``m`` chunk groups, chunk ``c`` starts on
    rank ``c + 1`` and lands fully reduced on rank ``c`` after ``n - 1``
    hops (each adds the arriving partial to the local piece), then an
    all-gather puts the groups together in rank order.  ``piece(g, c)``
    is THIS rank's partial of chunk ``c`` of group ``g``."""
    r = dist.get_rank(group)
    outs = []
    for g in range(m):
        idx = (r + n - 1) % n
        acc = piece(g, idx)
        for _ in range(n - 1):
            acc = _comm.ring_hop(acc, group)
            idx = (idx + n - 1) % n
            acc = acc + piece(g, idx)
        full = acc.new_empty((n * acc.shape[0],) + tuple(acc.shape[1:]))
        outs.append(_comm.all_gather(full, acc.contiguous(), group))
    return torch.cat(outs) if m > 1 else outs[0]


def ring_psum(x, axis_name=TENSOR_AXIS, chunks: int = 0):
    """The all-reduce of ``x`` over ``axis_name`` as a ``chunks``-chunk
    ring of point-to-point hops plus an all-gather along dim 0 (a new
    tensor; not differentiable: the mappings carry it).  The bytes are
    the fused all-reduce's; at n = 2 the sums are its bits, beyond within
    a few ulps (the ring's fixed order).  ``chunks`` must be a multiple
    of the axis size and divide ``x.shape[0]``; ``chunks <= 1`` (or one
    rank) is the fused all-reduce.  Does not read
    ``APEX_TPU_TP_OVERLAP_CHUNKS``."""
    group = parallel_state.resolve_group(axis_name)
    n = dist.get_world_size(group)
    chunks = int(chunks)
    x = x.detach()
    if chunks <= 1 or n == 1:
        return _comm.all_reduce(x.clone(memory_format=torch.contiguous_format),
                                group)
    m, gsz, csz = _ring_geometry(axis_name, n, chunks, x.shape[0],
                                 "ring_psum chunks")

    def piece(g, c):
        return x.narrow(0, g * gsz + c * csz, csz)

    return _ring_reduce(piece, group, n, m)


def _split(x, group, dim: int):
    """This rank's chunk along ``dim``."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    chunk = x.shape[dim] // n
    return x.narrow(dim, r * chunk, chunk).contiguous()


def _gather(x, group, dim: int):
    """Every rank's ``x`` concatenated along ``dim`` in rank order."""
    n = dist.get_world_size(group)
    buf = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    _comm.all_gather(buf, x.contiguous(), group)
    return torch.cat(buf.chunk(n, 0), dim=dim) if dim else buf


def _reduce_scatter(x, group, dim: int):
    """This rank's block along ``dim`` of ``x`` summed over the group."""
    n = dist.get_world_size(group)
    xt = x.movedim(dim, 0).contiguous()
    out = xt.new_empty((xt.shape[0] // n,) + tuple(xt.shape[1:]))
    _comm.reduce_scatter(out, xt, group)
    return out.movedim(0, dim)


class _Region(torch.autograd.Function):
    """``fwd(x)`` forward and ``bwd(g)`` backward, two collectives over
    ``group`` (the callables close over it)."""

    @staticmethod
    def forward(ctx, x, fwd, bwd):
        ctx.bwd = bwd
        return fwd(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.bwd(g), None, None


def _region(x, axis_name, fwd, bwd):
    group = parallel_state.resolve_group(axis_name)
    if dist.get_world_size(group) == 1:
        return x
    return _Region.apply(x, lambda t: fwd(t, group), lambda g: bwd(g, group))


# --- copy / reduce ----------------------------------------------------------

def copy_to_tensor_model_parallel_region(x, axis_name=TENSOR_AXIS,
                                         chunks: int = 1):
    """Identity forward / all-reduce backward: the entry of
    ColumnParallelLinear, whose replicated input's grad is the sum of
    the ranks' grads.  ``chunks > 1`` takes the backward's all-reduce
    through :func:`ring_psum`."""
    return _region(x, axis_name, lambda t, grp: t.view_as(t),
                   lambda g, grp: ring_psum(g, grp, chunks))


def reduce_from_tensor_model_parallel_region(x, axis_name=TENSOR_AXIS,
                                             chunks: int = 1):
    """All-reduce forward / identity backward: the exit of
    RowParallelLinear, whose partial products are summed.  ``chunks >
    1`` takes the all-reduce through :func:`ring_psum` (an explicit
    opt-in; the env knob is not read here)."""
    return _region(x, axis_name, lambda t, grp: ring_psum(t, grp, chunks),
                   lambda g, grp: g)


# --- scatter / gather on the hidden (last) dim ------------------------------

def scatter_to_tensor_model_parallel_region(x, axis_name=TENSOR_AXIS):
    """Split the last dim forward / all-gather it backward."""
    return _region(x, axis_name, lambda t, grp: _split(t, grp, t.dim() - 1),
                   lambda g, grp: _gather(g, grp, g.dim() - 1))


def gather_from_tensor_model_parallel_region(x, axis_name=TENSOR_AXIS):
    """All-gather the last dim forward / split it backward."""
    return _region(x, axis_name, lambda t, grp: _gather(t, grp, t.dim() - 1),
                   lambda g, grp: _split(g, grp, g.dim() - 1))


# --- sequence-parallel trio (dim 0 = sequence) ------------------------------

def scatter_to_sequence_parallel_region(x, axis_name=TENSOR_AXIS):
    """Split dim 0 forward / all-gather it backward."""
    return _region(x, axis_name, lambda t, grp: _split(t, grp, 0),
                   lambda g, grp: _gather(g, grp, 0))


def gather_from_sequence_parallel_region(
        x, axis_name=TENSOR_AXIS, tensor_parallel_output_grad: bool = True):
    """All-gather dim 0 forward / reduce-scatter it backward (with
    ``tensor_parallel_output_grad=False``: split it)."""
    if tensor_parallel_output_grad:
        bwd = lambda g, grp: _reduce_scatter(g, grp, 0)    # noqa: E731
    else:
        bwd = lambda g, grp: _split(g, grp, 0)             # noqa: E731
    return _region(x, axis_name, lambda t, grp: _gather(t, grp, 0), bwd)


def reduce_scatter_to_sequence_parallel_region(x, axis_name=TENSOR_AXIS):
    """Reduce-scatter dim 0 forward / all-gather it backward."""
    return _region(x, axis_name, lambda t, grp: _reduce_scatter(t, grp, 0),
                   lambda g, grp: _gather(g, grp, 0))


# --- all-to-all ---------------------------------------------------------------

def _reshard(x, group, split_axis: int, concat_axis: int):
    """JAX's tiled ``all_to_all``: ``x`` cut into n blocks along
    ``split_axis``, block j sent to rank j, the blocks received
    concatenated along ``concat_axis`` in rank order."""
    n = dist.get_world_size(group)
    xs = x.movedim(split_axis, 0)
    xs = xs.reshape(n, xs.shape[0] // n, *xs.shape[1:]).contiguous()
    out = _comm.all_to_all(torch.empty_like(xs), xs, group)
    out = out.movedim(1, split_axis + 1).movedim(0, concat_axis)
    shape = list(x.shape)
    shape[split_axis] //= n
    shape[concat_axis] *= n
    return out.reshape(shape)


class _AllToAll(torch.autograd.Function):
    """:func:`_reshard` forward, the inverse reshard backward."""

    @staticmethod
    def forward(ctx, x, group, split_axis, concat_axis):
        ctx.group, ctx.axes = group, (split_axis, concat_axis)
        return _reshard(x, group, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        split_axis, concat_axis = ctx.axes
        return (_reshard(g.contiguous(), ctx.group, concat_axis, split_axis),
                None, None, None)


def all_to_all(x, axis_name, split_axis: int = 0, concat_axis: int = 0):
    """``jax.lax.all_to_all(x, axis_name, split_axis, concat_axis,
    tiled=True)``, differentiable (the backward is the inverse reshard):
    ``x.shape[split_axis]`` must divide by the group's size n; the
    result's ``split_axis`` is n times shorter and its ``concat_axis`` n
    times longer.  At ``split_axis == concat_axis`` the shape is kept (the
    untiled all-to-all with that dim of size n, as the MoE layer calls
    it).  A group of one rank: ``x``."""
    group = parallel_state.resolve_group(axis_name)
    n = dist.get_world_size(group)
    if n == 1:
        return x
    if x.shape[split_axis] % n:
        raise ValueError(f"all_to_all: dim {split_axis} of "
                         f"{tuple(x.shape)} does not split into {n} blocks")
    return _AllToAll.apply(x, group, split_axis, concat_axis)
