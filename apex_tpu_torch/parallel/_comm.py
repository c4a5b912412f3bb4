"""The collectives of data, tensor and context parallelism, over a
process group.

One function a collective (:func:`all_reduce`, :func:`reduce_scatter`,
:func:`all_gather`, :func:`broadcast`, :func:`all_to_all`), each the
``torch.distributed`` call on the caller's tensors, whatever the backend
(NCCL, or gloo where ranks share a card or run on the CPU), and
:func:`ring_hop`, the point-to-point step of the tensor-parallel ring,
of the pipeline's ring and of ring attention's, in either direction.
All of them go through :func:`_run`, the one place that issues them.
The all-to-all is ``all_to_all_single`` on equal splits (Ulysses
attention's reshards); gloo copies its CUDA tensors through the host
inside the call, as it does its other collectives'.

gloo copies its collectives' CUDA tensors through the host inside the
call, but its ``send`` and ``recv`` have no CUDA path: they would take
the device pointer for host memory.  So a ring hop over gloo on CUDA
tensors copies through host tensors here (:func:`hop_staged`); NCCL's
hop, and gloo's on the CPU, send the caller's tensors.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["all_reduce", "reduce_scatter", "all_gather", "broadcast",
           "all_to_all", "ring_hop", "hop_staged"]

# ``reduce_scatter_single`` / ``all_gather_single`` are the newer names
# of the same calls
_RS = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
_AG = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def hop_staged(t: torch.Tensor, group) -> bool:
    """Whether :func:`ring_hop` copies ``t`` through the host: gloo on a
    CUDA tensor."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _hop(out, inp, group, step: int) -> None:
    """Send ``inp`` to rank r + ``step`` of ``group`` and receive rank
    r - ``step``'s into ``out`` (ranks modulo the group's size; a group
    of one copies ``inp``).  The two directions carry tags of their own:
    at two ranks, r + 1 and r - 1 are the same peer."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    if n == 1:
        out.copy_(inp)
        return
    send, recv = inp, out
    if hop_staged(inp, group):
        send, recv = inp.cpu(), torch.empty(out.shape, dtype=out.dtype)
    tag = 0 if step > 0 else 1
    ops = [dist.P2POp(dist.isend, send, dist.get_global_rank(
               group, (r + step) % n), group, tag),
           dist.P2POp(dist.irecv, recv, dist.get_global_rank(
               group, (r - step) % n), group, tag)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    if recv is not out:
        out.copy_(recv)


def _run(name: str, out, inp, group, op) -> None:
    """Issue collective ``name``; ``op`` is the reduction, the
    broadcast's source (a global rank), or the ring hop's step (+1 or
    -1); unused by the all-gather and the all-to-all."""
    if name == "all_reduce":
        dist.all_reduce(out, op=op, group=group)
    elif name == "reduce_scatter":
        _RS(out, inp, op=op, group=group)
    elif name == "all_gather":
        _AG(out, inp, group=group)
    elif name == "broadcast":
        dist.broadcast(out, src=op, group=group)
    elif name == "all_to_all":
        dist.all_to_all_single(out, inp, group=group)
    else:
        _hop(out, inp, group, op)


def all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` reduced over ``group`` in place (``op``: SUM, MAX, ...)."""
    _run("all_reduce", t, None, group, op)
    return t


def reduce_scatter(out: torch.Tensor, inp: torch.Tensor, group,
                   op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``out`` <- rank r's ``1/n`` block of ``inp`` reduced over ``group``
    (``inp`` is ``n * len(out)`` elements, blocks in rank order)."""
    if inp.numel() != out.numel() * dist.get_world_size(group):
        raise ValueError(f"reduce_scatter: {inp.numel()} elements do not "
                         f"split into {dist.get_world_size(group)} blocks of "
                         f"{out.numel()}")
    _run("reduce_scatter", out, inp, group, op)
    return out


def all_gather(out: torch.Tensor, inp: torch.Tensor, group) -> torch.Tensor:
    """``out`` <- every rank's ``inp`` concatenated in rank order."""
    if out.numel() != inp.numel() * dist.get_world_size(group):
        raise ValueError(f"all_gather: {out.numel()} elements are not "
                         f"{dist.get_world_size(group)} blocks of "
                         f"{inp.numel()}")
    _run("all_gather", out, inp, group, None)
    return out


def broadcast(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """``t`` <- global rank ``src``'s ``t``, in place on every rank of
    ``group``."""
    _run("broadcast", t, None, group, src)
    return t


def all_to_all(out: torch.Tensor, inp: torch.Tensor, group) -> torch.Tensor:
    """``out`` <- block r of every rank's ``inp``, in rank order: ``inp``
    and ``out`` are ``n`` equal blocks along dim 0 (``n`` the group's
    size), rank r's block j of ``inp`` landing as block r of rank j's
    ``out``.  Both contiguous, of one shape."""
    n = dist.get_world_size(group)
    if out.shape != inp.shape or inp.shape[0] % n:
        raise ValueError(f"all_to_all: {tuple(inp.shape)} into "
                         f"{tuple(out.shape)} is not {n} equal blocks of "
                         f"one shape along dim 0")
    _run("all_to_all", out, inp, group, None)
    return out


def ring_hop(t: torch.Tensor, group, step: int = 1) -> torch.Tensor:
    """One hop of the ring, rank r -> r + ``step`` of ``group`` (``step``
    +1: forward, -1: backward): returns rank r - ``step``'s ``t`` (a new
    tensor of ``t``'s shape).  Over gloo on CUDA the hop is staged
    through host tensors (:func:`hop_staged`)."""
    if step not in (1, -1):
        raise ValueError(f"a ring hop steps +1 or -1, not {step}")
    out = torch.empty_like(t, memory_format=torch.contiguous_format)
    _run("ring_hop", out, t.contiguous(), group, step)
    return out
