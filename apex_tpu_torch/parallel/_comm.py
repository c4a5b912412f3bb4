"""The collectives of data and tensor parallelism, over a process group.

One function a collective (:func:`all_reduce`, :func:`reduce_scatter`,
:func:`all_gather`, :func:`broadcast`), each the ``torch.distributed``
call on the caller's tensors, whatever the backend (NCCL, or gloo where
ranks share a card or run on the CPU), and :func:`ring_hop`, the
tensor-parallel ring's point-to-point step.  All of them go through
:func:`_run`, the one place that issues them.

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
           "ring_hop", "hop_staged"]

# ``reduce_scatter_single`` / ``all_gather_single`` are the newer names
# of the same calls
_RS = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
_AG = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def hop_staged(t: torch.Tensor, group) -> bool:
    """Whether :func:`ring_hop` copies ``t`` through the host: gloo on a
    CUDA tensor."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _hop(out, inp, group) -> None:
    """Send ``inp`` to the next rank of ``group`` and receive the
    previous rank's into ``out``."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    send, recv = inp, out
    if hop_staged(inp, group):
        send, recv = inp.cpu(), torch.empty(out.shape, dtype=out.dtype)
    ops = [dist.P2POp(dist.isend, send, dist.get_global_rank(
               group, (r + 1) % n), group),
           dist.P2POp(dist.irecv, recv, dist.get_global_rank(
               group, (r + n - 1) % n), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    if recv is not out:
        out.copy_(recv)


def _run(name: str, out, inp, group, op) -> None:
    """Issue collective ``name``; ``op`` is the reduction, or the
    broadcast's source (a global rank)."""
    if name == "all_reduce":
        dist.all_reduce(out, op=op, group=group)
    elif name == "reduce_scatter":
        _RS(out, inp, op=op, group=group)
    elif name == "all_gather":
        _AG(out, inp, group=group)
    elif name == "broadcast":
        dist.broadcast(out, src=op, group=group)
    else:
        _hop(out, inp, group)


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


def ring_hop(t: torch.Tensor, group) -> torch.Tensor:
    """One hop of the ring, rank r -> r + 1 of ``group``: returns the
    previous rank's ``t`` (a new tensor of ``t``'s shape)."""
    out = torch.empty_like(t, memory_format=torch.contiguous_format)
    _run("ring_hop", out, t.contiguous(), group, None)
    return out
