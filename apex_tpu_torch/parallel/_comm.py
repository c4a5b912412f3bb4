"""The collectives of data parallelism and ZeRO, over a process group.

One function a collective (:func:`all_reduce`, :func:`reduce_scatter`,
:func:`all_gather`), each the ``torch.distributed`` call on the
caller's tensors, whatever the backend (NCCL, or gloo where ranks share
a card or run on the CPU).  All three go through :func:`_run`, the one
place that issues them.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["all_reduce", "reduce_scatter", "all_gather"]

# ``reduce_scatter_single`` / ``all_gather_single`` are the newer names
# of the same calls
_RS = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
_AG = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def _run(name: str, out, inp, group, op) -> None:
    if name == "all_reduce":
        dist.all_reduce(out, op=op, group=group)
    elif name == "reduce_scatter":
        _RS(out, inp, op=op, group=group)
    else:
        _AG(out, inp, group=group)


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
