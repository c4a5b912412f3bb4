"""Process groups for the port's tensor-parallel serving.

Port of ``apex_tpu/transformer/parallel_state.py :: serving_mesh``, the
one piece of ``parallel_state`` that serving needs; the rest of the
module (the training topology) is a later slice (ROADMAP queue 1, item
6).  Where the JAX engine runs one controller over a one-axis ``tp``
mesh, the port runs one process a rank: each rank calls
``torch.distributed.init_process_group`` itself (the caller picks the
backend: NCCL with one card a rank, gloo where ranks share a card or
run on the CPU) and its collectives run on the group this module hands
out.  Nothing here initialises ``torch.distributed`` or picks a
backend.
"""
from __future__ import annotations

import torch.distributed as dist

__all__ = ["serving_group"]


def serving_group(tp: int, group=None):
    """The process group of a ``tp``-wide serving engine, validated.

    With ``group`` (the engine passes its ``group=`` argument, or the
    world group), that group is checked: it must have exactly ``tp``
    ranks and hold this process.  Without it, ``tp`` is checked against
    the world size and the group of the first ``tp`` ranks is returned:
    the world group when they are all of them, else a new group, which
    every rank of the world must ask for (``new_group`` is collective).

    Raises ``ValueError`` for ``tp < 1`` and ``RuntimeError`` when
    ``torch.distributed`` is not initialised, the world is smaller than
    ``tp``, or the group's size is not ``tp``: tensor-parallel serving
    never falls back to one rank."""
    if tp < 1:
        raise ValueError(f"serving tp must be >= 1, got {tp}")
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            f"tensor-parallel serving (tp={tp}) needs torch.distributed: "
            f"every rank calls torch.distributed.init_process_group (and, on "
            f"CUDA, torch.cuda.set_device) before it builds the engine")
    if group is None:
        world = dist.get_world_size()
        if world < tp:
            raise RuntimeError(f"serving tp={tp} needs {tp} ranks, the world "
                               f"has {world}")
        group = dist.group.WORLD if world == tp \
            else dist.new_group(list(range(tp)))
        if world > tp and dist.get_rank() >= tp:
            raise RuntimeError(f"rank {dist.get_rank()} is not among the "
                               f"first {tp} ranks that serve")
    size = dist.get_world_size(group)
    if size != tp:
        raise RuntimeError(f"tp={tp} needs a process group of {tp} ranks, "
                           f"got one of {size}")
    if dist.get_rank(group) < 0:
        raise RuntimeError("this process is not a rank of the serving group")
    return group
