"""Distributed test bases (reference:
``apex/transformer/testing/distributed_test_base.py`` —
``DistributedTestBase``/``NcclDistributedTestBase``/``UccDistributedTestBase``
extend ``MultiProcessTestCase`` to spawn world_size processes on one
host).

Port of ``apex_tpu/transformer/testing/distributed_test_base.py``.  The
JAX base builds a mesh over the host's devices and runs a test body in
``shard_map``; here :func:`spawn_ranks` spawns ``world_size`` processes
(``torch.multiprocessing``, spawn), each joining a process group on a
``FileStore`` under a temporary directory (so concurrent test workers
share no port), building the topology with
:func:`~apex_tpu_torch.transformer.parallel_state.initialize_model_parallel`
and running the body; every rank's return value comes back to the
caller, rank by rank.  The body and its arguments are pickled: a
module-level function, plain data and CPU tensors.
"""
from __future__ import annotations

import datetime
import os
import tempfile
import unittest
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from apex_tpu_torch.transformer import parallel_state

__all__ = ["DistributedTestBase", "NcclDistributedTestBase",
           "UccDistributedTestBase", "spawn_ranks"]


def _rank_main(rank: int, world_size: int, backend: str, tmp: str,
               sizes: dict, fn: Callable, args: tuple) -> None:
    torch.set_num_threads(1)
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(
        backend, store=dist.FileStore(os.path.join(tmp, "store"),
                                      world_size),
        rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=300))
    try:
        parallel_state.initialize_model_parallel(**sizes)
        out = fn(rank, *args)
    finally:
        parallel_state.destroy_model_parallel()
        dist.destroy_process_group()
    torch.save(out, os.path.join(tmp, f"out.{rank}"))


def spawn_ranks(world_size: int, fn: Callable, *args,
                tensor_model_parallel_size: int = 1,
                pipeline_model_parallel_size: int = 1,
                context_parallel_size: int = 1,
                expert_model_parallel_size: int = 1,
                backend: str = "gloo",
                tmp_dir: Optional[str] = None) -> list:
    """Run ``fn(rank, *args)`` in ``world_size`` spawned processes joined
    over ``backend`` (gloo: the CPU, or ranks sharing a card) with the
    topology built; returns each rank's result, rank by rank.  A rank
    that raises fails the call with its traceback."""
    sizes = dict(tensor_model_parallel_size_=tensor_model_parallel_size,
                 pipeline_model_parallel_size_=pipeline_model_parallel_size,
                 context_parallel_size_=context_parallel_size,
                 expert_model_parallel_size_=expert_model_parallel_size)
    with tempfile.TemporaryDirectory(prefix="apex_ranks_",
                                     dir=tmp_dir) as tmp:
        mp.start_processes(_rank_main, nprocs=world_size,
                           start_method="spawn",
                           args=(world_size, backend, tmp, sizes, fn, args))
        return [torch.load(os.path.join(tmp, f"out.{r}"),
                           weights_only=False) for r in range(world_size)]


class DistributedTestBase(unittest.TestCase):
    """A test case whose bodies run on every rank: :meth:`run_sharded`
    spawns ``world_size`` ranks with this class's topology (reference:
    spawn + ``init_process_group`` per test)."""

    TENSOR_MODEL_PARALLEL_SIZE = 1
    PIPELINE_MODEL_PARALLEL_SIZE = 1
    CONTEXT_PARALLEL_SIZE = 1
    WORLD_SIZE = 2
    BACKEND = "gloo"

    @property
    def world_size(self) -> int:
        return self.WORLD_SIZE

    def run_sharded(self, fn: Callable, *args,
                    in_specs: Optional[Sequence] = None, out_specs=None):
        """``fn(rank, *args)`` on every rank; the ranks' results, rank by
        rank (JAX: the body under ``shard_map``; ``in_specs`` and
        ``out_specs`` have no meaning here and must be ``None``)."""
        if in_specs is not None or out_specs is not None:
            raise ValueError("each rank takes the whole arguments and "
                             "returns its own result: no specs")
        return spawn_ranks(
            self.world_size, fn, *args,
            tensor_model_parallel_size=self.TENSOR_MODEL_PARALLEL_SIZE,
            pipeline_model_parallel_size=self.PIPELINE_MODEL_PARALLEL_SIZE,
            context_parallel_size=self.CONTEXT_PARALLEL_SIZE,
            backend=self.BACKEND)


class NcclDistributedTestBase(DistributedTestBase):
    """The ranks over NCCL (one card a rank)."""
    BACKEND = "nccl"


class UccDistributedTestBase(DistributedTestBase):
    """The ranks over UCC (where ``torch.distributed`` has it:
    ``_ucc_util.HAS_UCC``)."""
    BACKEND = "ucc"
