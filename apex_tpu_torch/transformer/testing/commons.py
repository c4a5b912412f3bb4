"""Shared distributed-test helpers.

Port of ``apex_tpu/transformer/testing/commons.py`` (reference:
``apex/transformer/testing/commons.py`` — ``set_random_seed``,
``initialize_distributed``, ``IdentityLayer``).  The processes and their
group are the caller's (``torch.distributed.init_process_group``, or
:func:`~apex_tpu_torch.transformer.testing.distributed_test_base.spawn_ranks`);
:func:`initialize_distributed` checks that they exist.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from apex_tpu_torch.transformer.tensor_parallel import random as tp_random
from apex_tpu_torch.utils import resolve_device

__all__ = ["set_random_seed", "initialize_distributed", "IdentityLayer"]


def set_random_seed(seed: int, device=None) -> torch.Generator:
    """Seed everything (reference: python, numpy, torch and the CUDA
    tracker): numpy, torch's default generators, and the model-parallel
    RNG tracker's streams on ``device`` (CUDA unless ``"cpu"`` is asked
    for).  Returns a generator on ``device`` seeded with ``seed`` (JAX:
    the root PRNG key)."""
    np.random.seed(seed)
    torch.manual_seed(seed)
    tp_random.model_parallel_seed(seed, device=device)
    gen = torch.Generator(device=resolve_device(device))
    gen.manual_seed(seed)
    return gen


def initialize_distributed(backend: str = "nccl") -> None:
    """Reference parity: the reference initialises NCCL or UCC here.  The
    port's ranks join their group before the test body runs, so this
    asserts an initialised ``torch.distributed`` (``backend`` is
    accepted and not checked: gloo stands in where ranks share a card or
    run on the CPU)."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "initialize_distributed: torch.distributed is not initialised; "
            "every rank calls torch.distributed.init_process_group first")


class IdentityLayer(nn.Module):
    """One learnable tensor returned by ``forward()`` (reference:
    ``IdentityLayer`` — gives tests a differentiable leaf), drawn from
    N(0, init_scale^2) on ``device`` (CUDA unless ``"cpu"``)."""

    def __init__(self, shape, init_scale: float = 1.0, device=None,
                 generator=None):
        super().__init__()
        w = torch.empty(tuple(shape), device=resolve_device(device))
        with torch.no_grad():
            w.normal_(0.0, init_scale, generator=generator)
        self.weight = nn.Parameter(w)

    def forward(self):
        return self.weight
